"""SQL abstract syntax tree.

The reference exposes its engine through DuckDB's SQL planner (SURVEY.md §1
L4); this framework carries its own SQL surface. The AST covers the dialect
exercised by the reference's sqllogictests plus the relational constructs the
BASELINE.json benchmark configs need (joins, group-by, order-by).
"""

from __future__ import annotations

from dataclasses import dataclass, field


# --- expressions -----------------------------------------------------------

@dataclass
class Expr:
    pass


@dataclass
class Literal(Expr):
    value: object  # python value; None = NULL
    type_name: str | None = None  # 'INTEGER' | 'DOUBLE' | 'VARCHAR' | ...


@dataclass
class ColumnRef(Expr):
    name: str
    table: str | None = None


@dataclass
class Parameter(Expr):
    """Positional prepared-statement parameter ('?'), bound at execute."""
    index: int = 0


@dataclass
class Star(Expr):
    table: str | None = None


@dataclass
class FuncCall(Expr):
    name: str
    args: list = field(default_factory=list)
    distinct: bool = False
    is_star: bool = False  # count(*)


@dataclass
class WindowFunc(Expr):
    name: str
    args: list = field(default_factory=list)
    partition_by: list = field(default_factory=list)
    order_by: list = field(default_factory=list)  # OrderItem
    # frame: (unit, start, end); unit "rows"|"range"; bounds are
    # "unbounded_preceding"|"unbounded_following"|"current" or
    # ("preceding"|"following", k). None -> standard default (RANGE
    # UNBOUNDED PRECEDING..CURRENT ROW when ORDER BY present, else the
    # whole partition).
    frame: tuple | None = None


@dataclass
class Cast(Expr):
    operand: Expr
    type_name: str
    width: int = 0
    scale: int = 0


@dataclass
class Unary(Expr):
    op: str  # '-', '+', 'NOT'
    operand: Expr


@dataclass
class Binary(Expr):
    op: str  # '+','-','*','/','%','=','<>','<','<=','>','>=','AND','OR','||'
    left: Expr
    right: Expr


@dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    operand: Expr
    items: list = field(default_factory=list)
    negated: bool = False


@dataclass
class InSubquery(Expr):
    operand: Expr
    query: object = None  # A.Select
    negated: bool = False


@dataclass
class Exists(Expr):
    query: object = None  # A.Select


@dataclass
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class Like(Expr):
    operand: Expr
    pattern: Expr
    negated: bool = False


@dataclass
class Case(Expr):
    operand: Expr | None
    whens: list = field(default_factory=list)  # [(cond, result)]
    else_: Expr | None = None


@dataclass
class ListExpr(Expr):
    items: list = field(default_factory=list)


@dataclass
class PositionIn(Expr):
    """position(needle IN haystack) — DuckDB/standard SQL form used by the
    reference tests (test_core_functionality.test)."""

    needle: Expr
    haystack: Expr


# --- statements ------------------------------------------------------------

@dataclass
class Statement:
    pass


@dataclass
class SelectItem:
    expr: Expr
    alias: str | None = None


@dataclass
class TableRef:
    pass


@dataclass
class BaseTable(TableRef):
    name: str
    alias: str | None = None


@dataclass
class SubqueryRef(TableRef):
    query: "Select"
    alias: str | None = None
    column_aliases: list | None = None


@dataclass
class TableFunction(TableRef):
    name: str
    args: list = field(default_factory=list)
    alias: str | None = None
    column_aliases: list | None = None


@dataclass
class Join(TableRef):
    left: TableRef
    right: TableRef
    kind: str = "INNER"  # INNER | LEFT | RIGHT | FULL | CROSS
    on: Expr | None = None
    using: list | None = None


@dataclass
class OrderItem:
    expr: Expr
    ascending: bool = True
    nulls_first: bool | None = None


@dataclass
class Select(Statement):
    items: list = field(default_factory=list)  # SelectItem
    from_: TableRef | None = None
    where: Expr | None = None
    group_by: list = field(default_factory=list)
    # ROLLUP/CUBE/GROUPING SETS: list of key-expr lists; executed as a
    # UNION ALL of per-set grouped selects (group_by holds the key union)
    group_sets: list | None = None
    having: Expr | None = None
    order_by: list = field(default_factory=list)  # OrderItem
    limit: int | None = None
    offset: int | None = None
    distinct: bool = False


@dataclass
class SetOp(Statement):
    """UNION / UNION ALL / EXCEPT / INTERSECT between two selects."""

    left: Statement  # Select or SetOp
    right: Statement
    kind: str = "UNION"  # UNION | EXCEPT | INTERSECT
    all: bool = False
    order_by: list = field(default_factory=list)
    limit: int | None = None


@dataclass
class ValuesRef(TableRef):
    rows: list = field(default_factory=list)  # list[list[Expr]]
    alias: str | None = None
    column_aliases: list | None = None


@dataclass
class CreateTableAs(Statement):
    name: str
    query: Select
    or_replace: bool = False


@dataclass
class ColumnDef:
    name: str
    type_name: str
    width: int = 0
    scale: int = 0


@dataclass
class CreateTable(Statement):
    name: str
    columns: list = field(default_factory=list)
    or_replace: bool = False


@dataclass
class CreateMacro(Statement):
    """CREATE [OR REPLACE] MACRO name(params...) AS expr — scalar macro,
    expanded by argument substitution at evaluation time (DuckDB semantics;
    the reference's test_advanced_features.test uses zero-arg macros)."""
    name: str = ""
    params: list = field(default_factory=list)
    expr: Expr | None = None
    or_replace: bool = False


@dataclass
class Insert(Statement):
    table: str
    columns: list | None = None
    rows: list | None = None  # list of list[Expr]
    query: Select | None = None


@dataclass
class DropTable(Statement):
    name: str
    if_exists: bool = False


@dataclass
class ExportDatabase(Statement):
    path: str = ""


@dataclass
class ImportDatabase(Statement):
    path: str = ""


@dataclass
class With(Statement):
    """WITH name [(cols)] AS (query), ... <query> — non-recursive CTEs."""
    ctes: list = field(default_factory=list)  # [(name, col_aliases|None, query)]
    query: Statement = None


@dataclass
class Delete(Statement):
    table: str = ""
    where: Expr | None = None


@dataclass
class Update(Statement):
    table: str = ""
    assignments: list = field(default_factory=list)  # [(col_name, Expr)]
    where: Expr | None = None


@dataclass
class Explain(Statement):
    query: Statement = None
    analyze: bool = False  # EXPLAIN ANALYZE: run the query, report actuals


@dataclass
class CopyTo(Statement):
    source: object = None  # table name (str) or Select/SetOp
    path: str = ""
    format: str = "csv"  # 'csv' | 'columnar'


@dataclass
class Pragma(Statement):
    name: str
    value: object | None = None


@dataclass
class Load(Statement):
    path: str


@dataclass
class SetStmt(Statement):
    name: str
    value: object


def contains_node(e, pred) -> bool:
    """True when ``pred`` holds for ``e`` or any descendant expression.
    One shared dataclass walk (round-5 review: window_fusion and
    device_plan each grew a private near-copy)."""
    import dataclasses

    if pred(e):
        return True
    if not dataclasses.is_dataclass(e):
        return False
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, (Expr, Select)) and contains_node(v, pred):
            return True
        if isinstance(v, list):
            for x in v:
                if isinstance(x, (Expr, Select)) and contains_node(x, pred):
                    return True
                if isinstance(x, OrderItem) and contains_node(x.expr, pred):
                    return True
    return False
