"""Recursive-descent SQL parser for the engine's dialect.

Covers the statements and expression forms used by the reference's SQL test
suite (upstream test/sql/*.test — SURVEY.md §4) and the BASELINE.json
benchmark queries: SELECT (joins, group/order/limit), CREATE [OR REPLACE]
TABLE [AS], INSERT, DROP, PRAGMA, LOAD, casts (CAST(x AS T) and x::T),
position(x IN y), list literals, CASE, LIKE/IN/BETWEEN.
"""

from __future__ import annotations

from ..errors import SqlError
from . import ast as A
from .lexer import Token, tokenize

_KEYWORDS_STOP_ALIAS = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "JOIN",
    "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "ON", "USING", "AS", "AND",
    "OR", "NOT", "UNION", "EXCEPT", "INTERSECT", "SELECT", "SET", "VALUES",
}


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0
        self._param_count = 0  # positional '?' parameters seen so far

    # -- token helpers ----------------------------------------------------

    def peek(self, offset: int = 0) -> Token:
        return self.tokens[min(self.i + offset, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "EOF":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "IDENT" and t.upper in kws

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SqlError(f"Parser Error: expected {kw}, got '{self.peek().text}'")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.text in ops

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlError(f"Parser Error: expected '{op}', got '{self.peek().text}'")

    def expect_ident(self) -> str:
        t = self.peek()
        if t.kind != "IDENT":
            raise SqlError(f"Parser Error: expected identifier, got '{t.text}'")
        self.next()
        return t.text

    # -- statements -------------------------------------------------------

    def parse_statements(self) -> list:
        stmts = []
        while self.peek().kind != "EOF":
            stmts.append(self.parse_statement())
            while self.accept_op(";"):
                pass
        return stmts

    def parse_statement(self) -> A.Statement:
        if self.at_kw("EXPLAIN"):
            self.next()
            analyze = bool(self.accept_kw("ANALYZE"))
            if self.at_kw("WITH"):
                return A.Explain(self.parse_statement(), analyze)
            return A.Explain(self.parse_query(), analyze)
        if self.at_kw("SELECT"):
            return self.parse_query()
        if self.at_kw("CREATE"):
            return self._parse_create()
        if self.at_kw("INSERT"):
            return self._parse_insert()
        if self.at_kw("DROP"):
            return self._parse_drop()
        if self.at_kw("EXPORT") or self.at_kw("IMPORT"):
            kind = self.next().upper
            self.expect_kw("DATABASE")
            t = self.next()
            if t.kind != "STRING":
                raise SqlError(f"Parser Error: {kind} DATABASE expects a path string")
            return (A.ExportDatabase(t.text) if kind == "EXPORT"
                    else A.ImportDatabase(t.text))
        if self.at_kw("WITH"):
            self.next()
            ctes = []
            while True:
                name = self.expect_ident()
                col_aliases = None
                if self.at_op("("):
                    self.expect_op("(")
                    col_aliases = []
                    while True:
                        col_aliases.append(self.expect_ident())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                self.expect_kw("AS")
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                ctes.append((name, col_aliases, q))
                if not self.accept_op(","):
                    break
            return A.With(ctes, self.parse_query())
        if self.at_kw("DELETE"):
            self.next()
            self.expect_kw("FROM")
            name = self.expect_ident()
            where = None
            if self.accept_kw("WHERE"):
                where = self.parse_expr()
            return A.Delete(name, where)
        if self.at_kw("UPDATE"):
            self.next()
            name = self.expect_ident()
            self.expect_kw("SET")
            assignments = []
            while True:
                col = self.expect_ident()
                self.expect_op("=")
                assignments.append((col, self.parse_expr()))
                if not self.accept_op(","):
                    break
            where = None
            if self.accept_kw("WHERE"):
                where = self.parse_expr()
            return A.Update(name, assignments, where)
        if self.at_kw("COPY"):
            self.next()
            if self.accept_op("("):
                source = self.parse_query()
                self.expect_op(")")
            else:
                source = self.expect_ident()
            self.expect_kw("TO")
            t = self.next()
            if t.kind != "STRING":
                raise SqlError("Parser Error: COPY ... TO expects a path string")
            fmt = "csv"
            if self.accept_op("("):
                if not self.accept_kw("FORMAT"):
                    self.expect_ident()  # tolerate other option names
                fmt = self.next().text.lower()
                self.expect_op(")")
            return A.CopyTo(source, t.text, fmt)
        if self.at_kw("PRAGMA"):
            self.next()
            name = self.expect_ident()
            value = None
            if self.accept_op("="):
                value = self.next().text
            return A.Pragma(name, value)
        if self.at_kw("LOAD"):
            self.next()
            t = self.next()
            return A.Load(t.text)
        if self.at_kw("SET"):
            self.next()
            name = self.expect_ident()
            self.expect_op("=")
            return A.SetStmt(name, self.next().text)
        raise SqlError(f"Parser Error: unexpected statement start '{self.peek().text}'")

    def _parse_create(self) -> A.Statement:
        self.expect_kw("CREATE")
        or_replace = False
        if self.accept_kw("OR"):
            self.expect_kw("REPLACE")
            or_replace = True
        if self.accept_kw("MACRO"):
            name = self.expect_ident()
            self.expect_op("(")
            params = []
            if not self.at_op(")"):
                while True:
                    params.append(self.expect_ident())
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            self.expect_kw("AS")
            return A.CreateMacro(name, params, self.parse_expr(), or_replace)
        self.expect_kw("TABLE")
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
        name = self.expect_ident()
        if self.accept_kw("AS"):
            return A.CreateTableAs(name, self.parse_query(), or_replace)
        self.expect_op("(")
        cols = []
        while True:
            cname = self.expect_ident()
            tname, width, scale = self._parse_type_name()
            cols.append(A.ColumnDef(cname, tname, width, scale))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return A.CreateTable(name, cols, or_replace)

    def _parse_type_name(self) -> tuple:
        tname = self.expect_ident().upper()
        width = scale = 0
        if self.accept_op("("):
            width = int(self.next().text)
            if self.accept_op(","):
                scale = int(self.next().text)
            self.expect_op(")")
        return tname, width, scale

    def _parse_insert(self) -> A.Insert:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        name = self.expect_ident()
        columns = None
        if self.at_op("(") :
            self.expect_op("(")
            columns = []
            while True:
                columns.append(self.expect_ident())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        if self.accept_kw("VALUES"):
            rows = []
            while True:
                self.expect_op("(")
                row = []
                while True:
                    row.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            return A.Insert(name, columns, rows=rows)
        return A.Insert(name, columns, query=self.parse_select())

    def _parse_drop(self) -> A.DropTable:
        self.expect_kw("DROP")
        self.expect_kw("TABLE")
        if_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            if_exists = True
        return A.DropTable(self.expect_ident(), if_exists)

    # -- SELECT -----------------------------------------------------------

    def parse_query(self):
        """SELECT optionally chained with UNION [ALL] / EXCEPT / INTERSECT."""
        left = self.parse_select()
        while self.at_kw("UNION", "EXCEPT", "INTERSECT"):
            kind = self.next().upper
            all_ = self.accept_kw("ALL")
            right = self.parse_select()
            # ORDER BY / LIMIT written after the final select bind to the
            # whole compound
            order_by, limit = right.order_by, right.limit
            right.order_by, right.limit = [], None
            left = A.SetOp(left, right, kind, all_, order_by, limit)
        return left

    def parse_select(self) -> A.Select:
        self.expect_kw("SELECT")
        sel = A.Select()
        sel.distinct = self.accept_kw("DISTINCT")
        while True:
            sel.items.append(self._parse_select_item())
            if not self.accept_op(","):
                break
        if self.accept_kw("FROM"):
            sel.from_ = self._parse_table_ref()
        if self.accept_kw("WHERE"):
            sel.where = self.parse_expr()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            kw = self.peek().upper if self.peek().kind == "IDENT" else ""
            if kw in ("ROLLUP", "CUBE"):
                self.next()
                self.expect_op("(")
                keys = []
                while True:
                    keys.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                if kw == "ROLLUP":
                    sel.group_sets = [keys[:i] for i in
                                      range(len(keys), -1, -1)]
                else:  # CUBE: every subset, original key order inside
                    import itertools as _it

                    sel.group_sets = [list(c) for r in
                                      range(len(keys), -1, -1)
                                      for c in _it.combinations(keys, r)]
                sel.group_by = list(keys)
            elif kw == "GROUPING" and self.peek(1).upper == "SETS":
                self.next()
                self.next()
                self.expect_op("(")
                sets = []
                while True:
                    self.expect_op("(")
                    one = []
                    if not self.at_op(")"):
                        while True:
                            one.append(self.parse_expr())
                            if not self.accept_op(","):
                                break
                    self.expect_op(")")
                    sets.append(one)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                sel.group_sets = sets
                seen = []
                for one in sets:
                    for e in one:
                        if e not in seen:
                            seen.append(e)
                sel.group_by = seen
            else:
                while True:
                    sel.group_by.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
        if self.accept_kw("HAVING"):
            sel.having = self.parse_expr()
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.parse_expr()
                asc = True
                if self.accept_kw("DESC"):
                    asc = False
                elif self.accept_kw("ASC"):
                    pass
                nulls_first = None
                if self.accept_kw("NULLS"):
                    nulls_first = self.accept_kw("FIRST")
                    if not nulls_first:
                        self.expect_kw("LAST")
                sel.order_by.append(A.OrderItem(e, asc, nulls_first))
                if not self.accept_op(","):
                    break
        if self.accept_kw("LIMIT"):
            sel.limit = int(self.next().text)
        if self.accept_kw("OFFSET"):
            sel.offset = int(self.next().text)
        return sel

    def _parse_select_item(self) -> A.SelectItem:
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.expect_ident()
        elif self.peek().kind == "IDENT" and self.peek().upper not in _KEYWORDS_STOP_ALIAS:
            alias = self.next().text
        return A.SelectItem(expr, alias)

    def _parse_table_ref(self) -> A.TableRef:
        left = self._parse_table_primary()
        while True:
            if self.accept_op(","):
                right = self._parse_table_primary()
                left = A.Join(left, right, "CROSS")
                continue
            kind = None
            if self.accept_kw("CROSS"):
                self.expect_kw("JOIN")
                left = A.Join(left, self._parse_table_primary(), "CROSS")
                continue
            if self.at_kw("INNER", "LEFT", "RIGHT", "FULL", "JOIN"):
                if self.accept_kw("INNER"):
                    kind = "INNER"
                elif self.accept_kw("LEFT"):
                    self.accept_kw("OUTER")
                    kind = "LEFT"
                elif self.accept_kw("RIGHT"):
                    self.accept_kw("OUTER")
                    kind = "RIGHT"
                elif self.accept_kw("FULL"):
                    self.accept_kw("OUTER")
                    kind = "FULL"
                else:
                    kind = "INNER"
                self.expect_kw("JOIN")
                right = self._parse_table_primary()
                on = None
                using = None
                if self.accept_kw("ON"):
                    on = self.parse_expr()
                elif self.accept_kw("USING"):
                    self.expect_op("(")
                    using = []
                    while True:
                        using.append(self.expect_ident())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                left = A.Join(left, right, kind, on, using)
                continue
            break
        return left

    def _parse_table_primary(self) -> A.TableRef:
        if self.accept_op("("):
            if self.accept_kw("VALUES"):
                rows = []
                while True:
                    self.expect_op("(")
                    row = []
                    while True:
                        row.append(self.parse_expr())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                    rows.append(row)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                alias, col_aliases = self._maybe_alias_with_columns()
                return A.ValuesRef(rows, alias, col_aliases)
            q = self.parse_query()
            self.expect_op(")")
            alias, col_aliases = self._maybe_alias_with_columns()
            return A.SubqueryRef(q, alias, col_aliases)
        name = self.expect_ident()
        if self.at_op("("):
            self.expect_op("(")
            args = []
            if not self.at_op(")"):
                while True:
                    args.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            alias, col_aliases = self._maybe_alias_with_columns()
            return A.TableFunction(name, args, alias, col_aliases)
        alias, _ = self._maybe_alias_with_columns()
        return A.BaseTable(name, alias)

    def _maybe_alias(self) -> str | None:
        if self.accept_kw("AS"):
            return self.expect_ident()
        if self.peek().kind == "IDENT" and self.peek().upper not in _KEYWORDS_STOP_ALIAS:
            return self.next().text
        return None

    def _maybe_alias_with_columns(self) -> tuple:
        """alias [(col1, col2, ...)] — e.g. ``range(10) r(x)``."""
        alias = self._maybe_alias()
        col_aliases = None
        if alias is not None and self.at_op("("):
            self.expect_op("(")
            col_aliases = []
            while True:
                col_aliases.append(self.expect_ident())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return alias, col_aliases

    # -- expressions (precedence climbing) --------------------------------

    def parse_expr(self) -> A.Expr:
        return self._parse_or()

    def _parse_or(self) -> A.Expr:
        left = self._parse_and()
        while self.accept_kw("OR"):
            left = A.Binary("OR", left, self._parse_and())
        return left

    def _parse_and(self) -> A.Expr:
        left = self._parse_not()
        while self.accept_kw("AND"):
            left = A.Binary("AND", left, self._parse_not())
        return left

    def _parse_not(self) -> A.Expr:
        if self.accept_kw("NOT"):
            return A.Unary("NOT", self._parse_not())
        return self._parse_comparison()

    def _parse_comparison(self) -> A.Expr:
        left = self._parse_concat()
        while True:
            if self.at_op("=", "==", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().text
                if op == "==":
                    op = "="
                if op == "!=":
                    op = "<>"
                left = A.Binary(op, left, self._parse_concat())
                continue
            if self.at_kw("IS"):
                self.next()
                negated = self.accept_kw("NOT")
                self.expect_kw("NULL")
                left = A.IsNull(left, negated)
                continue
            if self.at_kw("NOT") and self.peek(1).upper in ("IN", "BETWEEN", "LIKE"):
                self.next()
                left = self._parse_in_between_like(left, negated=True)
                continue
            if self.at_kw("IN", "BETWEEN", "LIKE"):
                left = self._parse_in_between_like(left, negated=False)
                continue
            break
        return left

    def _parse_in_between_like(self, left: A.Expr, negated: bool) -> A.Expr:
        if self.accept_kw("IN"):
            self.expect_op("(")
            if self.at_kw("SELECT"):
                q = self.parse_select()
                self.expect_op(")")
                return A.InSubquery(left, q, negated)
            items = []
            while True:
                items.append(self.parse_expr())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return A.InList(left, items, negated)
        if self.accept_kw("BETWEEN"):
            low = self._parse_concat()
            self.expect_kw("AND")
            high = self._parse_concat()
            return A.Between(left, low, high, negated)
        self.expect_kw("LIKE")
        return A.Like(left, self._parse_concat(), negated)

    def _parse_concat(self) -> A.Expr:
        left = self._parse_additive()
        while self.accept_op("||"):
            left = A.Binary("||", left, self._parse_additive())
        return left

    def _parse_additive(self) -> A.Expr:
        left = self._parse_multiplicative()
        while self.at_op("+", "-"):
            op = self.next().text
            left = A.Binary(op, left, self._parse_multiplicative())
        return left

    def _parse_multiplicative(self) -> A.Expr:
        left = self._parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().text
            left = A.Binary(op, left, self._parse_unary())
        return left

    def _parse_unary(self) -> A.Expr:
        if self.accept_op("-"):
            return A.Unary("-", self._parse_unary())
        if self.accept_op("+"):
            return self._parse_unary()
        return self._parse_postfix()

    def _parse_postfix(self) -> A.Expr:
        e = self._parse_primary()
        while True:
            if self.accept_op("::"):
                tname, width, scale = self._parse_type_name()
                e = A.Cast(e, tname, width, scale)
                continue
            if self.at_op("["):
                self.expect_op("[")
                idx = self.parse_expr()
                self.expect_op("]")
                e = A.FuncCall("list_extract", [e, idx])
                continue
            break
        return e

    def _parse_primary(self) -> A.Expr:
        t = self.peek()
        if t.kind == "OP" and t.text == "?":
            # positional prepared-statement parameter, bound at execute time
            self.next()
            idx = self._param_count
            self._param_count += 1
            return A.Parameter(idx)
        if t.kind == "NUMBER":
            self.next()
            if "." in t.text or "e" in t.text or "E" in t.text:
                return A.Literal(float(t.text), "DOUBLE")
            v = int(t.text)
            return A.Literal(v, "INTEGER" if -(2**31) <= v < 2**31 else "BIGINT")
        if t.kind == "STRING":
            self.next()
            return A.Literal(t.text, "VARCHAR")
        if t.kind == "OP" and t.text == "(":
            self.next()
            if self.at_kw("SELECT"):
                q = self.parse_select()
                self.expect_op(")")
                return A.FuncCall("__scalar_subquery__", [q])
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "OP" and t.text == "[":
            self.next()
            items = []
            if not self.at_op("]"):
                while True:
                    items.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
            self.expect_op("]")
            return A.ListExpr(items)
        if t.kind == "OP" and t.text == "*":
            self.next()
            return A.Star()
        if t.kind != "IDENT":
            raise SqlError(f"Parser Error: unexpected token '{t.text}'")
        upper = t.upper
        if upper == "NULL":
            self.next()
            return A.Literal(None, None)
        if upper == "TRUE":
            self.next()
            return A.Literal(True, "BOOLEAN")
        if upper == "FALSE":
            self.next()
            return A.Literal(False, "BOOLEAN")
        if upper == "CASE":
            return self._parse_case()
        if upper == "EXISTS" and self.peek(1).text == "(":
            self.next()
            self.expect_op("(")
            q = self.parse_select()
            self.expect_op(")")
            return A.Exists(q)
        if upper == "CAST":
            self.next()
            self.expect_op("(")
            operand = self.parse_expr()
            self.expect_kw("AS")
            tname, width, scale = self._parse_type_name()
            self.expect_op(")")
            return A.Cast(operand, tname, width, scale)
        if upper == "POSITION" and self.peek(1).text == "(":
            # position(needle in haystack)
            save = self.i
            self.next()
            self.expect_op("(")
            needle = self._parse_concat()  # stop before IN
            if self.accept_kw("IN"):
                haystack = self.parse_expr()
                self.expect_op(")")
                return A.PositionIn(needle, haystack)
            self.i = save  # plain function call position(...)
        # identifier: column ref, qualified ref, or function call
        self.next()
        if self.at_op("("):
            self.expect_op("(")
            if self.accept_op("*"):
                self.expect_op(")")
                call = A.FuncCall(t.text.lower(), [], is_star=True)
                if self.at_kw("OVER"):
                    return self._parse_over(call)
                return call
            args = []
            distinct = self.accept_kw("DISTINCT")
            if not self.at_op(")"):
                while True:
                    args.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            call = A.FuncCall(t.text.lower(), args, distinct=distinct)
            if self.at_kw("OVER"):
                return self._parse_over(call)
            return call
        if self.at_op(".") and self.peek(1).kind == "IDENT":
            self.next()
            col = self.next()
            if col.text == "*":
                return A.Star(table=t.text)
            return A.ColumnRef(col.text, table=t.text)
        if self.at_op(".") and self.peek(1).text == "*":
            self.next()
            self.next()
            return A.Star(table=t.text)
        return A.ColumnRef(t.text)

    def _parse_over(self, call: A.FuncCall) -> A.WindowFunc:
        self.expect_kw("OVER")
        self.expect_op("(")
        partition_by: list = []
        order_by: list = []
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            while True:
                partition_by.append(self.parse_expr())
                if not self.accept_op(","):
                    break
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.parse_expr()
                asc = True
                if self.accept_kw("DESC"):
                    asc = False
                elif self.accept_kw("ASC"):
                    pass
                order_by.append(A.OrderItem(e, asc))
                if not self.accept_op(","):
                    break
        frame = None
        unit = None
        if self.at_kw("ROWS"):
            unit = "rows"
        elif self.at_kw("RANGE"):
            unit = "range"
        if unit is not None:
            self.next()

            def bound():
                if self.accept_kw("UNBOUNDED"):
                    if self.accept_kw("PRECEDING"):
                        return "unbounded_preceding"
                    self.expect_kw("FOLLOWING")
                    return "unbounded_following"
                if self.accept_kw("CURRENT"):
                    self.expect_kw("ROW")
                    return "current"
                k = self.parse_expr()
                if not isinstance(k, A.Literal):
                    raise SqlError("Parser Error: frame offset must be a literal")
                if self.accept_kw("PRECEDING"):
                    return ("preceding", k.value)
                self.expect_kw("FOLLOWING")
                return ("following", k.value)

            if self.accept_kw("BETWEEN"):
                start = bound()
                self.expect_kw("AND")
                end = bound()
            else:
                start = bound()
                end = "current"
            frame = (unit, start, end)
        self.expect_op(")")
        return A.WindowFunc(call.name, call.args, partition_by, order_by,
                            frame)

    def _parse_case(self) -> A.Expr:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        whens = []
        while self.accept_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            whens.append((cond, self.parse_expr()))
        else_ = None
        if self.accept_kw("ELSE"):
            else_ = self.parse_expr()
        self.expect_kw("END")
        return A.Case(operand, whens, else_)


def parse_sql(sql: str) -> list:
    return Parser(sql).parse_statements()


def parse_one(sql: str) -> A.Statement:
    stmts = parse_sql(sql)
    if len(stmts) != 1:
        raise SqlError(f"Parser Error: expected one statement, got {len(stmts)}")
    return stmts[0]
