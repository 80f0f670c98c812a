"""SQL parser for the engine's dialect: recursive descent over statements,
precedence climbing over expressions.

Covers the statements and expression forms used by the reference's SQL test
suite (upstream test/sql/*.test — SURVEY.md §4) and the BASELINE.json
benchmark queries: SELECT (joins, group/order/limit), CREATE [OR REPLACE]
TABLE [AS], INSERT, DROP, PRAGMA, LOAD, casts (CAST(x AS T) and x::T),
position(x IN y), list literals, CASE, LIKE/IN/BETWEEN.
"""

from __future__ import annotations

from ..errors import SqlError
from . import ast as A
from .lexer import KIND, TEXT, UPPER, Token, tokenize

_KEYWORDS_STOP_ALIAS = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "JOIN",
    "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "ON", "USING", "AS", "AND",
    "OR", "NOT", "UNION", "EXCEPT", "INTERSECT", "SELECT", "SET", "VALUES",
}


# binding levels of the expression grammar, low to high: a level's operators
# take operands of the level above (left-associative), and prefix NOT
# applies only where an operand of level NOT or lower is wanted
_OR, _AND, _NOT, _CMP, _CONCAT, _ADD, _MUL, _UNARY = range(1, 9)
_OP_LEVEL = {"=": _CMP, "==": _CMP, "<>": _CMP, "!=": _CMP, "<": _CMP, "<=": _CMP,
             ">": _CMP, ">=": _CMP, "||": _CONCAT, "+": _ADD, "-": _ADD,
             "*": _MUL, "/": _MUL, "%": _MUL}
_KW_LEVEL = {"OR": _OR, "AND": _AND, "IS": _CMP, "NOT": _CMP, "IN": _CMP,
             "BETWEEN": _CMP, "LIKE": _CMP}
_CANONICAL_OP = {"==": "=", "!=": "<>"}
_IN_BETWEEN_LIKE = ("IN", "BETWEEN", "LIKE")
# identifiers that open something other than a column or a function call
_PRIMARY_KWS = {"NULL", "TRUE", "FALSE", "CASE", "EXISTS", "CAST", "POSITION"}


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.tokens.append(self.tokens[-1])  # a second EOF: peek(1) needs no bounds check
        self.i = 0
        self.tok = self.tokens[0]  # the current token, tokens[i]
        self._param_count = 0  # positional '?' parameters seen so far

    # -- token helpers ----------------------------------------------------

    def peek(self, offset: int = 0) -> Token:
        return self.tokens[self.i + offset]

    def next(self) -> Token:
        t = self.tok
        if t[KIND] != "EOF":
            self.i += 1
            self.tok = self.tokens[self.i]
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.tok
        return t[KIND] == "IDENT" and t[UPPER] in kws

    def accept_kw(self, kw: str) -> bool:
        t = self.tok
        if t[UPPER] == kw and t[KIND] == "IDENT":
            self.i += 1
            self.tok = self.tokens[self.i]
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SqlError(f"Parser Error: expected {kw}, got '{self.tok[TEXT]}'")

    def at_op(self, op: str) -> bool:
        t = self.tok
        return t[TEXT] == op and t[KIND] == "OP"

    def accept_op(self, op: str) -> bool:
        t = self.tok
        if t[TEXT] == op and t[KIND] == "OP":
            self.i += 1
            self.tok = self.tokens[self.i]
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlError(f"Parser Error: expected '{op}', got '{self.tok[TEXT]}'")

    def expect_ident(self) -> str:
        t = self.tok
        if t[KIND] != "IDENT":
            raise SqlError(f"Parser Error: expected identifier, got '{t[TEXT]}'")
        self.i += 1
        self.tok = self.tokens[self.i]
        return t[TEXT]

    # -- statements -------------------------------------------------------

    def parse_statements(self) -> list:
        stmts = []
        while self.tok[KIND] != "EOF":
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
            kind = self.next()[UPPER]
            self.expect_kw("DATABASE")
            t = self.next()
            if t[KIND] != "STRING":
                raise SqlError(f"Parser Error: {kind} DATABASE expects a path string")
            return (A.ExportDatabase(t[TEXT]) if kind == "EXPORT"
                    else A.ImportDatabase(t[TEXT]))
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
            if t[KIND] != "STRING":
                raise SqlError("Parser Error: COPY ... TO expects a path string")
            fmt = "csv"
            if self.accept_op("("):
                if not self.accept_kw("FORMAT"):
                    self.expect_ident()  # tolerate other option names
                fmt = self.next()[TEXT].lower()
                self.expect_op(")")
            return A.CopyTo(source, t[TEXT], fmt)
        if self.at_kw("PRAGMA"):
            self.next()
            name = self.expect_ident()
            value = None
            if self.accept_op("="):
                value = self.next()[TEXT]
            return A.Pragma(name, value)
        if self.at_kw("LOAD"):
            self.next()
            t = self.next()
            return A.Load(t[TEXT])
        if self.at_kw("SET"):
            self.next()
            name = self.expect_ident()
            self.expect_op("=")
            return A.SetStmt(name, self.next()[TEXT])
        raise SqlError(f"Parser Error: unexpected statement start '{self.tok[TEXT]}'")

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
            width = int(self.next()[TEXT])
            if self.accept_op(","):
                scale = int(self.next()[TEXT])
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
            kind = self.next()[UPPER]
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
            kw = self.tok[UPPER] if self.tok[KIND] == "IDENT" else ""
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
            elif kw == "GROUPING" and self.peek(1)[UPPER] == "SETS":
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
            sel.limit = int(self.next()[TEXT])
        if self.accept_kw("OFFSET"):
            sel.offset = int(self.next()[TEXT])
        return sel

    def _parse_select_item(self) -> A.SelectItem:
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.expect_ident()
        elif self.tok[KIND] == "IDENT" and self.tok[UPPER] not in _KEYWORDS_STOP_ALIAS:
            alias = self.next()[TEXT]
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
        if self.tok[KIND] == "IDENT" and self.tok[UPPER] not in _KEYWORDS_STOP_ALIAS:
            return self.next()[TEXT]
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

    def parse_expr(self, level: int = _OR) -> A.Expr:
        """An expression of the operators that bind at ``level`` or tighter.

        Once an operator of some level has been applied, only operators of
        that level or looser may follow: ``a IS NULL * b`` stops before the
        ``*``, as the descent it replaces did."""
        kind, text, _, upper = self.tok
        ceiling = _UNARY  # after a bare operand any operator may follow
        if kind == "IDENT" and upper == "NOT" and level <= _NOT:
            self.i += 1
            self.tok = self.tokens[self.i]
            left = A.Unary("NOT", self.parse_expr(_NOT))
            ceiling = _NOT
        elif kind == "OP" and (text == "-" or text == "+"):
            left = self._parse_unary()
        else:
            if kind == "IDENT" and upper not in _PRIMARY_KWS:
                nt = self.tokens[self.i + 1]
                if nt[KIND] == "OP" and (nt[TEXT] == "," or nt[TEXT] == ")"):
                    # a bare column, as most operands of a select list or a
                    # call are: nothing after it can extend the expression
                    self.i += 1
                    self.tok = nt
                    return A.ColumnRef(text)
            left = self._parse_primary()
            if self.tok[KIND] == "OP" and self.tok[TEXT] in ("::", "["):
                left = self._parse_postfix(left)
        while True:
            kind, text, _, upper = self.tok
            if kind == "OP":
                lv = _OP_LEVEL.get(text)
                if lv is None or not level <= lv <= ceiling:
                    return left
                self.i += 1
                self.tok = self.tokens[self.i]
                if lv == _MUL:
                    left = A.Binary(text, left, self._parse_unary())
                else:
                    left = A.Binary(_CANONICAL_OP.get(text, text), left, self.parse_expr(lv + 1))
            elif kind == "IDENT":
                lv = _KW_LEVEL.get(upper)
                if lv is None or not level <= lv <= ceiling:
                    return left
                if lv != _CMP:  # AND, OR
                    self.i += 1
                    self.tok = self.tokens[self.i]
                    left = A.Binary(upper, left, self.parse_expr(lv + 1))
                elif upper == "IS":
                    self.next()
                    negated = self.accept_kw("NOT")
                    self.expect_kw("NULL")
                    left = A.IsNull(left, negated)
                elif upper == "NOT":
                    if self.tokens[self.i + 1][UPPER] not in _IN_BETWEEN_LIKE:
                        return left
                    self.next()
                    left = self._parse_in_between_like(left, negated=True)
                else:
                    left = self._parse_in_between_like(left, negated=False)
            else:
                return left
            ceiling = lv

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
            low = self.parse_expr(_CONCAT)
            self.expect_kw("AND")
            high = self.parse_expr(_CONCAT)
            return A.Between(left, low, high, negated)
        self.expect_kw("LIKE")
        return A.Like(left, self.parse_expr(_CONCAT), negated)

    def _parse_unary(self) -> A.Expr:
        kind, text, _, _ = self.tok
        if kind == "OP":
            if text == "-":
                self.next()
                return A.Unary("-", self._parse_unary())
            if text == "+":
                self.next()
                return self._parse_unary()
        e = self._parse_primary()
        if self.tok[KIND] == "OP" and self.tok[TEXT] in ("::", "["):
            e = self._parse_postfix(e)
        return e

    def _parse_postfix(self, e: A.Expr) -> A.Expr:
        while True:
            if self.accept_op("::"):
                tname, width, scale = self._parse_type_name()
                e = A.Cast(e, tname, width, scale)
                continue
            if self.accept_op("["):
                idx = self.parse_expr()
                self.expect_op("]")
                e = A.FuncCall("list_extract", [e, idx])
                continue
            return e

    def _parse_primary(self) -> A.Expr:
        kind, text, _, upper = self.tok
        if kind == "IDENT":
            if upper in _PRIMARY_KWS:
                e = self._parse_keyword_primary(upper)
                if e is not None:
                    return e
            # identifier: column ref, qualified ref, or function call
            self.i += 1
            nt = self.tokens[self.i]
            self.tok = nt
            if nt[KIND] != "OP":
                return A.ColumnRef(text)
            if nt[TEXT] == "(":
                return self._parse_call(text)
            if nt[TEXT] == ".":
                after = self.tokens[self.i + 1]
                if after[KIND] == "IDENT":
                    self.next()
                    col = self.next()[TEXT]
                    if col == "*":
                        return A.Star(table=text)
                    return A.ColumnRef(col, table=text)
                if after[TEXT] == "*":
                    self.next()
                    self.next()
                    return A.Star(table=text)
            return A.ColumnRef(text)
        if kind == "NUMBER":
            self.next()
            if "." in text or "e" in text or "E" in text:
                return A.Literal(float(text), "DOUBLE")
            v = int(text)
            return A.Literal(v, "INTEGER" if -(2**31) <= v < 2**31 else "BIGINT")
        if kind == "STRING":
            self.next()
            return A.Literal(text, "VARCHAR")
        if kind == "OP":
            if text == "?":
                # positional prepared-statement parameter, bound at execute time
                self.next()
                idx = self._param_count
                self._param_count += 1
                return A.Parameter(idx)
            if text == "(":
                self.next()
                if self.at_kw("SELECT"):
                    q = self.parse_select()
                    self.expect_op(")")
                    return A.FuncCall("__scalar_subquery__", [q])
                e = self.parse_expr()
                self.expect_op(")")
                return e
            if text == "[":
                self.next()
                items = []
                if not self.at_op("]"):
                    while True:
                        items.append(self.parse_expr())
                        if not self.accept_op(","):
                            break
                self.expect_op("]")
                return A.ListExpr(items)
            if text == "*":
                self.next()
                return A.Star()
        raise SqlError(f"Parser Error: unexpected token '{text}'")

    def _parse_keyword_primary(self, upper: str) -> A.Expr | None:
        """NULL, TRUE, FALSE, CASE, EXISTS (, CAST and position(x IN y); None
        where the identifier is a plain column or function name after all."""
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
        if upper == "EXISTS" and self.peek(1)[TEXT] == "(":
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
        if upper == "POSITION" and self.peek(1)[TEXT] == "(":
            # position(needle in haystack)
            save = self.i
            self.next()
            self.expect_op("(")
            needle = self.parse_expr(_CONCAT)  # stop before IN
            if self.accept_kw("IN"):
                haystack = self.parse_expr()
                self.expect_op(")")
                return A.PositionIn(needle, haystack)
            self.i = save  # plain function call position(...)
            self.tok = self.tokens[save]
        return None

    def _parse_call(self, name: str) -> A.Expr:
        """A function call from its '(' on, with an OVER clause if one follows."""
        self.expect_op("(")
        if self.accept_op("*"):
            self.expect_op(")")
            call = A.FuncCall(name.lower(), [], is_star=True)
            if self.at_kw("OVER"):
                return self._parse_over(call)
            return call
        args = []
        distinct = self.accept_kw("DISTINCT")
        if not self.at_op(")"):
            while True:
                args.append(self.parse_expr())
                t = self.tok
                if t[TEXT] != "," or t[KIND] != "OP":
                    break
                self.i += 1
                self.tok = self.tokens[self.i]
        self.expect_op(")")
        call = A.FuncCall(name.lower(), args, distinct=distinct)
        if self.at_kw("OVER"):
            return self._parse_over(call)
        return call

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
