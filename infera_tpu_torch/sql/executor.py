"""SQL execution: catalog, expression evaluation, and the relational
operators (scan → filter → project → aggregate/join/sort) over columnar
Tables.

This is the port's copy of ``infera_tpu/sql/executor.py``, the replacement
for DuckDB's planner/executor pair that hosts the reference extension
(SURVEY.md §1 L4). Semantics pinned by the
reference's sqllogictests are honored here: NULL propagation through scalar
expressions (constant NULL model name → NULL prediction,
test_edge_cases.test), volatile infera_* functions re-evaluated at every call
site, and DuckDB-style value rendering for the test harness.

The device tiers: ``device_join_plan.try_execute_join_on_device`` runs a
fact→dimension join with its aggregates, before any join materializes, as
kernel K5 on CUDA (``_exec_path == "device_join_plan_cuda"``) or, where K5
is off or declines the plan, as the torch join program
(``"device_join_plan"``); ``device_plan.try_execute_on_device`` runs an
aggregate over one scanned table as kernel K2 (``"device_plan_cuda"``) or,
where K2 is off or declines the plan, as the torch program,
``infera_tpu``'s fused XLA program in eager torch ops (``"device_plan"``),
and so does an aggregate over a windowed subquery that
``window_fusion.flatten_windowed_scan`` folds into one scan, its windows
computed in the program. Every other query, and every plan those tiers
decline, runs on the host operators (numpy), where a join over large keys
takes the sort-join of ``ops/device_join.py`` in torch ops
(``"device_join"``), an ORDER BY of 2**15 numeric rows or more sorts on
the device (``ops/sort.py``) and a window may take the opt-in device route
of ``ops/window.py``.

From ``streaming_plan.STREAM_MIN_ROWS`` rows an aggregate over one table
tries ``streaming_plan.try_execute_streaming`` first (``"streaming_plan"``:
fixed-size chunks through the device, memmap columns read from disk, the
partials folded on the device), then the device plan, as ``infera_tpu``
does. An INNER join of two large tables with duplicate keys that the
fact→dim join tiers decline runs ``shuffle_join_plan.try_execute_shuffle_join``
behind the same entry, ``device_join_plan.try_execute_join_on_device``
(``"shuffle_join"``: per-key partials of one side, the other streamed
through them, no pair built).

With a data-parallel mesh set (``set_mesh`` or ``INFERA_MESH``; ROADMAP
P13a) each of those four tiers runs over the mesh's shards
(``sql/mesh_plan.py``) and the path takes ``_mesh`` after the tier's name
(``"device_plan_mesh"``, ``"device_join_plan_mesh"``,
``"streaming_plan_mesh"``, ``"shuffle_join_mesh"``); K2 and K5 do not run on
a meshed connection.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from ..columnar import Column, Table, infer_sql_type
from ..columnar import types as T
from ..errors import SqlError
from ..observability import measure, span
from . import ast as A
from .functions import AGGREGATE_FUNCTIONS, SCALAR_FUNCTIONS
from .parser import parse_sql

class _DecorrelateBail(Exception):
    """Internal: a shape the grouped decorrelation cannot carry."""


class Catalog:
    def __init__(self):
        self.tables: dict = {}

    def get(self, name: str) -> Table:
        t = self.tables.get(name.lower())
        if t is None:
            raise SqlError(f"Catalog Error: Table with name {name} does not exist!")
        return t

    def put(self, name: str, table: Table, or_replace: bool = False):
        key = name.lower()
        if key in self.tables and not or_replace:
            raise SqlError(f"Catalog Error: Table with name \"{name}\" already exists!")
        self.tables[key] = table

    def drop(self, name: str, if_exists: bool = False):
        key = name.lower()
        if key not in self.tables:
            if if_exists:
                return
            raise SqlError(f"Catalog Error: Table with name {name} does not exist!")
        del self.tables[key]


@dataclass
class QueryResult:
    table: Table | None = None
    names: list = field(default_factory=list)

    @property
    def rows(self) -> list:
        return [] if self.table is None else self.table.to_pylist()

    def scalar(self):
        if self.table is None or self.table.num_rows == 0:
            return None
        return self.table.row(0)[0]

    def df(self):
        """Result as a pandas DataFrame (DuckDB-style `.df()`)."""
        from ..columnar.pandas_io import table_to_pandas

        return table_to_pandas(self.table if self.table is not None else Table({}))


# ---------------------------------------------------------------------------
# Evaluation context
# ---------------------------------------------------------------------------

class Scope:
    """Column namespace for expression evaluation: qualified and bare names."""

    def __init__(self, table: Table, qualifiers: dict | None = None):
        self.table = table
        # qualifiers: bare column name → list of qualified names, used to
        # detect ambiguity. Table stores columns under 'alias.col' when
        # joined, plus bare name when unambiguous.

    @property
    def num_rows(self) -> int:
        return self.table.num_rows

    def lookup(self, name: str, qualifier: str | None) -> Column:
        if qualifier:
            key = f"{qualifier}.{name}"
            if key in self.table.columns:
                return self.table.columns[key]
            raise SqlError(f'Binder Error: Referenced column "{qualifier}.{name}" not found')
        if name in self.table.columns:
            return self.table.columns[name]
        # case-insensitive fallback
        for k in self.table.columns:
            bare = k.split(".")[-1]
            if bare.lower() == name.lower():
                return self.table.columns[k]
        raise SqlError(f'Binder Error: Referenced column "{name}" not found')


def _dummy_scope() -> Scope:
    return Scope(Table({"__dummy__": Column(np.zeros(1, dtype=np.int8), T.TINYINT)}))


# ---------------------------------------------------------------------------
# Connection
# ---------------------------------------------------------------------------

class Connection:
    """An in-process SQL session (analog of a DuckDB connection running the
    loaded infera extension)."""

    def __init__(self, catalog: Catalog | None = None):
        self.catalog = catalog or Catalog()
        self._exec_path = "host"  # path that served the current statement
        self._macros: dict = {}   # name → (params, body Expr)
        self._mesh_plan_used = False   # a device tier ran on the mesh
        self._mesh_decline = None      # why the mesh last declined a plan, if it did

    # -- public API -------------------------------------------------------

    def execute(self, sql: str, parameters: list | None = None) -> QueryResult:
        """Execute one or more ';'-separated statements. ``parameters`` bind
        positional '?' placeholders (prepared-statement style)."""
        result = QueryResult()
        self._bound_params = list(parameters) if parameters is not None else None
        try:
            with span("execute", root=True):
                with span("parse"):
                    stmts = parse_sql(sql)
                for stmt in stmts:
                    with measure(type(stmt).__name__) as m:
                        self._exec_path = "host"
                        self._last_phases = None
                        result = self._execute_statement(stmt)
                        m.path = self._exec_path
                        m.phases = getattr(self, "_last_phases", None)
                        if result.table is not None:
                            m.rows = result.table.num_rows
        finally:
            self._bound_params = None
        return result

    def set_mesh(self, mesh) -> None:
        """Enable mesh-partitioned query execution on this connection.

        ``mesh`` may be an int (a dp mesh of that many shards on the port's
        device, ``parallel.mesh.make_mesh``), a ``parallel.mesh.Mesh``, or
        None for one device. Overrides the read-once ``INFERA_MESH`` knob."""
        from ..parallel.mesh import Mesh, make_mesh

        if isinstance(mesh, bool) or not (mesh is None or isinstance(mesh, (int, Mesh))):
            raise SqlError(f"set_mesh takes a shard count, a Mesh or None, not {mesh!r}")
        if isinstance(mesh, int):
            mesh = make_mesh(mesh)
        self._mesh = mesh

    def register_table(self, name: str, table) -> None:
        """Register a columnar Table — or a pandas DataFrame, which is
        converted automatically (DuckDB-style DataFrame querying)."""
        if not isinstance(table, Table) and hasattr(table, "columns") and hasattr(table, "dtypes"):
            from ..columnar.pandas_io import table_from_pandas

            table = table_from_pandas(table)
        self.catalog.put(name, table, or_replace=True)

    # -- statements -------------------------------------------------------

    def _execute_statement(self, stmt: A.Statement) -> QueryResult:
        if isinstance(stmt, (A.Select, A.SetOp)):
            table = self._execute_query(stmt)
            return QueryResult(table, table.names)
        if isinstance(stmt, A.CreateTableAs):
            table = self._execute_query(stmt.query)
            self.catalog.put(stmt.name, table, stmt.or_replace)
            return QueryResult()
        if isinstance(stmt, A.CreateMacro):
            key = stmt.name.lower()
            if key in self._macros and not stmt.or_replace:
                raise SqlError(
                    f"Catalog Error: Macro with name \"{stmt.name}\" already exists!")
            self._macros[key] = (stmt.params, stmt.expr)
            return QueryResult()
        if isinstance(stmt, A.CreateTable):
            cols = {}
            for cd in stmt.columns:
                t = T.type_from_name(cd.type_name, cd.width, cd.scale)
                dtype = t.np_dtype if t.np_dtype is not None else object
                cols[cd.name] = Column(np.empty(0, dtype=dtype), t)
            self.catalog.put(stmt.name, Table(cols), stmt.or_replace)
            return QueryResult()
        if isinstance(stmt, A.ExportDatabase):
            import json as _json
            import os as _os

            from ..columnar.diskfile import write_columnar

            _os.makedirs(stmt.path, exist_ok=True)
            names = sorted(self.catalog.tables)
            total = 0
            for name in names:
                total += write_columnar(self.catalog.tables[name],
                                        _os.path.join(stmt.path, name))
            with open(_os.path.join(stmt.path, "catalog.json"), "w") as f:
                _json.dump({"version": 1, "tables": names}, f)
            count = Table({"Tables": Column(np.asarray([len(names)], np.int64),
                                            T.BIGINT)})
            return QueryResult(count, count.names)
        if isinstance(stmt, A.ImportDatabase):
            import json as _json
            import os as _os

            from ..columnar.diskfile import read_columnar

            manifest = _os.path.join(stmt.path, "catalog.json")
            if not _os.path.isfile(manifest):
                raise SqlError(f"IO Error: not an exported database: {stmt.path}")
            with open(manifest) as f:
                names = _json.load(f)["tables"]
            for name in names:
                self.catalog.put(name, read_columnar(_os.path.join(stmt.path, name)),
                                 or_replace=True)
            count = Table({"Tables": Column(np.asarray([len(names)], np.int64),
                                            T.BIGINT)})
            return QueryResult(count, count.names)
        if isinstance(stmt, A.With):
            # evaluate CTEs in order into a catalog overlay (later CTEs and
            # the main query see earlier ones); restore shadowed tables after
            saved: dict = {}
            added: list = []
            try:
                for name, col_aliases, q in stmt.ctes:
                    t = self._execute_query(q)
                    if col_aliases:
                        t = _rename_columns(t, col_aliases)
                    key = name.lower()
                    if key in self.catalog.tables:
                        saved[key] = self.catalog.tables[key]
                    else:
                        added.append(key)
                    self.catalog.tables[key] = t
                table = self._execute_query(stmt.query)
                return QueryResult(table, table.names)
            finally:
                for key in added:
                    self.catalog.tables.pop(key, None)
                self.catalog.tables.update(saved)
        if isinstance(stmt, A.Insert):
            return self._execute_insert(stmt)
        if isinstance(stmt, A.Delete):
            table = self.catalog.get(stmt.table)
            if stmt.where is None:
                kept = table.filter(np.zeros(table.num_rows, bool))
            else:
                mask = _as_bool_mask(self._eval(stmt.where, Scope(table)))
                kept = table.filter(~mask)
            self.catalog.put(stmt.table, kept, or_replace=True)
            n = table.num_rows - kept.num_rows
            count = Table({"Count": Column(np.asarray([n], np.int64), T.BIGINT)})
            return QueryResult(count, count.names)
        if isinstance(stmt, A.Update):
            table = self.catalog.get(stmt.table)
            scope = Scope(table)
            if stmt.where is None:
                mask = np.ones(table.num_rows, bool)
            else:
                mask = _as_bool_mask(self._eval(stmt.where, scope))
            new_cols = dict(table.columns)
            for col_name, expr in stmt.assignments:
                key = None
                for k in table.columns:
                    if k.split(".")[-1].lower() == col_name.lower():
                        key = k
                        break
                if key is None:
                    raise SqlError(f"Binder Error: Referenced column \"{col_name}\" "
                                   f"not found in FROM clause!")
                old = table.columns[key]
                new = self._eval(expr, scope)
                if new.sql_type.name != old.sql_type.name and old.sql_type.is_numeric:
                    new = new.cast(old.sql_type)
                data = old.data.copy()
                data[mask] = new.data[mask] if len(new) == len(old) else new.value(0)
                validity = None
                if old.validity is not None or new.validity is not None:
                    validity = old.valid_mask().copy()
                    validity[mask] = new.valid_mask()[mask] if len(new) == len(old) else True
                    if validity.all():
                        validity = None
                new_cols[key] = Column(data, old.sql_type, validity)
            self.catalog.put(stmt.table, Table(new_cols), or_replace=True)
            n = int(mask.sum())
            count = Table({"Count": Column(np.asarray([n], np.int64), T.BIGINT)})
            return QueryResult(count, count.names)
        if isinstance(stmt, A.DropTable):
            self.catalog.drop(stmt.name, stmt.if_exists)
            return QueryResult()
        if isinstance(stmt, A.CopyTo):
            if isinstance(stmt.source, str):
                table = self.catalog.get(stmt.source)
            else:
                table = self._execute_query(stmt.source)
            fmt = getattr(stmt, "format", "csv")
            if fmt == "columnar":
                from ..columnar.diskfile import write_columnar

                n = write_columnar(table, stmt.path)
            elif fmt == "csv":
                from .csv_io import write_csv

                n = write_csv(table, stmt.path)
            else:
                raise SqlError(f"Invalid Input Error: unsupported COPY "
                               f"format '{fmt}'")
            count = Table({"Count": Column(np.asarray([n], np.int64), T.BIGINT)})
            return QueryResult(count, count.names)
        if isinstance(stmt, A.Explain):
            lines = self._explain(stmt.query)
            if stmt.analyze:
                # EXPLAIN ANALYZE: actually run the query, report actuals
                import time as _time

                self._exec_path = "host"
                t0 = _time.perf_counter()
                if isinstance(stmt.query, A.With):
                    out = self._execute_statement(stmt.query).table
                else:
                    out = self._execute_query(stmt.query)
                wall = _time.perf_counter() - t0
                lines += [
                    "─" * 40,
                    f"ACTUAL: {out.num_rows} rows in {wall * 1e3:.2f} ms "
                    f"({out.num_rows / wall:,.0f} rows/s)" if wall > 0 else
                    f"ACTUAL: {out.num_rows} rows",
                    f"PATH: {self._exec_path}",
                ]
                phases = getattr(self, "_last_phases", None)
                if phases:
                    lines.append("PHASES: " + "  ".join(
                        f"{k}={v}" for k, v in phases.items()))
            col = Column.from_values(lines, T.VARCHAR)
            t = Table({"explain": col})
            return QueryResult(t, t.names)
        if isinstance(stmt, (A.Pragma, A.Load, A.SetStmt)):
            # pragma enable_verification / load '<ext>' are DuckDB harness
            # statements; the engine accepts and ignores them.
            return QueryResult()
        raise SqlError(f"unsupported statement {type(stmt).__name__}")

    def _execute_insert(self, stmt: A.Insert) -> QueryResult:
        existing = self.catalog.get(stmt.table)
        if stmt.query is not None:
            new = self._execute_select(stmt.query)
            new_cols = list(new.columns.values())
        else:
            scope = _dummy_scope()
            n = len(stmt.rows)
            col_vals: list = [[] for _ in range(len(stmt.rows[0]))]
            for row in stmt.rows:
                if len(row) != len(col_vals):
                    raise SqlError("Binder Error: VALUES rows have unequal lengths")
                for j, e in enumerate(row):
                    col_vals[j].append(self._eval(e, scope).value(0))
            new_cols = []
            for j, vals in enumerate(col_vals):
                new_cols.append(Column.from_values(vals, infer_sql_type(vals)))
            del n
        names = stmt.columns or existing.names
        if len(new_cols) != len(names):
            raise SqlError("Binder Error: column count mismatch in INSERT")
        cols = {}
        for name in existing.names:
            old = existing.columns[name]
            if name in names:
                add = new_cols[names.index(name)].cast(old.sql_type)
            else:
                add = Column.constant(None, old.sql_type, len(new_cols[0]))
            data = np.concatenate([old.data, add.data])
            if old.validity is None and add.validity is None:
                validity = None
            else:
                validity = np.concatenate([old.valid_mask(), add.valid_mask()])
            cols[name] = Column(data, old.sql_type, validity)
        self.catalog.tables[stmt.table.lower()] = Table(cols)
        return QueryResult()

    # -- EXPLAIN ----------------------------------------------------------

    def _explain(self, stmt, depth: int = 0) -> list:
        pad = "  " * depth
        lines: list = []
        if isinstance(stmt, A.SetOp):
            lines.append(f"{pad}{stmt.kind}{' ALL' if stmt.all else ''}")
            lines += self._explain(stmt.left, depth + 1)
            lines += self._explain(stmt.right, depth + 1)
            return lines
        if isinstance(stmt, A.With):
            for name, _, q in stmt.ctes:
                lines.append(f"{pad}CTE {name}")
                lines += self._explain(q, depth + 1)
            lines += self._explain(stmt.query, depth)
            return lines
        sel = stmt
        has_agg = bool(sel.group_by) or any(
            _contains_aggregate(i.expr) for i in sel.items
        )
        tier = None  # the device tier the plan takes, by name
        if isinstance(sel.from_, A.BaseTable):
            from .device_plan import try_execute_on_device

            try:
                table = _qualify(self.catalog.get(sel.from_.name),
                                 sel.from_.alias or sel.from_.name)
                tier = try_execute_on_device(self, sel, table, analyze_only=True)
            except SqlError:
                pass
        elif isinstance(sel.from_, A.SubqueryRef):
            # windowed-subquery fusion: the flattened plan's tier
            from .device_plan import try_execute_on_device
            from .window_fusion import flatten_windowed_scan

            flat = flatten_windowed_scan(sel)
            if flat is not None and isinstance(flat.from_, A.BaseTable):
                try:
                    table = _qualify(self.catalog.get(flat.from_.name),
                                     flat.from_.alias or flat.from_.name)
                    if try_execute_on_device(self, flat, table, analyze_only=True):
                        tier = "window computed in-program"
                except SqlError:
                    pass
        elif isinstance(sel.from_, A.Join):
            from .device_join_plan import try_execute_join_on_device

            try:
                # K5, the torch join program or the shuffle join
                tier = try_execute_join_on_device(self, sel, analyze_only=True)
            except SqlError:
                pass
        lines.append(f"{pad}PROJECT [{len(sel.items)} exprs]"
                     + (" (DISTINCT)" if sel.distinct else ""))
        if has_agg:
            keys = len(sel.group_by)
            gs = getattr(sel, "group_sets", None)
            if gs:
                lines.append(
                    f"{pad}  GROUPING SETS [{len(gs)} sets → UNION ALL]")
            lines.append(f"{pad}  AGGREGATE [group keys: {keys}]"
                         + (f" ← fused device plan ({tier})" if tier
                            else " ← host/hybrid operators"))
        if sel.order_by:
            lines.append(f"{pad}  ORDER BY [{len(sel.order_by)} keys]")
        if sel.where is not None:
            lines.append(f"{pad}  FILTER")
        lines += self._explain_from(sel.from_, depth + 1)
        return lines

    def _explain_from(self, ref, depth: int) -> list:
        pad = "  " * depth
        if ref is None:
            return [f"{pad}DUAL"]
        if isinstance(ref, A.BaseTable):
            try:
                n = self.catalog.get(ref.name).num_rows
                return [f"{pad}SCAN {ref.name} [{n} rows]"]
            except SqlError:
                return [f"{pad}SCAN {ref.name}"]
        if isinstance(ref, A.Join):
            lines = [f"{pad}{ref.kind} JOIN"]
            lines += self._explain_from(ref.left, depth + 1)
            lines += self._explain_from(ref.right, depth + 1)
            return lines
        if isinstance(ref, A.SubqueryRef):
            return [f"{pad}SUBQUERY"] + self._explain(ref.query, depth + 1)
        if isinstance(ref, A.TableFunction):
            return [f"{pad}TABLE FUNCTION {ref.name}"]
        if isinstance(ref, A.ValuesRef):
            return [f"{pad}VALUES [{len(ref.rows)} rows]"]
        return [f"{pad}{type(ref).__name__}"]

    # -- SELECT pipeline --------------------------------------------------

    def _execute_query(self, stmt) -> Table:
        if isinstance(stmt, A.SetOp):
            return self._execute_setop(stmt)
        return self._execute_select(stmt)

    def _execute_setop(self, op: A.SetOp) -> Table:
        left = self._execute_query(op.left)
        right = self._execute_query(op.right)
        if len(left.columns) != len(right.columns):
            raise SqlError(
                "Binder Error: set operations require matching column counts"
            )
        lcols = list(left.columns.items())
        rcols = list(right.columns.values())
        if op.kind == "UNION":
            def _typed_null(n_rows: int, like: Column) -> Column:
                return Column(np.zeros(n_rows, like.data.dtype),
                              like.sql_type, np.zeros(n_rows, bool))

            cols = {}
            for (name, lc), rc in zip(lcols, rcols):
                # an all-NULL side takes the other side's type (grouping
                # sets / explicit NULL literals must not demote INTEGER
                # keys to DOUBLE)
                if lc.sql_type.name == "NULL" and rc.sql_type.name != "NULL":
                    lc = _typed_null(left.num_rows, rc)
                elif (rc.sql_type.name == "NULL"
                        and lc.sql_type.name != "NULL"):
                    rc = _typed_null(right.num_rows, lc)
                t = lc.sql_type if lc.sql_type.name != "NULL" else rc.sql_type
                if lc.sql_type.np_dtype != rc.sql_type.np_dtype:
                    lc = lc.cast(T.DOUBLE) if lc.sql_type.is_numeric else lc
                    rc = rc.cast(T.DOUBLE) if rc.sql_type.is_numeric else rc
                    t = lc.sql_type
                data = np.concatenate([
                    lc.data if lc.data.dtype == rc.data.dtype else lc.data.astype(object),
                    rc.data if lc.data.dtype == rc.data.dtype else rc.data.astype(object),
                ])
                validity = None
                if lc.validity is not None or rc.validity is not None:
                    validity = np.concatenate([lc.valid_mask(), rc.valid_mask()])
                cols[name] = Column(data, t, validity)
            out = Table(cols)
            if not op.all:
                out = _distinct(out)
        else:
            out = None
            if left.num_rows + right.num_rows >= _ROWCODE_MIN_ROWS:
                # vectorized row-code set ops (VERDICT r4 item 4): one
                # np.unique over both sides' code matrices replaces the
                # per-row tuple loop (~2 s/M rows before)
                rc = _row_codes([left, right])
                if rc is not None:
                    ids, (nl, _nr) = rc
                    lids, rids = ids[:nl], ids[nl:]
                    _, first = np.unique(lids, return_index=True)
                    first = np.sort(first)
                    in_right = np.isin(lids[first], rids)
                    keep_m = ~in_right if op.kind == "EXCEPT" else in_right
                    out = left.take(first[keep_m].astype(np.int64))
            if out is None:
                lrows = {left.row(i) for i in range(left.num_rows)}
                rrows = {right.row(i) for i in range(right.num_rows)}
                if op.kind == "EXCEPT":
                    keep = lrows - rrows
                else:  # INTERSECT
                    keep = lrows & rrows
                seen = set()
                idx = []
                for i in range(left.num_rows):
                    r = left.row(i)
                    if r in keep and r not in seen:
                        seen.add(r)
                        idx.append(i)
                out = left.take(np.asarray(idx, dtype=np.int64))
        if op.order_by:
            out = self._order_by(out, op.order_by, Scope(out),
                                 head=op.limit)
        if op.limit is not None:
            out = out.slice(0, op.limit)
        return out

    def _finish_fused(self, sel: A.Select, fused: Table):
        """A device tier's group table with the SELECT's ORDER BY, OFFSET
        and LIMIT applied; None (the host answers) when ORDER BY names
        something outside the output."""
        try:
            if sel.order_by:
                fused = self._order_by(fused, sel.order_by, Scope(fused),
                                       head=_head_rows(sel))
        except SqlError:
            self._exec_path = "host"
            return None
        if sel.offset is not None or sel.limit is not None:
            start = sel.offset or 0
            stop = start + sel.limit if sel.limit is not None else fused.num_rows
            fused = fused.slice(start, stop)
        return fused

    def _execute_select(self, sel: A.Select) -> Table:
        if getattr(sel, "group_sets", None):
            return self._execute_grouping_sets(sel)
        # 1a. fused join plan — BEFORE the host join materializes: a
        # fact-to-dimension join + aggregates runs as kernel K5 with a dense
        # key lookup inside it, or as the torch join program (BASELINE
        # config 3)
        if isinstance(sel.from_, A.Join):
            from .device_join_plan import try_execute_join_on_device

            # a join the fact→dim tiers decline goes on to the big×big
            # shuffle join (BASELINE config 5) behind the same entry
            self._mesh_plan_used = False
            fused = try_execute_join_on_device(self, sel)
            if fused is not None:
                path = ("shuffle_join" if getattr(self, "_shuffle_join_used", False)
                        else "device_join_plan_cuda" if self._cuda_plan_used
                        else "device_join_plan")
                if self._mesh_plan_used:
                    path += "_mesh"   # the tier that served the query, on the mesh
                fused = self._finish_fused(sel, fused)
                if fused is not None:
                    self._exec_path = path
                    return fused

        # 1a'. windowed-subquery fusion: flatten an eligible window-bearing
        # subquery scan into the fused device plan BEFORE the host executes
        # the inner projection — the [n]-row window result stays on the
        # device inside the torch program and only the [G] group table
        # returns (sql/window_fusion.py)
        if isinstance(sel.from_, A.SubqueryRef):
            from .device_plan import try_execute_on_device
            from .window_fusion import flatten_windowed_scan

            flat = flatten_windowed_scan(sel)
            if flat is not None and isinstance(flat.from_, (A.BaseTable, A.TableFunction)):
                try:
                    base = self._execute_from(flat.from_)
                except SqlError:
                    base = None
                self._mesh_plan_used = False
                fused = None if base is None else try_execute_on_device(self, flat, base)
                if fused is not None:
                    # K2 declines windows; it takes a flattened query that
                    # reads none of the subquery's windows
                    path = ("device_plan_mesh" if self._mesh_plan_used
                            else "device_plan_cuda" if self._cuda_plan_used
                            else "device_plan")
                    fused = self._finish_fused(flat, fused)
                    if fused is not None:
                        self._exec_path = path
                        return fused

        # 1. FROM
        if sel.from_ is not None:
            scope = Scope(self._execute_from(sel.from_))
        else:
            scope = _dummy_scope()

        # 1b. fused device path: aggregates over a single large numeric scan
        # (incl. infera_predict) run as kernel K2 or the torch program
        # (device_plan.py); ineligible plans fall through to the host
        # operators. A MATERIALIZED subquery/VALUES result is just a Table —
        # the fused plan serves the aggregate over it the same way.
        if isinstance(sel.from_, (A.BaseTable, A.TableFunction,
                                  A.SubqueryRef, A.ValuesRef)):
            from . import streaming_plan
            from .device_plan import try_execute_on_device

            fused, path = None, "streaming_plan"
            self._mesh_plan_used = False
            if scope.table.num_rows >= streaming_plan.STREAM_MIN_ROWS:
                # chunked fused aggregation: a fixed device footprint, exact
                # past the device plan's 2**24-row bound
                fused = streaming_plan.try_execute_streaming(self, sel, scope.table)
            if fused is None:
                fused = try_execute_on_device(self, sel, scope.table)
                if fused is not None:
                    path = "device_plan_cuda" if self._cuda_plan_used else "device_plan"
            if fused is not None and self._mesh_plan_used:
                path = path.replace("_cuda", "") + "_mesh"
            if fused is not None:
                fused = self._finish_fused(sel, fused)
                if fused is not None:
                    self._exec_path = path
                    return fused

        # 2. WHERE
        if sel.where is not None:
            mask_col = self._eval(sel.where, scope)
            mask = _as_bool_mask(mask_col)
            scope = Scope(scope.table.filter(mask))

        # 3. aggregate or plain projection
        has_agg = any(_contains_aggregate(item.expr) for item in sel.items) or bool(
            sel.group_by
        )
        if has_agg:
            out = self._execute_aggregate(sel, scope)
        else:
            out = self._project(sel.items, scope)
            if sel.distinct:
                out = _distinct(out)

        # 4. ORDER BY
        if sel.order_by:
            out = self._order_by(
                out, sel.order_by, scope if not has_agg else Scope(out),
                head=_head_rows(sel))

        # 5. LIMIT / OFFSET
        if sel.offset is not None or sel.limit is not None:
            start = sel.offset or 0
            stop = start + sel.limit if sel.limit is not None else out.num_rows
            out = out.slice(start, stop)
        return out

    def _execute_from(self, ref: A.TableRef) -> Table:
        if isinstance(ref, A.BaseTable):
            table = self.catalog.get(ref.name)
            alias = ref.alias or ref.name
            return _qualify(table, alias)
        if isinstance(ref, A.SubqueryRef):
            table = self._execute_query(ref.query)
            if ref.column_aliases:
                table = _rename_columns(table, ref.column_aliases)
            return _qualify(table, ref.alias) if ref.alias else table
        if isinstance(ref, A.ValuesRef):
            scope = _dummy_scope()
            col_vals: list = [[] for _ in range(len(ref.rows[0]))]
            for row in ref.rows:
                if len(row) != len(col_vals):
                    raise SqlError("Binder Error: VALUES rows have unequal lengths")
                for j, e in enumerate(row):
                    col_vals[j].append(self._eval(e, scope).value(0))
            cols = {}
            for j, vals in enumerate(col_vals):
                name = (ref.column_aliases[j] if ref.column_aliases and
                        j < len(ref.column_aliases) else f"col{j}")
                cols[name] = Column.from_values(vals, infer_sql_type(vals))
            table = Table(cols)
            return _qualify(table, ref.alias) if ref.alias else table
        if isinstance(ref, A.TableFunction):
            return self._table_function(ref)
        if isinstance(ref, A.Join):
            from ..ops.join import join_tables

            left = self._execute_from(ref.left)
            right = self._execute_from(ref.right)

            def _mark_device_join():
                self._exec_path = "device_join"

            return join_tables(
                left, right, ref.kind, ref.on, ref.using,
                eval_fn=self._eval, scope_cls=Scope,
                on_device_path=_mark_device_join,
            )
        raise SqlError(f"unsupported FROM clause {type(ref).__name__}")

    def _table_function(self, ref: A.TableFunction) -> Table:
        name = ref.name.lower()
        scope = _dummy_scope()
        args = [self._eval(a, scope).value(0) for a in ref.args]
        if name in ("range", "generate_series"):
            if len(args) == 1:
                lo, hi, step = 0, int(args[0]), 1
            elif len(args) == 2:
                lo, hi, step = int(args[0]), int(args[1]), 1
            else:
                lo, hi, step = int(args[0]), int(args[1]), int(args[2])
            if name == "generate_series":
                hi += 1  # inclusive upper bound
            data = np.arange(lo, hi, step, dtype=np.int64)
            col_name = ref.column_aliases[0] if ref.column_aliases else "range"
            t = Table({col_name: Column(data, T.BIGINT)})
            return _qualify(t, ref.alias) if ref.alias else t
        if name == "read_csv" or name == "read_csv_auto":
            from .csv_io import read_csv

            t = read_csv(str(args[0]))
            if ref.column_aliases:
                t = _rename_columns(t, ref.column_aliases)
            return _qualify(t, ref.alias) if ref.alias else t
        if name == "read_columnar":
            from ..columnar.diskfile import read_columnar

            try:
                t = read_columnar(str(args[0]))
            except (FileNotFoundError, OSError, ValueError, KeyError) as e:
                raise SqlError(f"IO Error: {e}")
            if ref.column_aliases:
                t = _rename_columns(t, ref.column_aliases)
            return _qualify(t, ref.alias) if ref.alias else t
        raise SqlError(f"Catalog Error: Table Function with name {ref.name} does not exist!")

    def _project(self, items: list, scope: Scope) -> Table:
        cols: dict = {}
        for idx, item in enumerate(items):
            if isinstance(item.expr, A.Star):
                for name, col in scope.table.columns.items():
                    if name == "__dummy__":
                        continue
                    if item.expr.table and not name.startswith(item.expr.table + "."):
                        continue
                    bare = name.split(".")[-1]
                    if "." in name and scope.table.columns.get(bare) is col:
                        continue  # alias.col duplicate of an emitted bare col
                    cols[bare if bare not in cols else name] = col
                continue
            name = item.alias or _expr_name(item.expr, idx)
            base, n = name, 1
            while name in cols:
                name = f"{base}_{n}"
                n += 1
            cols[name] = self._eval(item.expr, scope)
        return Table(cols)

    # -- aggregation ------------------------------------------------------

    def _execute_aggregate(self, sel: A.Select, scope: Scope) -> Table:
        from ..ops.aggregate import group_aggregate

        return group_aggregate(sel, scope, self._eval, Scope)

    def _order_by(self, out: Table, order_by: list, scope: Scope,
                  head: int | None = None) -> Table:
        """``head``: ORDER BY ... LIMIT k only needs the first
        offset+limit rows — the permutation truncates BEFORE the row
        gather, so a 1M-row top-10 gathers 10 rows instead of
        materializing the whole permuted table (VERDICT r4 item 4)."""
        from ..ops.sort import sort_rows

        out_scope = Scope(out)
        keys, asc, nf, valids = [], [], [], []
        for item in order_by:
            try:
                col = self._eval(item.expr, out_scope)
            except SqlError:
                col = self._eval(item.expr, scope)
            keys.append(col.data)
            asc.append(item.ascending)
            # DuckDB default: NULLS LAST for ASC, NULLS FIRST for DESC
            nf.append(item.nulls_first if item.nulls_first is not None
                      else not item.ascending)
            valids.append(col.validity)
        idx = sort_rows(keys, asc, nf, valids, out.num_rows, head=head)
        return out.take(idx)

    # -- expression evaluation -------------------------------------------

    def _eval(self, expr: A.Expr, scope: Scope) -> Column:
        n = scope.num_rows
        if isinstance(expr, A.Parameter):
            params = getattr(self, "_bound_params", None)
            if params is None or expr.index >= len(params):
                raise SqlError(
                    f"Binder Error: prepared statement parameter {expr.index + 1} "
                    f"was not bound (pass parameters=[...] to execute)")
            v = params[expr.index]
            if v is None:
                return Column.constant(None, T.SQLNULL, n)
            if isinstance(v, bool):
                return Column.constant(v, T.BOOLEAN, n)
            if isinstance(v, int):
                return Column.constant(v, T.BIGINT, n)
            if isinstance(v, float):
                return Column.constant(v, T.DOUBLE, n)
            return Column.constant(str(v), T.VARCHAR, n)
        if isinstance(expr, A.Literal):
            if expr.value is None:
                return Column.constant(None, T.SQLNULL, n)
            tname = expr.type_name or "VARCHAR"
            t = T.type_from_name(tname)
            return Column.constant(expr.value, t, n)
        if isinstance(expr, A.ColumnRef):
            try:
                return scope.lookup(expr.name, expr.table)
            except SqlError:
                # correlated subquery: unknown names resolve against the
                # enclosing rows' correlation bindings (innermost first)
                for corr in reversed(getattr(self, "_corr_stack", ())):
                    hit = corr.resolve(expr.name, expr.table)
                    if hit is not None:
                        v, t = hit
                        return Column.constant(
                            v, t if v is not None else T.SQLNULL, n)
                raise
        if isinstance(expr, A.InSubquery):
            return self._eval_in_subquery(expr, scope)
        if isinstance(expr, A.Exists):
            def _exists(tab):
                return tab.num_rows > 0

            kind, res = self._run_subquery(expr.query, scope, _exists)
            if kind == "const":
                return Column.constant(bool(res), T.BOOLEAN, n)
            return Column(np.asarray(res, bool), T.BOOLEAN)
        if isinstance(expr, A.Cast):
            return self._eval_cast(expr, scope)
        if isinstance(expr, A.Unary):
            return self._eval_unary(expr, scope)
        if isinstance(expr, A.Binary):
            return self._eval_binary(expr, scope)
        if isinstance(expr, A.IsNull):
            col = self._eval(expr.operand, scope)
            valid = col.valid_mask()
            res = valid if expr.negated else ~valid
            return Column(res.copy(), T.BOOLEAN)
        if isinstance(expr, A.InList):
            return self._eval_in(expr, scope)
        if isinstance(expr, A.Between):
            low = A.Binary(">=", expr.operand, expr.low)
            high = A.Binary("<=", expr.operand, expr.high)
            combined = A.Binary("AND", low, high)
            col = self._eval(combined, scope)
            if expr.negated:
                return self._eval(A.Unary("NOT", combined), scope)
            return col
        if isinstance(expr, A.Like):
            return self._eval_like(expr, scope)
        if isinstance(expr, A.Case):
            return self._eval_case(expr, scope)
        if isinstance(expr, A.ListExpr):
            item_cols = [self._eval(e, scope) for e in expr.items]
            data = np.empty(n, dtype=object)
            for i in range(n):
                data[i] = [c.value(i) for c in item_cols]
            return Column(data, T.LIST_FLOAT)
        if isinstance(expr, A.PositionIn):
            needle = self._eval(expr.needle, scope)
            hay = self._eval(expr.haystack, scope)
            from .functions import _map_rows

            return _map_rows([hay, needle], n,
                             lambda h, nd: str(h).find(str(nd)) + 1, T.BIGINT)
        if isinstance(expr, A.WindowFunc):
            from ..ops.window import eval_window

            return eval_window(expr, scope, self._eval)
        if isinstance(expr, A.FuncCall):
            return self._eval_func(expr, scope)
        if isinstance(expr, A.Star):
            raise SqlError("Binder Error: * not allowed here")
        raise SqlError(f"unsupported expression {type(expr).__name__}")

    def _eval_cast(self, expr: A.Cast, scope: Scope) -> Column:
        col = self._eval(expr.operand, scope)
        tname = expr.type_name.upper()
        if tname == "BLOB":
            data = np.empty(len(col), dtype=object)
            validity = col.valid_mask().copy()
            for i in range(len(col)):
                if not validity[i]:
                    continue
                v = col.value(i)
                if isinstance(v, (bytes, bytearray)):
                    data[i] = bytes(v)
                else:
                    data[i] = _str_to_blob(str(v))
            return Column(data, T.BLOB, None if validity.all() else validity)
        target = T.type_from_name(tname, expr.width, expr.scale)
        return col.cast(target)

    def _eval_unary(self, expr: A.Unary, scope: Scope) -> Column:
        col = self._eval(expr.operand, scope)
        if expr.op == "-":
            return Column(-col.data, col.sql_type if col.sql_type.is_numeric else T.DOUBLE, col.validity)
        if expr.op == "NOT":
            data = col.data.astype(bool)
            return Column(~data, T.BOOLEAN, col.validity)
        raise SqlError(f"unsupported unary op {expr.op}")

    def _eval_binary(self, expr: A.Binary, scope: Scope) -> Column:
        op = expr.op
        if op in ("AND", "OR"):
            left = self._eval(expr.left, scope)
            right = self._eval(expr.right, scope)
            lv = left.data.astype(bool)
            rv = right.data.astype(bool)
            lvalid = left.valid_mask()
            rvalid = right.valid_mask()
            if op == "AND":
                data = lv & rv
                # 3VL: NULL AND false = false; NULL AND true = NULL
                valid = (lvalid & rvalid) | (lvalid & ~lv) | (rvalid & ~rv)
                data = np.where(valid, data & np.where(lvalid, lv, True) & np.where(rvalid, rv, True), False)
            else:
                data = lv | rv
                valid = (lvalid & rvalid) | (lvalid & lv) | (rvalid & rv)
                data = np.where(valid, np.where(lvalid, lv, False) | np.where(rvalid, rv, False), False)
            return Column(data, T.BOOLEAN, None if valid.all() else valid)

        left = self._eval(expr.left, scope)
        right = self._eval(expr.right, scope)

        if op == "||":
            from .functions import _map_rows

            return _map_rows([left, right], scope.num_rows,
                             lambda a, b: str(a) + str(b), T.VARCHAR)

        # list / string comparisons take the host path
        host_types = ("VARCHAR", "BLOB", "LIST_FLOAT")
        if (left.sql_type.name in host_types or right.sql_type.name in host_types) and op in (
            "=", "<>", "<", "<=", ">", ">="
        ):
            return _host_compare(op, left, right)

        lt, rt = left.sql_type, right.sql_type
        if not (lt.is_numeric or lt.name == "NULL") or not (rt.is_numeric or rt.name == "NULL"):
            raise SqlError(f"Binder Error: cannot apply {op} to {lt} and {rt}")

        valid = left.valid_mask() & right.valid_mask()
        all_valid = bool(valid.all())
        if op in ("=", "<>", "<", "<=", ">", ">="):
            a = left.data.astype(np.float64)
            b = right.data.astype(np.float64)
            fn = {
                "=": np.equal, "<>": np.not_equal, "<": np.less,
                "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
            }[op]
            return Column(fn(a, b), T.BOOLEAN, None if all_valid else valid)
        out_type = T.common_numeric_type(lt if lt.is_numeric else T.INTEGER,
                                         rt if rt.is_numeric else T.INTEGER)
        if op == "/":
            out_type = T.DOUBLE if out_type.name not in ("FLOAT",) else T.FLOAT
            a = left.data.astype(np.float64)
            b = right.data.astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                data = a / b
            return Column(data.astype(out_type.np_dtype), out_type, None if all_valid else valid)
        a = left.data.astype(out_type.np_dtype)
        b = right.data.astype(out_type.np_dtype)
        if op == "+":
            data = a + b
        elif op == "-":
            data = a - b
        elif op == "*":
            data = a * b
        elif op == "%":
            with np.errstate(divide="ignore", invalid="ignore"):
                data = np.mod(a, b)
        else:
            raise SqlError(f"unsupported binary op {op}")
        return Column(data, out_type, None if all_valid else valid)

    def _eval_in(self, expr: A.InList, scope: Scope) -> Column:
        col = self._eval(expr.operand, scope)
        item_cols = [self._eval(e, scope) for e in expr.items]
        n = scope.num_rows
        data = np.zeros(n, dtype=bool)
        valid = col.valid_mask().copy()
        for i in range(n):
            if not valid[i]:
                continue
            v = col.value(i)
            data[i] = any(c.value(i) == v for c in item_cols)
        if expr.negated:
            data = ~data
        return Column(data, T.BOOLEAN, None if valid.all() else valid)

    def _eval_like(self, expr: A.Like, scope: Scope) -> Column:
        col = self._eval(expr.operand, scope)
        pat_col = self._eval(expr.pattern, scope)
        n = scope.num_rows
        data = np.zeros(n, dtype=bool)
        valid = col.valid_mask() & pat_col.valid_mask()
        rx_cache: dict = {}
        for i in range(n):
            if not valid[i]:
                continue
            pat = str(pat_col.value(i))
            rx = rx_cache.get(pat)
            if rx is None:
                rx = re.compile(
                    "^" + re.escape(pat).replace("%", ".*").replace("_", ".") + "$",
                    re.DOTALL,
                )
                rx_cache[pat] = rx
            data[i] = rx.match(str(col.value(i))) is not None
        if expr.negated:
            data = ~data
        return Column(data, T.BOOLEAN, None if valid.all() else valid)

    def _eval_case(self, expr: A.Case, scope: Scope) -> Column:
        n = scope.num_rows
        results: list = [None] * n
        decided = np.zeros(n, dtype=bool)
        for cond_e, res_e in expr.whens:
            if expr.operand is not None:
                cond_e = A.Binary("=", expr.operand, cond_e)
            cond = self._eval(cond_e, scope)
            res = self._eval(res_e, scope)
            for i in range(n):
                if not decided[i] and not cond.is_null(i) and cond.value(i):
                    results[i] = res.value(i)
                    decided[i] = True
        if expr.else_ is not None:
            res = self._eval(expr.else_, scope)
            for i in range(n):
                if not decided[i]:
                    results[i] = res.value(i)
        return Column.from_values(results, infer_sql_type(results))

    def _execute_grouping_sets(self, sel: A.Select) -> Table:
        """ROLLUP / CUBE / GROUPING SETS as a UNION ALL of per-set grouped
        selects: each branch groups by its key subset, select items that
        are group keys OUTSIDE the subset render NULL (with the original
        output name), and a hidden count(*) keeps every branch on the
        aggregate path so key-only selects still yield one row per group
        (and exactly one row for the () grand-total set). ORDER BY / LIMIT
        apply after the union."""
        import copy as _copy

        all_keys = sel.group_by
        branches = []
        for gs in sel.group_sets:
            sub = _copy.copy(sel)
            sub.group_sets = None
            sub.group_by = list(gs)
            sub.order_by = []
            sub.limit = None
            sub.offset = None
            items = []
            for idx, it in enumerate(sel.items):
                name = it.alias or _expr_name(it.expr, idx)
                if it.expr in all_keys and it.expr not in gs:
                    items.append(A.SelectItem(A.Literal(None), name))
                else:
                    items.append(A.SelectItem(it.expr, name))
            items.append(A.SelectItem(
                A.FuncCall("count", [], is_star=True), "__gs_hidden__"))
            sub.items = items
            branches.append(sub)
        node = branches[0]
        for nxt in branches[1:]:
            node = A.SetOp(left=node, right=nxt, kind="UNION", all=True)
        out = self._execute_query(node) if isinstance(node, A.SetOp) \
            else self._execute_select(node)
        out = Table({k: c for k, c in out.columns.items()
                     if k != "__gs_hidden__"})
        if sel.order_by:
            out = self._order_by(out, sel.order_by, Scope(out))
        if sel.offset is not None or sel.limit is not None:
            start = sel.offset or 0
            stop = (start + sel.limit if sel.limit is not None
                    else out.num_rows)
            out = out.slice(start, stop)
        return out

    def _run_subquery(self, q, scope: Scope, collect):
        """Execute a subquery, decorrelating lazily: the uncorrelated fast
        path runs ONCE; if binding fails on an unknown column, the query is
        re-run per outer row with a correlation frame that resolves outer
        names to that row's scalars (nested-loop semantics — correct for
        any correlation shape, O(outer_rows) subquery executions).
        Returns ("const", collect(result)) or ("per_row", [collect(...)])."""
        try:
            return "const", collect(self._execute_select(q))
        except SqlError as e:
            if "Referenced column" not in str(e):
                raise
        dec = self._try_decorrelate_grouped(q, scope, collect)
        if dec is not None:
            return "per_row", dec
        stack = getattr(self, "_corr_stack", None)
        if stack is None:
            stack = []
            self._corr_stack = stack
        vals = []
        # memoize on the tuple of outer values the subquery actually read.
        # `used` is the UNION of correlated refs across all executed rows
        # (round-4 fix: keying on row 0's used-set alone let e.g.
        # CASE WHEN o.a>0 THEN o.b ELSE o.c END cache-hit on (a,b) for a
        # row whose result depends on c); whenever a row reads a ref not
        # seen before the cache is invalidated, since its keys were built
        # under the narrower schema. Duplicate outer tuples reuse one
        # execution — O(distinct) instead of O(rows).
        used: list = []
        cache: dict = {}

        def key_for(row):
            try:
                return tuple(
                    self._corr_key(scope, nm, q_, row) for nm, q_ in used)
            except TypeError:
                return None

        for i in range(scope.num_rows):
            key = key_for(i) if used else None
            if key is not None and key in cache:
                vals.append(cache[key])
                continue
            corr = _RowCorrelation(scope, i)
            stack.append(corr)
            try:
                v = collect(self._execute_select(q))
            finally:
                stack.pop()
            vals.append(v)
            new_refs = [u for u in corr.used if u not in used]
            if new_refs:
                used = used + new_refs
                cache.clear()
                key = key_for(i)
            if key is not None and used:
                cache[key] = v
        return "per_row", vals

    def _corr_key(self, scope, name, qualifier, row):
        v = scope.lookup(name, qualifier).value(row)
        hash(v)
        return v

    def _try_decorrelate_grouped(self, q, scope: Scope, collect):
        """Set-based decorrelation (round 5, VERDICT r4 weak item): an
        equality-correlated AGGREGATE subquery

            (SELECT agg(...) FROM t i WHERE i.k = o.k AND residual)

        executes ONCE as ``SELECT k, agg(...) FROM t WHERE residual GROUP
        BY k`` (device-plan eligible!) plus one aggregate-over-empty
        execution for unmatched outer keys, replacing the memoized
        O(distinct outer keys x subquery cost) nested loop. Returns the
        per-outer-row collect() values, or None when the shape doesn't
        decorrelate (nested-loop fallback keeps full semantics)."""
        import dataclasses

        if not isinstance(q, A.Select) or not isinstance(
                q.from_, (A.BaseTable, A.TableFunction)):
            return None
        if (q.group_by or q.having is not None or q.distinct or q.order_by
                or q.limit is not None or q.offset is not None
                or getattr(q, "group_sets", None)):
            return None
        if not q.items or not all(
                not isinstance(i.expr, A.Star)
                and _contains_aggregate(i.expr) for i in q.items):
            return None
        try:
            inner_scope = Scope(self._execute_from(q.from_))
        except SqlError:
            return None

        def binds(sc, ref):
            try:
                sc.lookup(ref.name, ref.table)
                return True
            except SqlError:
                return False

        def walk_refs(e, out):
            if isinstance(e, A.ColumnRef):
                out.append(e)
                return
            if isinstance(e, (A.InSubquery, A.Exists, A.Select)):
                raise _DecorrelateBail()  # nested subqueries: nested loop
            if not dataclasses.is_dataclass(e):
                return
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, (A.Expr, A.Select)):
                    walk_refs(v, out)
                elif isinstance(v, list):
                    for x in v:
                        if isinstance(x, (A.Expr, A.Select)):
                            walk_refs(x, out)
                        elif isinstance(x, A.OrderItem):
                            walk_refs(x.expr, out)

        def conjuncts(e):
            if isinstance(e, A.Binary) and e.op == "AND":
                return conjuncts(e.left) + conjuncts(e.right)
            return [e]

        keys: list = []      # (inner key expr, outer ref)
        residual: list = []
        try:
            for cj in (conjuncts(q.where) if q.where is not None else []):
                matched = False
                if isinstance(cj, A.Binary) and cj.op == "=" \
                        and isinstance(cj.left, A.ColumnRef) \
                        and isinstance(cj.right, A.ColumnRef):
                    for ir, onr in ((cj.left, cj.right),
                                    (cj.right, cj.left)):
                        if binds(inner_scope, ir) \
                                and not binds(inner_scope, onr) \
                                and binds(scope, onr):
                            keys.append((ir, onr))
                            matched = True
                            break
                if not matched:
                    residual.append(cj)
            if not keys or len(keys) > 4:
                return None
            # residual WHERE and every item must reference inner names only
            refs: list = []
            for e in [i.expr for i in q.items] + residual:
                walk_refs(e, refs)
            if any(not binds(inner_scope, r) for r in refs):
                return None
        except _DecorrelateBail:
            return None

        where = None
        for cj in residual:
            where = cj if where is None else A.Binary("AND", where, cj)
        gitems = [A.SelectItem(ke, f"__corr_k{i}")
                  for i, (ke, _o) in enumerate(keys)] + list(q.items)
        grouped = A.Select(items=gitems, from_=q.from_, where=where,
                           group_by=[ke for ke, _o in keys])
        empty_q = A.Select(items=list(q.items), from_=q.from_,
                           where=A.Literal(False))
        try:
            gt = self._execute_select(grouped)
            empty_t = self._execute_select(empty_q)
        except SqlError:
            return None
        nk = len(keys)
        val_names = gt.names[nk:]
        if len(val_names) != len(q.items):
            return None

        def canon(v):
            if v is None or isinstance(v, bool):
                return v
            if isinstance(v, (int, np.integer)):
                return float(v) if abs(int(v)) <= (1 << 53) else int(v)
            if isinstance(v, (float, np.floating)):
                return float(v)
            return v

        kcols = [gt.columns[n] for n in gt.names[:nk]]
        outer_cols = [scope.lookup(onr.name, onr.table)
                      for _ke, onr in keys]
        empty_val = collect(empty_t)

        def group_val(j):
            idx = np.asarray([j], np.int64)
            return collect(Table(
                {n: gt.columns[n].take(idx) for n in val_names}))

        # vectorized outer-row → group-row mapping for numeric keys (the
        # common case): one np join over f64-canonical key matrices
        # instead of a per-row tuple/dict loop
        num_ok = all(
            c.data.dtype.kind in "iufb" for c in kcols + outer_cols)
        if num_ok:
            for c in kcols + outer_cols:
                d = c.data
                if d.dtype.kind in "iu" and d.size and \
                        np.abs(d.astype(np.int64)).max() > (1 << 53):
                    num_ok = False  # f64 canon would collapse big ints
                    break
        if num_ok:
            gmat = np.column_stack(
                [c.data.astype(np.float64) for c in kcols])
            gvalid = np.ones(gt.num_rows, bool)
            for c in kcols:
                gvalid &= c.valid_mask()
            omat = np.column_stack(
                [c.data.astype(np.float64) for c in outer_cols])
            ovalid = np.ones(scope.num_rows, bool)
            for c in outer_cols:
                ovalid &= c.valid_mask()
            both = np.concatenate([gmat, omat])
            if nk == 1:
                _u, inv = np.unique(both[:, 0], return_inverse=True)
            else:
                _u, inv = np.unique(both, axis=0, return_inverse=True)
            ginv, oinv = inv[: gt.num_rows], inv[gt.num_rows:]
            uid_to_j = np.full(int(inv.max()) + 1 if inv.size else 1, -1,
                               np.int64)
            uid_to_j[ginv[gvalid]] = np.flatnonzero(gvalid)
            j_per_row = np.where(ovalid, uid_to_j[oinv], -1)
            cache: dict = {}
            vals = []
            for j in j_per_row:
                if j < 0:
                    vals.append(empty_val)
                    continue
                got = cache.get(int(j))
                if got is None:
                    got = group_val(int(j))
                    cache[int(j)] = got
                vals.append(got)
            return vals

        lookup: dict = {}
        for j in range(gt.num_rows):
            kv = tuple(canon(kc.value(j)) for kc in kcols)
            if any(v is None for v in kv):
                continue  # '=' never matches NULL keys
            lookup[kv] = j
        row_tables: dict = {}
        vals = []
        for i in range(scope.num_rows):
            kv = tuple(canon(c.value(i)) for c in outer_cols)
            j = lookup.get(kv) if all(v is not None for v in kv) else None
            if j is None:
                vals.append(empty_val)
                continue
            got = row_tables.get(j)
            if got is None:
                got = group_val(j)
                row_tables[j] = got
            vals.append(got)
        return vals

    def _eval_in_subquery(self, expr: A.InSubquery, scope: Scope) -> Column:
        """x [NOT] IN (SELECT ...) with SQL three-valued logic: NULL
        operand → NULL; no match but the subquery produced NULLs → NULL."""
        operand = self._eval(expr.operand, scope)

        def _value_set(tab):
            if len(tab.columns) != 1:
                raise SqlError(
                    "Binder Error: subquery in IN must return one column")
            c = next(iter(tab.columns.values()))
            vals, has_null = set(), False
            for i in range(tab.num_rows):
                v = c.value(i)
                if v is None:
                    has_null = True
                else:
                    vals.add(v)
            return vals, has_null

        kind, res = self._run_subquery(expr.query, scope, _value_set)
        n = scope.num_rows
        out = np.zeros(n, bool)
        valid = operand.valid_mask().copy()
        if (kind == "const" and operand.data.dtype != object
                and all(isinstance(v, (int, float, np.integer, np.floating))
                        and not isinstance(v, bool) for v in res[0])):
            # vectorized membership for the common numeric uncorrelated case
            vals, has_null = res
            out = np.isin(operand.data.astype(np.float64),
                          np.asarray(sorted(vals), np.float64)) & valid
            if has_null:
                valid &= out  # non-members become NULL, members stay TRUE
        else:
            for i in range(n):
                if not valid[i]:
                    continue
                vals, has_null = res if kind == "const" else res[i]
                if operand.value(i) in vals:
                    out[i] = True
                elif has_null:
                    valid[i] = False
        if expr.negated:
            out = ~out
        return Column(out, T.BOOLEAN,
                      None if valid.all() else valid)

    def _eval_func(self, expr: A.FuncCall, scope: Scope) -> Column:
        name = expr.name.lower()
        if name in self._macros:
            params, body = self._macros[name]
            if len(params) != len(expr.args):
                raise SqlError(
                    f"Binder Error: Macro function '{expr.name}' requires "
                    f"{len(params)} positional arguments, but "
                    f"{len(expr.args)} positional arguments were provided.")
            bindings = {p.lower(): a for p, a in zip(params, expr.args)}
            return self._eval(_substitute_macro(body, bindings), scope)
        if name == "__scalar_subquery__":
            def _first(sub):
                v = sub.row(0)[0] if sub.num_rows > 0 else None
                t = (next(iter(sub.columns.values())).sql_type
                     if sub.columns else T.SQLNULL)
                return v, t
            kind, res = self._run_subquery(expr.args[0], scope, _first)
            if kind == "const":
                v, t = res
                return Column.constant(
                    v, t if v is not None else T.SQLNULL, scope.num_rows)
            vals = [v for v, _t in res]
            return Column.from_values(vals, infer_sql_type(vals))
        entry = SCALAR_FUNCTIONS.get(name)
        if entry is None:
            raise SqlError(
                f"Catalog Error: Scalar Function with name {expr.name} does not exist!"
            )
        fn, _volatile = entry
        args = [self._eval(a, scope) for a in expr.args]
        return fn(self, args, scope.num_rows)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _substitute_macro(expr, bindings: dict):
    """Clone a macro body with parameter references replaced by the call's
    argument expressions (textual-substitution semantics, like DuckDB)."""
    import dataclasses

    if isinstance(expr, A.ColumnRef) and expr.table is None \
            and expr.name.lower() in bindings:
        return bindings[expr.name.lower()]
    if not dataclasses.is_dataclass(expr):
        return expr
    kwargs = {}
    for f in dataclasses.fields(expr):
        v = getattr(expr, f.name)
        if isinstance(v, A.Expr):
            kwargs[f.name] = _substitute_macro(v, bindings)
        elif isinstance(v, list):
            kwargs[f.name] = [
                _substitute_macro(i, bindings) if isinstance(i, A.Expr) else i
                for i in v]
        else:
            kwargs[f.name] = v
    return type(expr)(**kwargs)


def _str_to_blob(s: str) -> bytes:
    """VARCHAR → BLOB cast with DuckDB-style ``\\xHH`` escapes."""
    if "\\x" not in s:
        return s.encode("utf-8")
    out = bytearray()
    i = 0
    while i < len(s):
        if s[i] == "\\" and i + 3 < len(s) + 1 and s[i + 1] in "xX" and i + 3 < len(s) + 1:
            hex_part = s[i + 2 : i + 4]
            if len(hex_part) == 2 and all(c in "0123456789abcdefABCDEF" for c in hex_part):
                out.append(int(hex_part, 16))
                i += 4
                continue
        out.extend(s[i].encode("utf-8"))
        i += 1
    return bytes(out)


def _as_bool_mask(col: Column) -> np.ndarray:
    mask = col.data.astype(bool)
    return mask & col.valid_mask()


def _rename_columns(table: Table, names: list) -> Table:
    cols = {}
    for i, (old, col) in enumerate(table.columns.items()):
        cols[names[i] if i < len(names) else old] = col
    return Table(cols)


def _qualify(table: Table, alias: str) -> Table:
    """Store each column under both its bare name and alias.col."""
    cols = {}
    for name, col in table.columns.items():
        bare = name.split(".")[-1]
        cols[bare] = col
        cols[f"{alias}.{bare}"] = col
    return Table(cols)


def _head_rows(sel) -> int | None:
    """offset+limit when a LIMIT bounds the output, else None — the sort
    permutation can truncate to this many rows before the gather."""
    if getattr(sel, "limit", None) is None:
        return None
    return (sel.offset or 0) + sel.limit


# row-count above which DISTINCT / set ops take the vectorized row-code
# path (below it the tuple loop's constant factor wins)
_ROWCODE_MIN_ROWS = 2048


def _row_codes(tables: list):
    """int64 row ids over the concatenated rows of column-aligned tables:
    equal rows (SQL semantics — NULLs equal, numerics by value) get equal
    ids, fully vectorized (VERDICT r4 item 4).

    Per column: integer values code directly (offset from min), floats
    bitcast to int64 after -0.0 normalization (equality-exact, zero
    sorts), strings/objects fall back to one np.unique; columns with NULLs
    add a validity matrix column (NULLs equal each other, never a value).
    When every column's code range is known and their product fits int64,
    the columns mixed-radix-pack into ONE id per row with no sort at all;
    otherwise one np.unique(axis=0) over the code matrix assigns ids.
    Returns (row_ids, row_counts) or None when a column mix defeats the
    encoding (caller keeps the tuple loop)."""
    counts = [t.num_rows for t in tables]
    n = sum(counts)
    col_lists = [list(t.columns.values()) for t in tables]
    ncols = len(col_lists[0])
    if n == 0 or ncols == 0:
        return np.zeros(n, np.int64), counts
    mat_cols: list = []
    ranges: list = []  # per mat col: exclusive code range or None
    for j in range(ncols):
        arrs = [np.asarray(cl[j].data) for cl in col_lists]
        kinds = {a.dtype.kind for a in arrs}
        valid = np.concatenate([cl[j].valid_mask() for cl in col_lists])
        all_valid = bool(valid.all())
        try:
            if kinds <= set("iub"):
                vals = np.concatenate([a.astype(np.int64) for a in arrs])
                vmin = int(vals.min())
                code = vals - vmin
                rng = int(vals.max()) - vmin + 1
            elif kinds <= set("f"):
                vals = np.concatenate(
                    [a.astype(np.float64) for a in arrs]) + 0.0
                code = vals.view(np.int64).copy()
                # tuple-loop parity: NaN != NaN, so every NaN row gets a
                # UNIQUE code (bitcast would collapse equal payloads —
                # round-5 review fix)
                nanm = np.isnan(vals)
                if nanm.any():
                    code[nanm] = -(1 << 62) - np.flatnonzero(nanm)
                rng = None  # bitcast codes span int64
            elif kinds <= set("fiub"):
                # mixed int/float: value equality via f64 — exact only
                # while the ints fit f64's 2^53 integer range
                ints = np.concatenate(
                    [a.astype(np.int64) for a in arrs
                     if a.dtype.kind in "iub"] or [np.zeros(0, np.int64)])
                if ints.size and (np.abs(ints) > (1 << 53)).any():
                    return None
                vals = np.concatenate(
                    [a.astype(np.float64) for a in arrs]) + 0.0
                code = vals.view(np.int64).copy()
                nanm = np.isnan(vals)
                if nanm.any():
                    code[nanm] = -(1 << 62) - np.flatnonzero(nanm)
                rng = None
            else:
                vals = np.concatenate([a for a in arrs])
                _, inv = np.unique(vals, return_inverse=True)
                code = inv.astype(np.int64)
                rng = int(code.max()) + 1 if n else 1
        except (TypeError, ValueError):
            return None
        if not all_valid:
            code = np.where(valid, code, 0)
            mat_cols.append(valid.astype(np.int64))
            ranges.append(2)
        mat_cols.append(code)
        ranges.append(rng)
    if len(mat_cols) == 1:
        return mat_cols[0], counts
    if all(r is not None for r in ranges):
        prod = 1
        for r in ranges:
            prod *= max(r, 1)
        if prod < (1 << 62):
            packed = np.zeros(n, np.int64)
            stride = 1
            for code, r in zip(reversed(mat_cols), reversed(ranges)):
                packed += code * stride
                stride *= max(r, 1)
            return packed, counts
    # mix the code columns into one 64-bit id and VERIFY exactness: equal
    # rows hash equal by construction, and any unequal rows sharing a hash
    # are caught by comparing every row to its hash-group representative
    # (then the slow void-record unique decides). One uint64 sort instead
    # of the [n, C] void-dtype argsorts np.unique(axis=0) pays.
    h = np.zeros(n, np.uint64)
    for code in mat_cols:
        h = (h ^ code.view(np.uint64)) * np.uint64(0x9E3779B97F4A7C15)
        h ^= h >> np.uint64(29)
    _, first, row_inv = np.unique(h, return_index=True,
                                  return_inverse=True)
    rep = first[row_inv]
    exact = True
    for code in mat_cols:
        if not np.array_equal(code, code[rep]):
            exact = False
            break
    if exact:
        return row_inv.astype(np.int64), counts
    _, row_inv = np.unique(np.column_stack(mat_cols), axis=0,
                           return_inverse=True)
    return row_inv.astype(np.int64), counts


def _distinct(table: Table) -> Table:
    if table.num_rows >= _ROWCODE_MIN_ROWS:
        rc = _row_codes([table])
        if rc is not None:
            ids, _ = rc
            _, first = np.unique(ids, return_index=True)
            return table.take(np.sort(first).astype(np.int64))
    seen = set()
    keep = []
    for i in range(table.num_rows):
        key = table.row(i)
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return table.take(np.asarray(keep, dtype=np.int64))


def _host_compare(op: str, left: Column, right: Column) -> Column:
    n = len(left)
    data = np.zeros(n, dtype=bool)
    valid = left.valid_mask() & right.valid_mask()
    for i in range(n):
        if not valid[i]:
            continue
        a, b = left.value(i), right.value(i)
        if isinstance(a, list) or isinstance(b, list):
            a_l = [float(x) for x in a] if isinstance(a, (list, tuple)) else a
            b_l = [float(x) for x in b] if isinstance(b, (list, tuple)) else b
            eq = a_l == b_l
            data[i] = eq if op == "=" else (not eq if op == "<>" else False)
            continue
        if isinstance(a, (bytes, bytearray)) or isinstance(b, (bytes, bytearray)):
            pass
        else:
            a, b = str(a), str(b)
        data[i] = {
            "=": a == b, "<>": a != b, "<": a < b,
            "<=": a <= b, ">": a > b, ">=": a >= b,
        }[op]
    return Column(data, T.BOOLEAN, None if valid.all() else valid)


def _contains_aggregate(expr: A.Expr) -> bool:
    if isinstance(expr, A.FuncCall):
        if expr.name.lower() in AGGREGATE_FUNCTIONS:
            return True
        return any(_contains_aggregate(a) for a in expr.args if isinstance(a, A.Expr))
    for attr in ("operand", "left", "right", "low", "high", "pattern", "needle", "haystack"):
        child = getattr(expr, attr, None)
        if isinstance(child, A.Expr) and _contains_aggregate(child):
            return True
    if isinstance(expr, A.Case):
        for c, r in expr.whens:
            if _contains_aggregate(c) or _contains_aggregate(r):
                return True
        if expr.else_ is not None and _contains_aggregate(expr.else_):
            return True
    if isinstance(expr, A.ListExpr):
        return any(_contains_aggregate(e) for e in expr.items)
    return False


def _expr_name(expr: A.Expr, idx: int) -> str:
    if isinstance(expr, A.ColumnRef):
        return expr.name
    if isinstance(expr, A.FuncCall):
        return expr.name
    if isinstance(expr, A.Cast):
        return _expr_name(expr.operand, idx)
    return f"col{idx}"


class _RowCorrelation:
    """One outer row's name bindings for correlated-subquery execution.
    Records which names resolved (``used``) so _run_subquery can memoize
    on the outer value tuple."""

    def __init__(self, scope: Scope, row: int):
        self.scope = scope
        self.row = row
        self.used: list = []

    def resolve(self, name: str, qualifier):
        try:
            col = self.scope.lookup(name, qualifier)
        except SqlError:
            return None
        if (name, qualifier) not in self.used:
            self.used.append((name, qualifier))
        return col.value(self.row), col.sql_type
