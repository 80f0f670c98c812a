"""Hash join operator.

Host half of ``infera_tpu/ops/join.py``: dict-based build/probe. The
device sort-join for large numeric keys comes with the port's join tier.
"""

from __future__ import annotations

import numpy as np

from ..columnar import Column, Table
from ..errors import SqlError
from ..sql import ast as A


def _bare(name: str) -> str:
    return name.split(".")[-1]


def _equi_keys(on: A.Expr, left_names: set, right_names: set) -> list | None:
    """Extract equi-join key pairs [(left_expr, right_expr)] from an ON
    conjunction of equality comparisons; None if not a pure equi-join."""
    pairs = []

    def walk(e: A.Expr) -> bool:
        if isinstance(e, A.Binary) and e.op == "AND":
            return walk(e.left) and walk(e.right)
        if isinstance(e, A.Binary) and e.op == "=":
            sides = []
            for sub in (e.left, e.right):
                if isinstance(sub, A.ColumnRef):
                    q = f"{sub.table}.{sub.name}" if sub.table else sub.name
                    sides.append(q)
                else:
                    return False
            l, r = sides

            def belongs(name, names):
                return name in names or _bare(name) in {_bare(n) for n in names}

            # exact qualified membership decides first: the bare-name
            # fallback alone would misassign sides whenever the key's bare
            # name exists on BOTH tables (e.g. `odim RIGHT JOIN ofact ON
            # ofact.k = odim.k` bound ofact.k to the left scope — round-5
            # fix, found extending the pallas join tier)
            if l in left_names and r in right_names:
                pairs.append((e.left, e.right))
                return True
            if r in left_names and l in right_names:
                pairs.append((e.right, e.left))
                return True
            if belongs(l, left_names) and belongs(r, right_names):
                pairs.append((e.left, e.right))
                return True
            if belongs(r, left_names) and belongs(l, right_names):
                pairs.append((e.right, e.left))
                return True
            return False
        return False

    if on is not None and walk(on):
        return pairs
    return None


def join_tables(left: Table, right: Table, kind: str, on, using,
                eval_fn, scope_cls) -> Table:
    """Join two (already qualified) tables."""
    if kind == "CROSS" and on is None and using is None:
        li = np.repeat(np.arange(left.num_rows), right.num_rows)
        ri = np.tile(np.arange(right.num_rows), left.num_rows)
        return _combine(left, right, li, ri, None)

    if using:
        on = None
        lscope = scope_cls(left)
        rscope = scope_cls(right)
        lkeys = [eval_fn(A.ColumnRef(c), lscope) for c in using]
        rkeys = [eval_fn(A.ColumnRef(c), rscope) for c in using]
        return _hash_join(left, right, lkeys, rkeys, kind, None, eval_fn,
                          scope_cls)

    left_names = set(left.columns.keys())
    right_names = set(right.columns.keys())
    pairs = _equi_keys(on, left_names, right_names) if on is not None else None
    if pairs:
        lscope = scope_cls(left)
        rscope = scope_cls(right)
        lkeys = [eval_fn(le, lscope) for le, re_ in pairs]
        rkeys = [eval_fn(re_, rscope) for le, re_ in pairs]
        return _hash_join(left, right, lkeys, rkeys, kind, None, eval_fn,
                          scope_cls)

    # general theta join: nested-loop over the cross product
    li = np.repeat(np.arange(left.num_rows), right.num_rows)
    ri = np.tile(np.arange(right.num_rows), left.num_rows)
    combined = _combine(left, right, li, ri, None)
    if on is not None:
        cond = eval_fn(on, scope_cls(combined))
        mask = cond.data.astype(bool) & cond.valid_mask()
        if kind == "INNER" or kind == "CROSS":
            keep = np.flatnonzero(mask)
            return combined.take(keep)
        if kind == "LEFT":
            matched_left = np.zeros(left.num_rows, dtype=bool)
            matched_left[li[mask]] = True
            keep = np.flatnonzero(mask)
            extra = np.flatnonzero(~matched_left)
            return _append_outer(left, right, combined.take(keep), extra, side="left")
        raise SqlError(f"unsupported non-equi {kind} JOIN")
    return combined


def _hash_join(left: Table, right: Table, lkeys: list, rkeys: list,
               kind: str, residual, eval_fn, scope_cls) -> Table:
    n_left = left.num_rows
    n_right = right.num_rows

    # build on the smaller side (mirror standard hash-join practice)
    build_right = n_right <= n_left
    build_tbl, probe_tbl = (right, left) if build_right else (left, right)
    build_keys, probe_keys = (rkeys, lkeys) if build_right else (lkeys, rkeys)

    table: dict = {}
    for i in range(build_tbl.num_rows):
        key = tuple(k.value(i) for k in build_keys)
        if any(v is None for v in key):
            continue  # SQL equality never matches NULL
        table.setdefault(key, []).append(i)

    li_out: list = []
    ri_out: list = []
    probe_matched = np.zeros(probe_tbl.num_rows, dtype=bool)
    build_matched = np.zeros(build_tbl.num_rows, dtype=bool)
    for i in range(probe_tbl.num_rows):
        key = tuple(k.value(i) for k in probe_keys)
        if any(v is None for v in key):
            continue
        for j in table.get(key, ()):
            probe_matched[i] = True
            build_matched[j] = True
            if build_right:
                li_out.append(i)
                ri_out.append(j)
            else:
                li_out.append(j)
                ri_out.append(i)

    li = np.asarray(li_out, dtype=np.int64)
    ri = np.asarray(ri_out, dtype=np.int64)
    out = _combine(left, right, li, ri, None)

    if kind == "INNER":
        return out
    if kind == "LEFT":
        unmatched = np.flatnonzero(~(probe_matched if build_right else build_matched))
        return _append_outer(left, right, out, unmatched, side="left")
    if kind == "RIGHT":
        unmatched = np.flatnonzero(~(build_matched if build_right else probe_matched))
        return _append_outer(left, right, out, unmatched, side="right")
    if kind == "FULL":
        lu = np.flatnonzero(~(probe_matched if build_right else build_matched))
        out = _append_outer(left, right, out, lu, side="left")
        ru = np.flatnonzero(~(build_matched if build_right else probe_matched))
        return _append_outer(left, right, out, ru, side="right")
    raise SqlError(f"unsupported join kind {kind}")


def _take_nullable(col: Column, idx: np.ndarray, nullmask, has_null: bool):
    """col.take with -1 treated as NULL (outer-join marker rows)."""
    if not has_null:
        return col.take(idx)
    taken = col.take(np.where(nullmask, 0, idx))
    validity = taken.valid_mask() & ~nullmask
    return Column(taken.data, taken.sql_type,
                  None if validity.all() else validity)


def _combine(left: Table, right: Table, li: np.ndarray, ri: np.ndarray,
             drop: set | None) -> Table:
    lnull = li < 0
    rnull = ri < 0
    has_lnull = bool(lnull.any())
    has_rnull = bool(rnull.any())
    cols: dict = {}
    for name, col in left.columns.items():
        cols[name] = _take_nullable(col, li, lnull, has_lnull)
    for name, col in right.columns.items():
        if name in cols:
            # bare-name collision: keep qualified versions only
            if "." not in name:
                cols[f"{name}_1"] = _take_nullable(col, ri, rnull, has_rnull)
            continue
        cols[name] = _take_nullable(col, ri, rnull, has_rnull)
    return Table(cols)


def _append_outer(left: Table, right: Table, matched: Table,
                  unmatched_idx: np.ndarray, side: str) -> Table:
    """Append outer-join rows: values from one side, NULLs from the other."""
    if len(unmatched_idx) == 0:
        return matched
    n = len(unmatched_idx)
    cols: dict = {}
    for name, col in matched.columns.items():
        src = left if side == "left" else right
        other = right if side == "left" else left
        if name in src.columns:
            extra = src.columns[name].take(unmatched_idx)
        elif name in other.columns:
            extra = Column.constant(None, other.columns[name].sql_type, n)
        else:
            extra = Column.constant(None, col.sql_type, n)
        data = np.concatenate([col.data, extra.data]) if col.data.dtype != object or extra.data.dtype == object else np.concatenate([col.data, extra.data.astype(object)])
        validity = np.concatenate([col.valid_mask(), extra.valid_mask()])
        cols[name] = Column(data, col.sql_type, None if validity.all() else validity)
    return Table(cols)
