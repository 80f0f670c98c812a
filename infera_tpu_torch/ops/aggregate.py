"""Hash aggregate (GROUP BY) operator.

Counterpart of ``infera_tpu/ops/aggregate.py``: numpy unique-based grouping,
complete SQL semantics (NULL groups, aggregates over expressions, HAVING).
Large numeric tables assign their group ids on the device by sorting
(``ops/device_groupby.py``), as ``infera_tpu`` does.
"""

from __future__ import annotations

import numpy as np

from ..columnar import Column, Table, infer_sql_type
from ..columnar import types as T
from ..errors import SqlError
from ..sql import ast as A

# rows above which numeric GROUP BY keys use the device sort path
DEVICE_GROUPBY_THRESHOLD = 1 << 15

# --- aggregate function catalog -------------------------------------------

def _agg_count(values: Column | None, groups, n_groups):
    if values is None:  # count(*)
        return np.bincount(groups, minlength=n_groups).astype(np.int64), None
    valid = values.valid_mask()
    return (
        np.bincount(groups[valid], minlength=n_groups).astype(np.int64),
        None,
    )


def _masked(values: Column):
    valid = values.valid_mask()
    data = values.data.astype(np.float64)
    return data, valid


def _group_reduce(data, valid, groups, n_groups, reduce_fn, empty):
    out = np.full(n_groups, empty, dtype=np.float64)
    has = np.zeros(n_groups, dtype=bool)
    gv = groups[valid]
    dv = data[valid]
    if len(gv):
        np_fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[reduce_fn]
        np_fn.at(out, gv, dv)
        has[np.unique(gv)] = True
    return out, has


def _agg_sum(values, groups, n_groups):
    if values.sql_type.is_integer:
        # exact int64 accumulation — f64 would silently lose precision for
        # totals past 2^53
        valid = values.valid_mask()
        # overflow guard (f64 magnitude estimate, 2x safety margin): numpy
        # wraps silently where DuckDB raises
        est = np.zeros(n_groups, np.float64)
        np.add.at(est, groups[valid], np.abs(values.data[valid].astype(np.float64)))
        if (est >= 2.0**62).any():
            raise SqlError("Out of Range Error: overflow in SUM(BIGINT)")
        out = np.zeros(n_groups, np.int64)
        np.add.at(out, groups[valid], values.data[valid].astype(np.int64))
        has = np.zeros(n_groups, bool)
        gv = groups[valid]
        if len(gv):
            has[np.unique(gv)] = True
        return out, ~has  # int64 through to the BIGINT column, no f64 trip
    data, valid = _masked(values)
    out, has = _group_reduce(data, valid, groups, n_groups, "sum", 0.0)
    return out, ~has


def _agg_avg(values, groups, n_groups):
    data, valid = _masked(values)
    s, has = _group_reduce(data, valid, groups, n_groups, "sum", 0.0)
    c = np.bincount(groups[valid], minlength=n_groups)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = s / c
    return out, ~has


def _agg_min(values, groups, n_groups):
    data, valid = _masked(values)
    out, has = _group_reduce(data, valid, groups, n_groups, "min", np.inf)
    return out, ~has


def _agg_max(values, groups, n_groups):
    data, valid = _masked(values)
    out, has = _group_reduce(data, valid, groups, n_groups, "max", -np.inf)
    return out, ~has


def _agg_first(values, groups, n_groups):
    out = np.empty(n_groups, dtype=object)
    seen = np.zeros(n_groups, dtype=bool)
    for i, g in enumerate(groups):
        if not seen[g]:
            out[g] = values.value(i)
            seen[g] = True
    return out, ~seen


def _agg_stddev(values, groups, n_groups):
    data, valid = _masked(values)
    s, _ = _group_reduce(data, valid, groups, n_groups, "sum", 0.0)
    s2, _ = _group_reduce(data * data, valid, groups, n_groups, "sum", 0.0)
    c = np.bincount(groups[valid], minlength=n_groups).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        var = (s2 - s * s / c) / (c - 1)
        out = np.sqrt(np.maximum(var, 0.0))
    return out, c < 2


def _agg_var(values, groups, n_groups, ddof):
    data, valid = _masked(values)
    s, _ = _group_reduce(data, valid, groups, n_groups, "sum", 0.0)
    s2, _ = _group_reduce(data * data, valid, groups, n_groups, "sum", 0.0)
    c = np.bincount(groups[valid], minlength=n_groups).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.maximum((s2 - s * s / c) / (c - ddof), 0.0)
    return out, c < max(ddof + 1, 1)


def _agg_var_samp(values, groups, n_groups):
    return _agg_var(values, groups, n_groups, 1)


def _agg_var_pop(values, groups, n_groups):
    return _agg_var(values, groups, n_groups, 0)


def _agg_stddev_pop(values, groups, n_groups):
    out, nulls = _agg_var_pop(values, groups, n_groups)
    return np.sqrt(out), nulls


def _agg_median(values, groups, n_groups):
    """Per-group median (even counts average the two middles, DuckDB-style);
    sort-based: one lexsort by (group, value) then segment middles."""
    data, valid = _masked(values)
    gv = groups[valid]
    dv = data[valid]
    out = np.full(n_groups, np.nan)
    has = np.zeros(n_groups, bool)
    if len(gv):
        order = np.lexsort((dv, gv))
        gs, ds = gv[order], dv[order]
        starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
        ends = np.r_[starts[1:], len(gs)]
        for st, en in zip(starts, ends):
            g = gs[st]
            n = en - st
            mid = st + (n - 1) // 2
            out[g] = ds[mid] if n % 2 else 0.5 * (ds[mid] + ds[mid + 1])
            has[g] = True
    return out, ~has


def _agg_mode(values, groups, n_groups):
    """Most frequent non-NULL value per group (ties → first seen)."""
    from collections import Counter

    counters: list = [Counter() for _ in range(n_groups)]
    firsts_order: list = [dict() for _ in range(n_groups)]
    for i, g in enumerate(groups):
        v = values.value(i)
        if v is None:
            continue
        counters[g][v] += 1
        firsts_order[g].setdefault(v, i)
    out = np.empty(n_groups, dtype=object)
    nulls = np.ones(n_groups, bool)
    for g, cnt in enumerate(counters):
        if cnt:
            best = max(cnt.items(),
                       key=lambda kv: (kv[1], -firsts_order[g][kv[0]]))[0]
            out[g] = best
            nulls[g] = False
    return out, nulls


_HLL_BITS = 11
_HLL_B = 1 << _HLL_BITS  # 2048 registers → ~2.3% relative error


def _agg_approx_count_distinct(values, groups, n_groups):
    """HyperLogLog distinct estimate, fully vectorized: 64-bit splitmix
    hashes → (register bucket, rank of first 1-bit), np.maximum.at into a
    [groups, 2048] register table, harmonic-mean estimate with the
    small-range correction."""
    from .hashing import hash_array_host

    valid = values.valid_mask()
    h = hash_array_host(values.data)
    gv = groups[valid]
    hv = h[valid]
    if len(gv) == 0:
        return np.zeros(n_groups, np.int64), np.ones(n_groups, bool)
    bucket = (hv & np.uint64(_HLL_B - 1)).astype(np.int64)
    rest = (hv >> np.uint64(_HLL_BITS)).astype(np.float64)
    # rank = #leading zero bits of the remaining 53 + 1; frexp exponent is
    # exact for ints < 2^53
    _, expo = np.frexp(rest)
    rho = np.where(rest > 0, (64 - _HLL_BITS) - expo + 1, 64 - _HLL_BITS + 1)
    regs = np.zeros((n_groups, _HLL_B), np.int8)
    np.maximum.at(regs, (gv, bucket), rho.astype(np.int8))
    hist = _hll_histogram(regs, n_groups)
    has = np.zeros(n_groups, bool)
    has[np.unique(gv)] = True
    return hll_estimate_from_hist(hist), ~has


def _hll_histogram(regs, n_groups):
    """[G, 55] register-value counts from the [G, B] register table."""
    flat = regs.astype(np.int64) + np.arange(n_groups)[:, None] * 55
    return np.bincount(flat.ravel(), minlength=n_groups * 55).reshape(
        n_groups, 55)


def hll_estimate_from_hist(hist) -> np.ndarray:
    """HLL estimate as a pure function of the register-value histogram,
    summed in a FIXED ascending-magnitude order — so the device paths
    (single-chip and mesh, ops/hashing.splitmix64_device) reproduce the
    host estimate bit-exactly from the same histogram (round-4)."""
    hist = np.asarray(hist, np.float64)
    z = np.zeros(hist.shape[0], np.float64)
    for r in range(54, -1, -1):
        z = z + hist[:, r] * 2.0 ** (-r)
    alpha = 0.7213 / (1.0 + 1.079 / _HLL_B)
    with np.errstate(divide="ignore"):
        est = alpha * _HLL_B * _HLL_B / np.where(z == 0, 1.0, z)
    zeros = hist[:, 0]
    small = (est <= 2.5 * _HLL_B) & (zeros > 0)
    with np.errstate(divide="ignore"):
        linear = _HLL_B * np.log(
            _HLL_B / np.maximum(zeros, 1).astype(np.float64))
    est = np.where(small, linear, est)
    return np.rint(est).astype(np.int64)


def _agg_bool_and(values, groups, n_groups):
    data = values.data.astype(bool).astype(np.float64)
    valid = values.valid_mask()
    out, has = _group_reduce(data, valid, groups, n_groups, "min", 1.0)
    return out.astype(bool), ~has


def _agg_bool_or(values, groups, n_groups):
    data = values.data.astype(bool).astype(np.float64)
    valid = values.valid_mask()
    out, has = _group_reduce(data, valid, groups, n_groups, "max", 0.0)
    return out.astype(bool), ~has


def _agg_last(values, groups, n_groups):
    out = np.empty(n_groups, dtype=object)
    seen = np.zeros(n_groups, dtype=bool)
    for i, g in enumerate(groups):
        out[g] = values.value(i)
        seen[g] = True
    return out, ~seen


def _agg_product(values, groups, n_groups):
    data, valid = _masked(values)
    out = np.ones(n_groups, dtype=np.float64)
    has = np.zeros(n_groups, bool)
    gv = groups[valid]
    if len(gv):
        np.multiply.at(out, gv, data[valid])
        has[np.unique(gv)] = True
    return out, ~has


def _agg_count_if(values, groups, n_groups):
    valid = values.valid_mask() & values.data.astype(bool)
    return (np.bincount(groups[valid], minlength=n_groups).astype(np.int64),
            None)


def _sorted_group_spans(gv, dv):
    order = np.lexsort((dv, gv))
    gs, ds = gv[order], dv[order]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    ends = np.r_[starts[1:], len(gs)]
    return gs, ds, starts, ends


def _const_arg(col, what: str):
    """Constant argument of a multi-arg aggregate (quantile fraction,
    string_agg separator). Zero input rows -> None: the aggregate returns
    NULL for an empty table rather than raising (round-4 fix — the
    reference returns NULL for quantile_cont(x, 0.5) over 0 rows)."""
    if len(col.data) == 0:
        return None
    if col.is_null(0):
        raise SqlError(f"Binder Error: {what} must be a non-NULL constant")
    return col.value(0)


def _quantile(cols, groups, n_groups, cont: bool):
    """quantile_cont / quantile_disc (percentile_* aliases): q constant in
    [0, 1]. cont: linear interpolation between closest ranks (DuckDB /
    PostgreSQL percentile_cont); disc: the exact element at
    ceil(q*n) - 1 in sort order (type-1 / inverted-CDF quantile)."""
    values = cols[0]
    qv = _const_arg(cols[1], "quantile fraction")
    if qv is None:  # empty input: NULL result per group
        return (np.full(n_groups, np.nan), np.ones(n_groups, bool), T.DOUBLE)
    q = float(qv)
    if not 0.0 <= q <= 1.0:
        raise SqlError("Out of Range Error: quantile fraction must be "
                       "between 0 and 1")
    data, valid = _masked(values)
    gv, dv = groups[valid], data[valid]
    out = np.full(n_groups, np.nan)
    has = np.zeros(n_groups, bool)
    if len(gv):
        gs, ds, starts, ends = _sorted_group_spans(gv, dv)
        for st, en in zip(starts, ends):
            g, n = gs[st], en - st
            if cont:
                pos = q * (n - 1)
                lo = int(np.floor(pos))
                hi = min(lo + 1, n - 1)
                frac = pos - lo
                out[g] = ds[st + lo] * (1 - frac) + ds[st + hi] * frac
            else:
                idx = max(int(np.ceil(q * n)) - 1, 0)
                out[g] = ds[st + idx]
            has[g] = True
    return out, ~has, T.DOUBLE


def _arg_minmax(cols, groups, n_groups, is_min: bool):
    """arg_min(arg, val) / arg_max: value of `arg` at the extreme of `val`
    (ties -> first occurrence, NULL vals skipped)."""
    arg, val = cols[0], cols[1]
    data, valid = _masked(val)
    best = np.full(n_groups, np.inf if is_min else -np.inf)
    best_i = np.full(n_groups, -1, np.int64)
    cmp = np.less if is_min else np.greater
    for i in np.flatnonzero(valid):
        g = groups[i]
        if best_i[g] < 0 or cmp(data[i], best[g]):
            best[g] = data[i]
            best_i[g] = i
    out = np.empty(n_groups, dtype=object)
    for g in range(n_groups):
        out[g] = arg.value(best_i[g]) if best_i[g] >= 0 else None
    return out, best_i < 0, arg.sql_type


def _string_agg(cols, groups, n_groups):
    """string_agg(x, sep) (listagg alias): NULLs skipped, input order."""
    values = cols[0]
    sepv = _const_arg(cols[1], "string_agg separator")
    if sepv is None:  # empty input: NULL result per group
        return (np.empty(n_groups, dtype=object),
                np.ones(n_groups, bool), T.VARCHAR)
    sep = str(sepv)
    valid = values.valid_mask()
    parts: list = [[] for _ in range(n_groups)]
    for i in np.flatnonzero(valid):
        v = values.value(i)
        parts[groups[i]].append(v if isinstance(v, str) else str(v))
    out = np.empty(n_groups, dtype=object)
    has = np.zeros(n_groups, bool)
    for g in range(n_groups):
        if parts[g]:
            out[g] = sep.join(parts[g])
            has[g] = True
    return out, ~has, T.VARCHAR


# multi-argument aggregates: impl(cols, groups, n_groups) ->
# (data, null_mask, sql_type)
_MULTI_AGGS = {
    "quantile_cont": lambda c, g, n: _quantile(c, g, n, True),
    "percentile_cont": lambda c, g, n: _quantile(c, g, n, True),
    "quantile_disc": lambda c, g, n: _quantile(c, g, n, False),
    "quantile": lambda c, g, n: _quantile(c, g, n, False),
    "percentile_disc": lambda c, g, n: _quantile(c, g, n, False),
    "arg_min": lambda c, g, n: _arg_minmax(c, g, n, True),
    "min_by": lambda c, g, n: _arg_minmax(c, g, n, True),
    "arg_max": lambda c, g, n: _arg_minmax(c, g, n, False),
    "max_by": lambda c, g, n: _arg_minmax(c, g, n, False),
    "string_agg": _string_agg,
    "listagg": _string_agg,
}


_AGGS = {
    "count": _agg_count,
    "sum": _agg_sum,
    "avg": _agg_avg,
    "mean": _agg_avg,
    "min": _agg_min,
    "max": _agg_max,
    "first": _agg_first,
    "any_value": _agg_first,
    "stddev": _agg_stddev,
    "stddev_samp": _agg_stddev,
    "stddev_pop": _agg_stddev_pop,
    "var_samp": _agg_var_samp,
    "variance": _agg_var_samp,
    "var_pop": _agg_var_pop,
    "median": _agg_median,
    "mode": _agg_mode,
    "bool_and": _agg_bool_and,
    "bool_or": _agg_bool_or,
    "approx_count_distinct": _agg_approx_count_distinct,
    "last": _agg_last,
    "product": _agg_product,
    "count_if": _agg_count_if,
    "countif": _agg_count_if,
}

_ALL_AGGS = frozenset(_AGGS) | frozenset(_MULTI_AGGS)


def _result_type(name: str, values: Column | None) -> T.SqlType:
    if name in ("count", "approx_count_distinct", "count_if", "countif"):
        return T.BIGINT
    if name in ("first", "any_value", "last", "mode") and values is not None:
        return values.sql_type
    if name == "sum" and values is not None and values.sql_type.is_integer:
        return T.BIGINT
    if name in ("min", "max") and values is not None:
        return values.sql_type
    if name in ("bool_and", "bool_or"):
        return T.BOOLEAN
    return T.DOUBLE


def _distinct_mask(values: Column, groups: np.ndarray) -> np.ndarray:
    """validity mask keeping one (the first) valid row per (group, value)."""
    valid = values.valid_mask().copy()
    data = values.data
    if data.dtype == object:
        seen: set = set()
        for i in range(len(data)):
            if not valid[i]:
                continue
            key = (int(groups[i]), data[i])
            if key in seen:
                valid[i] = False
            else:
                seen.add(key)
        return valid
    d = data.astype(np.float64)
    idx = np.flatnonzero(valid)
    if len(idx) == 0:
        return valid
    order = np.lexsort((d[idx], groups[idx]))
    gi, di, oi = groups[idx][order], d[idx][order], idx[order]
    dup = np.r_[False, (gi[1:] == gi[:-1]) & (di[1:] == di[:-1])]
    valid[oi[dup]] = False
    return valid


# --- group-by machinery ----------------------------------------------------

def _collect_agg_nodes(expr: A.Expr, out: list) -> None:
    if isinstance(expr, A.FuncCall) and expr.name.lower() in _ALL_AGGS:
        out.append(expr)
        return
    if isinstance(expr, A.FuncCall):
        for a in expr.args:
            if isinstance(a, A.Expr):
                _collect_agg_nodes(a, out)
        return
    for attr in ("operand", "left", "right", "low", "high", "pattern",
                 "needle", "haystack"):
        child = getattr(expr, attr, None)
        if isinstance(child, A.Expr):
            _collect_agg_nodes(child, out)
    if isinstance(expr, A.Case):
        for c, r in expr.whens:
            _collect_agg_nodes(c, out)
            _collect_agg_nodes(r, out)
        if expr.else_ is not None:
            _collect_agg_nodes(expr.else_, out)
    if isinstance(expr, A.ListExpr):
        for e in expr.items:
            _collect_agg_nodes(e, out)


def _rewrite(expr: A.Expr, agg_map: dict, gb_map: list) -> A.Expr:
    """Replace aggregate calls / group-by expressions with column refs into
    the per-group table. gb_map is a list of (expr, column_name) pairs
    (AST nodes are unhashable)."""
    for gb_expr, col_name in gb_map:
        if expr == gb_expr:
            return A.ColumnRef(col_name)
    if isinstance(expr, A.FuncCall) and expr.name.lower() in _ALL_AGGS:
        return A.ColumnRef(agg_map[id(expr)])
    import copy

    out = copy.copy(expr)
    for attr in ("operand", "left", "right", "low", "high", "pattern",
                 "needle", "haystack"):
        child = getattr(out, attr, None)
        if isinstance(child, A.Expr):
            setattr(out, attr, _rewrite(child, agg_map, gb_map))
    if isinstance(out, A.FuncCall):
        out.args = [
            _rewrite(a, agg_map, gb_map) if isinstance(a, A.Expr) else a
            for a in out.args
        ]
    if isinstance(out, A.Case):
        out.whens = [(_rewrite(c, agg_map, gb_map), _rewrite(r, agg_map, gb_map))
                     for c, r in out.whens]
        if out.else_ is not None:
            out.else_ = _rewrite(out.else_, agg_map, gb_map)
    if isinstance(out, A.ListExpr):
        out.items = [_rewrite(e, agg_map, gb_map) for e in out.items]
    return out


def group_ids_host(key_cols: list, n_rows: int) -> tuple:
    """Assign dense group ids. Returns (groups[int64], first_row_indices)."""
    if not key_cols:
        return np.zeros(n_rows, dtype=np.int64), np.array([0] if n_rows else [0], dtype=np.int64)
    mapping: dict = {}
    groups = np.empty(n_rows, dtype=np.int64)
    firsts: list = []
    for i in range(n_rows):
        key = tuple(c.value(i) for c in key_cols)
        gid = mapping.get(key)
        if gid is None:
            gid = len(firsts)
            mapping[key] = gid
            firsts.append(i)
        groups[i] = gid
    return groups, np.asarray(firsts, dtype=np.int64)


def group_aggregate(sel, scope, eval_fn, scope_cls) -> Table:
    """Execute the aggregate portion of a SELECT (called by the executor)."""
    conn_eval = eval_fn  # (expr, scope) -> Column
    n_rows = scope.num_rows

    # 1. group keys — device sort-based path for large all-numeric keys,
    # host dict path otherwise (group output order is unspecified in SQL)
    key_cols = [conn_eval(e, scope) for e in sel.group_by]
    if (
        key_cols
        and n_rows >= DEVICE_GROUPBY_THRESHOLD
        and all((k.sql_type.is_numeric or k.data.dtype == object)
                and k.validity is None for k in key_cols)
    ):
        from .device_groupby import group_ids_device

        groups, firsts = group_ids_device(key_cols, n_rows)
    else:
        groups, firsts = group_ids_host(key_cols, n_rows)
    if sel.group_by:
        n_groups = len(firsts)
    else:
        n_groups = 1  # global aggregate: exactly one output row (even if empty input)
        firsts = np.zeros(1, dtype=np.int64) if n_rows else np.zeros(0, dtype=np.int64)

    # 2. aggregate nodes across select items + having
    agg_nodes: list = []
    for item in sel.items:
        _collect_agg_nodes(item.expr, agg_nodes)
    if sel.having is not None:
        _collect_agg_nodes(sel.having, agg_nodes)

    # 3. evaluate each aggregate
    group_cols: dict = {}
    agg_map: dict = {}
    for k, node in enumerate(agg_nodes):
        name = node.name.lower()
        if name in _MULTI_AGGS:
            if getattr(node, "distinct", False):
                raise SqlError(
                    f"Binder Error: DISTINCT is not supported in {name}")
            if node.is_star or len(node.args) != 2:
                raise SqlError(
                    f"Binder Error: {name} expects exactly 2 arguments")
            cols = [conn_eval(a, scope) for a in node.args]
            data, nulls, rt = _MULTI_AGGS[name](cols, groups, n_groups)
        else:
            impl = _AGGS[name]
            if node.is_star or not node.args:
                values = None
            else:
                values = conn_eval(node.args[0], scope)
            if getattr(node, "distinct", False) and values is not None:
                # DISTINCT: keep only the first occurrence of each (group,
                # value) pair; every aggregate respects validity, so masking
                # duplicates implements DISTINCT for all of them
                values = Column(values.data, values.sql_type,
                                _distinct_mask(values, groups))
            if name == "count":
                data, nulls = impl(values, groups, n_groups)
            else:
                if values is None:
                    raise SqlError(f"Binder Error: {name}(*) is not allowed")
                data, nulls = impl(values, groups, n_groups)
            rt = _result_type(name, values)
        col_name = f"__agg_{k}"
        agg_map[id(node)] = col_name
        if isinstance(data, np.ndarray) and data.dtype == object:
            col = Column.from_values(list(data), rt if rt.name != "NULL" else infer_sql_type(list(data)))
            if nulls is not None and nulls.any():
                col.validity = ~nulls
        else:
            phys = data.astype(rt.np_dtype) if rt.np_dtype is not None else data
            col = Column(phys, rt, None if nulls is None or not nulls.any() else ~nulls)
        group_cols[col_name] = col

    # 4. group-by key columns land in the per-group table
    gb_map: list = []
    for j, e in enumerate(sel.group_by):
        col_name = f"__gb_{j}"
        gb_map.append((e, col_name))
        group_cols[col_name] = key_cols[j].take(firsts) if n_rows else Column(
            np.empty(0, dtype=key_cols[j].data.dtype), key_cols[j].sql_type
        )

    if not group_cols:
        group_cols["__dummy__"] = Column(np.zeros(n_groups, dtype=np.int8), T.TINYINT)
    group_table = Table(group_cols)
    gscope = scope_cls(group_table)

    # 5. HAVING
    if sel.having is not None:
        cond = conn_eval(_rewrite(sel.having, agg_map, gb_map), gscope)
        mask = cond.data.astype(bool) & cond.valid_mask()
        group_table = group_table.filter(mask)
        gscope = scope_cls(group_table)

    # 6. project select items over groups
    out_cols: dict = {}
    for idx, item in enumerate(sel.items):
        expr = _rewrite(item.expr, agg_map, gb_map)
        name = item.alias or _item_name(item.expr, idx)
        base, k = name, 1
        while name in out_cols:
            name = f"{base}_{k}"
            k += 1
        out_cols[name] = conn_eval(expr, gscope)
    return Table(out_cols)


def _item_name(expr: A.Expr, idx: int) -> str:
    if isinstance(expr, A.ColumnRef):
        return expr.name
    if isinstance(expr, A.FuncCall):
        return expr.name
    return f"col{idx}"
