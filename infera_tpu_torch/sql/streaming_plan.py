"""Streaming fused aggregation: out-of-core tables through a fixed device
footprint.

Counterpart of ``infera_tpu/sql/streaming_plan.py``. ``device_plan.py`` keeps the
whole table on the device and declines 2**24 rows or more; this module runs
the same query shapes over tables of any length: the scan reads fixed-size
row chunks (``CHUNK_ROWS``; memmap columns stream from disk, each chunk
copied once into a pinned staging slot by ``ops/streaming.stream_query``),
one step computes each chunk's per-group partials on the device, and the
partials fold there: counts and integer sums in int64, float sums in f64,
extremes by min/max. The folded group table comes back in one copy.
Nothing the size of the table is kept on the device, nor cached: neither
``get_table_block`` nor ``get_int_block`` is called.

Eligibility is ``infera_tpu``'s: one scanned table, count/sum/avg/min/max
(no DISTINCT, no HAVING), at most 4 GROUP BY keys that are plain integer
columns in [0, 2**31) (probed on the host), float-only arguments but for
sum/avg/min/max of a plain integer column, which run exactly in int64
(``sql/int_agg.py``). ``infera_tpu`` splits those into 32-bit words and
8-bit limbs; the card adds int64 natively. SUM(BIGINT) raises the host's
overflow message under the same rule (an f64 sum of ``|v|`` of 2**62 or
more). Group keys are read as int64, never through f32, so keys past 2**24
stay apart and the bucket guard compares them exactly. Each chunk's
columns are a dict of their own, with its own ``__n__`` and prediction
cache. A key guard that trips (two keys in one bucket) sends the query to
the host executor; an empty global group renders NULL as the host does
(``infera_tpu`` answers 0 and ±inf there: ROADMAP R17).

With a mesh set (``sql/mesh_plan.get_mesh``; path ``streaming_plan_mesh``)
a global step is ``CHUNK_ROWS × dp`` rows: each shard runs the step on its
part of the chunk and the partials merge across the shards with psum, pmin
and pmax (``mesh_step``) before the same fold and read-back; the pinned
slots and the copy stream stay.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import types as T
from ..device import get_device
from ..errors import OnnxError, SqlError
from ..ops import gemm_groupby as GG
from ..ops import streaming as S
from ..parallel import mesh as M
from . import ast as A
from . import mesh_plan as MP
from . import int_agg
from .device_plan import (_AGG_NAMES, MAX_GROUPS, _find_aggs, _full, _int_range, _Lowerer, _ms,
                          _to_host, _Unsupported)

# stream only when the table is big enough that whole-column upload hurts
STREAM_MIN_ROWS = 1 << 22
CHUNK_ROWS = 1 << 20

_INT_NAMES = {"sum": "isum", "avg": "iavg", "mean": "iavg", "min": "imin", "max": "imax"}


class _ChunkLowerer(_Lowerer):
    """The device plan's lowerer over one chunk's columns. It records the
    columns its closures read (each chunk carries those as f32) and
    declines windows, which no chunk can compute alone."""

    def __init__(self, table: Table, device):
        super().__init__(table, device)
        self.f32_columns: set = set()

    def lower(self, expr: A.Expr):
        fn = super().lower(expr)
        if isinstance(expr, A.ColumnRef):
            self.f32_columns.add(self._column(expr.name, expr.table))
        return fn

    def _lower_window(self, wf):
        raise _Unsupported("window in a streamed plan")


def _float_only(lowerer: _Lowerer, expr: A.Expr) -> bool:
    """``infera_tpu``'s rule for a float aggregate's argument: every column
    it reads outside ``infera_predict`` is a float or DECIMAL column."""
    if isinstance(expr, A.ColumnRef):
        try:
            key = lowerer._column(expr.name, expr.table)
        except _Unsupported:
            return False
        t = lowerer.col_for_key(key).sql_type
        return t.is_float or t.name == "DECIMAL"
    if isinstance(expr, A.FuncCall):
        if expr.name.lower() == "infera_predict":
            return True
        return all(_float_only(lowerer, a) for a in expr.args if isinstance(a, A.Expr))
    return all(_float_only(lowerer, c) for c in
               (getattr(expr, a, None) for a in ("operand", "left", "right", "low", "high"))
               if isinstance(c, A.Expr))


def _is_int_column(col) -> bool:
    return col.sql_type.is_integer or col.data.dtype.kind in "iu"


def group_sizing(ranges: list) -> tuple:
    """(n_groups, strides) of the mixed-radix key over integer keys whose
    (min, max) are ``ranges`` (min >= 0), ``infera_tpu``'s sizing: a power
    of two from 8 up to ``MAX_GROUPS``; a wider domain wraps into the
    buckets and relies on the key guard."""
    if not ranges:
        return 1, []
    radices = [hi + 1 for _lo, hi in ranges]
    domain = 1
    for r in radices:
        domain = min(domain * r, 1 << 40)
    n_groups = 8
    while n_groups < domain and n_groups < MAX_GROUPS:
        n_groups <<= 1
    strides = [1] * len(radices)
    for i in range(len(radices) - 2, -1, -1):
        strides[i] = strides[i + 1] * radices[i + 1]
    return n_groups, strides


def combined_keys(key_cols: list, strides: list, n_groups: int, n: int, device) -> torch.Tensor:
    """Each row's bucket: the mixed-radix key of its int64 key columns mod
    ``n_groups`` (``infera_tpu`` sums int32 products that wrap; a wrap
    modulo 2**32 or 2**64 leaves the key modulo ``n_groups`` as it is)."""
    keys = torch.zeros(n, dtype=torch.int64, device=device)
    for k, stride in zip(key_cols, strides):
        keys = keys + k * (stride & 0x7FFFFFFF)
    return torch.remainder(keys, n_groups)


def fold(kinds: list):
    """combine_fn for ``stream_query`` over flat lists of partials: each
    entry adds, or keeps the minimum or maximum (NaN wins, as XLA's)."""
    ops = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}

    def combine(acc, part):
        if acc is None:
            return list(part)
        return [ops[k](a, p) for k, a, p in zip(kinds, acc, part)]

    return combine


def mesh_merge(mesh, parts: list, kinds: list) -> list:
    """Flat partial lists, one a local shard, merged over the mesh by
    ``kinds`` ("add": psum, "min": pmin, "max": pmax), on the first local
    shard's device."""
    reduce = {"add": M.psum, "min": M.pmin, "max": M.pmax}
    return [reduce[k](mesh, [p[i] for p in parts])[0] for i, k in enumerate(kinds)]


def mesh_step(mesh, step, kinds: list):
    """``step`` over a mesh: a global chunk splits into dp row parts, each
    local shard runs ``step`` on its part on its device, and the partials
    merge over the mesh (``mesh_merge``)."""
    dp = mesh.shape["dp"]

    def run(*chunk):
        per = -(-chunk[0].shape[0] // dp)
        return mesh_merge(mesh, [step(*(c[s * per:(s + 1) * per].to(d, non_blocking=True)
                                         for c in chunk))
                                 for s, d in zip(mesh.local, mesh.local_devices)], kinds)

    return run


def column_sources(named: dict) -> tuple:
    """(distinct source arrays, {name: index}) of ``{name: array}``:
    aliased keys ("t.f" and "f" sharing one array) upload once a chunk."""
    arrays: list = []
    index: dict = {}
    by_id: dict = {}
    for k, data in named.items():
        i = by_id.get(id(data))
        if i is None:
            i = by_id[id(data)] = len(arrays)
            arrays.append(data)
        index[k] = i
    return arrays, index


def render(values, sql_type, null=None) -> Column:
    """A result column; rows where ``null`` is set render NULL."""
    if null is None or not np.any(null):
        return Column(values, sql_type)
    return Column.from_values([None if z else v.item() for v, z in zip(values, null)], sql_type)


def try_execute_streaming(conn, sel: A.Select, table: Table, analyze_only: bool = False):
    """Chunked fused aggregation; returns a Table or None (the next tier
    answers). With ``analyze_only`` returns True after eligibility checking
    and lowering, without touching the device. Records the phases on
    ``conn._last_phases``: plan_ms, probe_ms, stream_ms (the chunk loop to
    its end on the device; of it stage_ms copies chunks into the pinned
    slots, upload_ms and compute_ms are device time by CUDA events),
    fold_ms (the one read-back of the folded partials and the key guard),
    assemble_ms, and the chunks."""
    t0 = time.perf_counter()
    phases: dict = {}
    if (
        sel.from_ is None
        or table.num_rows < STREAM_MIN_ROWS
        or sel.having is not None
        or sel.distinct
        or len(sel.group_by) > 4
    ):
        return None

    agg_nodes: list = []
    for item in sel.items:
        _find_aggs(item.expr, agg_nodes)
    if not agg_nodes:
        return None
    items_plan = []
    for item in sel.items:
        e = item.expr
        if isinstance(e, A.FuncCall) and e.name.lower() in _AGG_NAMES:
            if e.distinct:
                return None  # DISTINCT aggregates stay on the other tiers
            items_plan.append(("agg", e))
        elif sel.group_by and e in sel.group_by:
            items_plan.append(("key", sel.group_by.index(e)))
        else:
            return None
    # group keys: plain integer column refs (host probe, exact int64 keys)
    if not all(isinstance(g, A.ColumnRef) for g in sel.group_by):
        return None

    device = get_device()
    lowerer = _ChunkLowerer(table, device)
    int_cols: set = set()
    try:
        where_fn = lowerer.lower(sel.where) if sel.where is not None else None
        key_keys = [lowerer._column(g.name, g.table) for g in sel.group_by]
        agg_plans = []
        for kind, node in items_plan:
            if kind == "key":
                agg_plans.append(("key", node))
                continue
            name = node.name.lower()
            if name not in ("count", "sum", "avg", "mean", "min", "max"):
                return None  # var/stddev family: non-streaming plans only
            if node.is_star or not node.args:
                if name != "count":
                    return None
                agg_plans.append(("count_star", None))
                continue
            arg = node.args[0]
            if name != "count" and isinstance(arg, A.ColumnRef):
                key = lowerer._column(arg.name, arg.table)
                col = table.columns[key]
                if col.validity is None and _is_int_column(col):
                    # exact int64 sum/avg/min/max over a plain integer column
                    int_cols.add(key)
                    agg_plans.append((_INT_NAMES[name], key))
                    continue
            if name == "count":
                # device-eligible columns carry no NULLs: the row count
                if isinstance(arg, A.ColumnRef):
                    lowerer._column(arg.name, arg.table)
                else:
                    lowerer.lower(arg)
                agg_plans.append(("count", None))
                continue
            if not _float_only(lowerer, arg):
                return None
            agg_plans.append((name, lowerer.lower(arg)))
    except (_Unsupported, OnnxError, SqlError):
        return None
    if not all(_is_int_column(table.columns[k]) for k in key_keys):
        return None

    if analyze_only:
        return True
    phases["plan_ms"] = _ms(t0)
    t0 = time.perf_counter()

    # host-side key probe (a memmap column streams from disk once)
    ranges = [_int_range(table.columns[k]) for k in key_keys]
    if any(lo < 0 or hi >= (1 << 31) for lo, hi in ranges):
        return None
    n_groups, strides = group_sizing(ranges)
    phases["probe_ms"] = _ms(t0)
    t0 = time.perf_counter()

    f32_keys = sorted(lowerer.f32_columns)
    i64_keys = sorted(set(key_keys) | int_cols)
    arrays, src = column_sources({k: table.columns[k].data for k in f32_keys + i64_keys})
    G = n_groups

    kinds = ["add"] + ["min", "max"] * len(key_keys)
    for name, _ in agg_plans:
        if name in ("isum", "iavg"):
            kinds += ["add", "add"]
        elif name in ("imin", "min"):
            kinds.append("min")
        elif name in ("imax", "max"):
            kinds.append("max")
        elif name in ("sum", "avg", "mean"):
            kinds.append("add")

    def step(*chunk):
        m = chunk[0].shape[0]
        cols = {k: chunk[src[k]].float() for k in f32_keys}
        cols["__n__"], cols["__pred__"] = m, {}
        ints = {k: chunk[src[k]].long() for k in i64_keys}
        mask = torch.ones(m, dtype=torch.bool, device=device)
        if where_fn is not None:
            mask = mask & (_full(where_fn(cols), m) != 0)   # NaN is true
        keys = combined_keys([ints[k] for k in key_keys], strides, G, m, device)
        slot = torch.where(mask, keys, G)   # G: a row the WHERE drops
        out = GG.segment_sum_int_exact([torch.ones_like(slot)], slot, G)
        for k in key_keys:
            out += [g.long() for g in GG.segment_minmax_int32(ints[k], keys, G, mask)]
        for name, fn in agg_plans:
            if name in ("key", "count", "count_star"):
                continue
            if name in ("isum", "iavg"):
                out += list(int_agg.device_limb_sums(ints[fn], mask, keys, G))
            elif name in ("imin", "imax"):
                out.append(int_agg.device_lex_minmax(ints[fn], mask, keys, G, name == "imin"))
            else:
                v = _full(fn(cols), m)
                if name in ("sum", "avg", "mean"):
                    out.append(GG.segment_sum(v, slot, G))
                else:
                    (mn,), (mx,) = GG.segment_minmax([v], slot, G)
                    out.append(mn if name == "min" else mx)
        return out

    # the mesh: each shard takes its part of every global chunk of
    # CHUNK_ROWS x dp rows, and the shards' partials merge by psum, pmin and
    # pmax before the fold (every partial merges exactly: int64 and f64)
    conn._mesh_plan_used = False
    mesh = MP.get_mesh(conn)
    run, rows_per_step = step, CHUNK_ROWS
    if mesh is not None:
        run, rows_per_step = mesh_step(mesh, step, kinds), CHUNK_ROWS * mesh.shape["dp"]
    stats: dict = {}
    try:
        acc = S.stream_query(S.chunked(tuple(arrays), rows_per_step), run,
                             fold(kinds), None, device=device, stats=stats)
    except (_Unsupported, OnnxError):
        return None
    conn._mesh_plan_used = mesh is not None
    phases["stream_ms"] = _ms(t0)
    phases.update({k: (round(v, 3) if isinstance(v, float) else v) for k, v in stats.items()})
    t0 = time.perf_counter()

    res = iter(_to_host(acc))
    count = next(res)
    live = count > 0 if key_keys else np.array([True])
    key_vals = []
    for _ in key_keys:
        kmin, kmax = next(res), next(res)
        if (kmin[live] != kmax[live]).any():
            return None  # the modulo bucket held distinct keys: the host answers
        key_vals.append(kmax[live])
    phases["fold_ms"] = _ms(t0)
    t0 = time.perf_counter()

    c = count[live]
    empty = c == 0   # only the global group can be empty: NULL, as the host
    cdiv = np.where(empty, 1, c).astype(np.float64)
    out_cols: dict = {}
    for idx, ((_kind, node), (pname, _)) in enumerate(zip(items_plan, agg_plans)):
        item = sel.items[idx]
        name = item.alias or (node.name if isinstance(node, A.FuncCall)
                              else item.expr.name if isinstance(item.expr, A.ColumnRef)
                              else f"col{idx}")
        base, k = name, 1
        while name in out_cols:
            name = f"{base}_{k}"
            k += 1
        if pname == "key":
            out_cols[name] = Column(key_vals[node].astype(np.int64), T.BIGINT)
        elif pname in ("count", "count_star"):
            out_cols[name] = Column(c.astype(np.int64), T.BIGINT)
        elif pname in ("isum", "iavg"):
            total, est = next(res)[live], next(res)[live]
            if pname == "isum":
                if (est >= 2.0**62).any():
                    raise SqlError("Out of Range Error: overflow in SUM(BIGINT)")
                out_cols[name] = render(total, T.BIGINT, empty)
            else:
                if (est >= 2.0**62).any():
                    return None  # an exact sum is impossible: the host answers
                out_cols[name] = render(total.astype(np.float64) / cdiv, T.DOUBLE, empty)
        elif pname in ("imin", "imax"):
            out_cols[name] = render(next(res)[live], T.BIGINT, empty)
        elif pname in ("avg", "mean"):
            out_cols[name] = render(next(res)[live] / cdiv, T.DOUBLE, empty)
        else:
            out_cols[name] = render(next(res)[live].astype(np.float64), T.DOUBLE, empty)
    phases["assemble_ms"] = _ms(t0)
    conn._last_phases = phases
    return Table(out_cols)
