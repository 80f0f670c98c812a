"""Fused device execution of fact→dimension joins (BASELINE config 3): K5,
then the torch join program.

Counterpart of ``infera_tpu/sql/device_join_plan.py``. Query shape: a large
fact table INNER/LEFT/RIGHT/FULL-joined to a dimension table on a unique
non-negative integer key, with aggregates (and an optional GROUP BY) over
columns from either side, ``infera_predict`` of a model over the fact row
included. The dim key column becomes a dense lookup (key → dim row, −1 for
no row) and the joined relation never exists. Two tiers run a plan, in
``infera_tpu``'s order:

1. **Kernel K5** (``ops/fused_sql.py``: K2 with the join prologue inside
   it; path ``device_join_plan_cuda``), where ``FS.tier_enabled``: each
   fact row looks up its dim row in the kernel, and the dim columns are
   read from the dim table's own block. INNER ANDs ``MATCHED`` into the
   WHERE program. LEFT/RIGHT/FULL keep every fact row and apply only the
   user WHERE; an aggregate over a dim-side expression ("matched"
   validity) selects its input with ``SEL(MATCHED, v, 0)`` for sums and
   ``SEL(MATCHED, v, ±inf)`` for min/max, and a shared matched-count sum
   slot carries its non-NULL count. It declines what ``infera_tpu``'s
   ``_try_pallas_join`` declines: more than 512 groups, an integer column
   past ±2**24 (the fact key included), more than 64 block rows, a plan
   over its shared-memory budget. One widening: ``coalesce(dim_expr, x)``
   lowers to ``SEL(MATCHED, dim_expr, x)`` in the kernel, where
   ``infera_tpu``'s Pallas lowerer leaves it to its XLA program.
2. **The torch join program** (path ``device_join_plan``),
   ``infera_tpu``'s XLA join program as eager torch ops, for every plan K5
   declines or with K5 off: ``sql/device_plan._build_program`` with a
   prologue that gathers the dim rows through the lookup (the fact key read
   exactly, from the int64 block past ±2**24) and the per-aggregate
   validity, so the join and single-table programs share one aggregate
   tail.

A key guard that trips after K5 ran sends the query to the host, since the
program's bucketing would trip it too. FULL adds the dim rows no fact row
matched on the host (``_combine_full_phantom``) after either tier.
With a mesh set (``sql/mesh_plan.py``; path ``device_join_plan_mesh``) K5
does not run: the join program runs over the shards, the fact rows sharded
and the dim block and lookup replicated, outer joins through the matched-row
validity; a plan the mesh declines runs the program. An INNER join the
two tiers decline goes on to the big×big shuffle join
(``sql/shuffle_join_plan.py``) behind the same entry; every other shape
answers on the host executor.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..device import get_device
from ..errors import OnnxError, SqlError
from ..ops import fused_sql as FS
from . import ast as A
from . import mesh_plan as MP
from . import shuffle_join_plan
from .device_plan import (
    _AGG_NAMES,
    _INT,
    _TRIPPED,
    MAX_GROUPS,
    MIN_DEVICE_ROWS,
    _assemble_result,
    _block_eligible,
    _build_program,
    _find_aggs,
    _group_keys_int32_safe,
    _int_range,
    _Lowerer,
    _ms,
    _packed,
    _ProgramLowerer,
    _to_host,
    _Unsupported,
    device_column_array,
    get_int_block,
    get_table_block,
)
DIM_MAX_ROWS = 1 << 20
DIM_MAX_KEY = 1 << 22
# infera_tpu's kernel declines a join plan over this many block rows
# (PALLAS_MAX_COLS): the fact and dim columns it reads and the match row
_MAX_BLOCK_ROWS = 64
_MATCHED = [(FS.MATCHED, 0)]


def _dim_key_lookup(col):
    """(keys as int64, largest key, dense lookup int32 [kmax + 1]: key → dim
    row, -1 where no row holds it) of a dim key column, or None when a key is
    negative, at or past ``DIM_MAX_KEY``, or repeated (row expansion). The
    column's data does not change, so the result is cached on it."""
    got = getattr(col, "_dim_lookup", None)
    if got is None:
        dvals = np.asarray(col.data, np.int64)
        got = False
        if not len(dvals) or (dvals.min() >= 0 and dvals.max() < DIM_MAX_KEY):
            kmax = int(dvals.max()) if len(dvals) else 0
            lookup = np.full(kmax + 1, -1, np.int32)
            lookup[dvals] = np.arange(len(dvals), dtype=np.int32)
            if int(np.count_nonzero(lookup >= 0)) == len(dvals):  # no key repeats
                got = (dvals, kmax, lookup)
        col._dim_lookup = got
    return got or None


class _TwoSidedColumns:
    """Fact/dim column resolution shared by the join lowerers: fact columns
    resolve through the base lowerer (next in the MRO), dim columns become
    "__dim__.<key>" entries that K5 reads through the row's dim row and the
    program's prologue gathers."""

    def _init_two_sided(self, dim, fact_names: set, dim_names: set):
        self.dim = dim
        self.fact_names = {s.lower() for s in fact_names if s}
        self.dim_names = {s.lower() for s in dim_names if s}
        self.dim_used: dict = {}

    def _dim_lookup(self, name: str):
        for k in self.dim.columns:
            if k.split(".")[-1].lower() == name.lower():
                return k
        return None

    def _fact_lookup(self, name: str):
        for k in self.table.columns:
            if k.split(".")[-1].lower() == name.lower():
                return k
        return None

    def _column(self, name: str, qualifier):
        q = qualifier.lower() if qualifier else None
        in_fact = self._fact_lookup(name) if (q is None or q in self.fact_names) else None
        in_dim = self._dim_lookup(name) if (q is None or q in self.dim_names) else None
        if in_fact is not None and in_dim is not None:
            raise _Unsupported(f"ambiguous column {name}")
        if in_fact is not None:
            return super()._column(name, None)
        if in_dim is None:
            raise _Unsupported(f"unknown column {name}")
        col = self.dim.columns[in_dim]
        if not col.sql_type.is_numeric or col.validity is not None:
            raise _Unsupported(f"column {name} not device-eligible")
        key = "__dim__." + in_dim
        self.dim_used[key] = col
        return key

    def col_for_key(self, key: str):
        if key in self.dim_used:
            return self.dim_used[key]
        return self.table.columns[key]

    # --- outer-join NULL tracking (static two-point lattice) -------------
    # Under a LEFT/RIGHT join, dim-side columns are NULL on unmatched rows.
    # Every device expression's validity is statically either "all" (never
    # NULL) or "matched" (NULL exactly where the row is unmatched) —
    # coalesce(dim_expr, all_expr) launders back to "all". Aggregates mask
    # their input rows by the expression's validity; anything the lattice
    # can't express falls back to the host join path.

    def validity(self, expr) -> str:
        if isinstance(expr, A.ColumnRef):
            key = self._column(expr.name, expr.table)
            return "matched" if key.startswith("__dim__.") else "all"
        if isinstance(expr, A.FuncCall):
            name = expr.name.lower()
            args = [a for a in expr.args if isinstance(a, A.Expr)]
            if name == "coalesce" and len(args) == 2:
                return self.validity(args[1])
            vs = [self.validity(a) for a in args]
            return "matched" if "matched" in vs else "all"
        out = "all"
        for attr in ("operand", "left", "right", "low", "high"):
            child = getattr(expr, attr, None)
            if isinstance(child, A.Expr) and self.validity(child) == "matched":
                out = "matched"
        return out

    def _lower_window(self, wf):
        # the join tiers see the fact rows before the join drops any; a
        # window over the joined rows stays on the host
        raise _Unsupported("window functions over a join")


class _JoinLowerer(_TwoSidedColumns, _Lowerer):
    """The program's lowering over both sides of the join (``infera_tpu``'s
    ``_JoinLowerer``): torch closures, dim columns read from the cols the
    prologue gathers, ``coalesce`` of a dim-valued first argument through
    ``cols["__matched__"]``."""

    def __init__(self, fact, fact_names: set, dim, dim_names: set, device):
        _Lowerer.__init__(self, fact, device)
        self._init_two_sided(dim, fact_names, dim_names)

    def lower(self, expr):
        if (isinstance(expr, A.FuncCall) and expr.name.lower() == "coalesce"
                and len(expr.args) == 2):
            a0, a1 = expr.args
            f0, f1 = self.lower(a0), self.lower(a1)
            if self.validity(a0) == "all":
                return f0  # never NULL → first argument wins everywhere
            # dim-valued first argument: unmatched rows take the fallback
            return lambda cols: torch.where(cols["__matched__"], f0(cols), f1(cols))
        return super().lower(expr)


class _JoinProgramLowerer(_TwoSidedColumns, _ProgramLowerer):
    """The port's ``_ProgramLowerer`` over both sides of the join, for K5.
    Dim columns lower to ``COL "__dim__.<key>"`` and resolve to ``DIM``
    rows of the dim block."""

    def __init__(self, fact, fact_names: set, dim, dim_names: set):
        _ProgramLowerer.__init__(self, fact)
        self._init_two_sided(dim, fact_names, dim_names)
        self.dim_row_map: dict = {}   # "__dim__.<key>" -> dim block row, set before fused_plan

    def lower(self, expr) -> list:
        if (isinstance(expr, A.FuncCall) and expr.name.lower() == "coalesce"
                and len(expr.args) == 2):
            a0, a1 = expr.args
            v0 = self.validity(a0)
            c0 = self.lower(a0)
            c1 = self.lower(a1)
            if v0 == "all":
                return c0  # never NULL → first argument wins everywhere
            # dim-valued first argument: unmatched rows take the fallback
            return _MATCHED + c0 + c1 + [(FS.SEL, 0)]
        return super().lower(expr)

    def _resolve(self, op, arg, row_map) -> tuple:
        if arg.startswith("__dim__."):
            if arg not in self.dim_row_map:
                raise _Unsupported(f"column {arg} is not in the dim block")
            return FS.DIM, self.dim_row_map[arg]
        return super()._resolve(op, arg, row_map)


def _lower_k5(sel, fact, fnames, dim, dnames, fkey_ref, n_groups, agg_plans, items_plan,
              outer, agg_validity):
    """K5's lowering of the plan, as ``infera_tpu``'s ``_try_pallas_join``
    lowers it onto its Pallas kernel: (lowerer, WHERE, keys, sums, mins,
    maxs, slot map), COL keys not yet resolved; None where K5 declines the
    plan as far as the plan alone tells (its aggregate kinds, group count,
    expressions, integer columns past ±2**24, block rows). INNER folds
    ``MATCHED`` into the WHERE program; LEFT/RIGHT/FULL keep unmatched rows
    and route every matched-validity aggregate through ``SEL(MATCHED,
    ...)``, with a shared matched-count slot carrying the per-group
    non-NULL count the finalize divides by."""
    if not 1 <= n_groups <= FS.MAX_GROUPS:
        return None
    ok_names = {"key", "count_star", "count", "count_matched", "sum",
                "avg", "mean", "min", "max"}
    if any(p[0] not in ok_names for p in agg_plans):
        return None
    low = _JoinProgramLowerer(fact, fnames, dim, dnames)
    try:
        fact_key = low._column(fkey_ref.name, fkey_ref.table)
        if fact_key.startswith("__dim__."):
            raise _Unsupported("join key resolved to the dim side")
        base_where = low.lower(sel.where) if sel.where is not None else None
        keys = [low.lower(g) for g in sel.group_by]
        sums: list = []
        mins: list = []
        maxs: list = []
        slot_map: list = []
        wm_slot: list = []  # shared matched-count sum slot (lazy)

        def wm_idx():
            if not wm_slot:
                sums.append(_MATCHED)
                wm_slot.append(len(sums) - 1)
            return wm_slot[0]

        nodes = [node for _k, node in items_plan]
        for (pname, payload), node, val in zip(agg_plans, nodes, agg_validity):
            if pname == "key":
                slot_map.append(("key", payload, None))
                continue
            if pname in ("count", "count_star"):
                slot_map.append(("count", None, None))
                continue
            if pname == "count_matched":
                slot_map.append(("count_matched", wm_idx(), None))
                continue
            arg = low.lower(node.args[0])
            m = val == "matched"
            # select, not multiply: an unmatched row reads dim row 0, and
            # NaN * 0 = NaN would poison its group
            if pname in ("sum", "avg", "mean"):
                sums.append(_MATCHED + arg + low._const(0.0) + [(FS.SEL, 0)] if m else arg)
                slot_map.append((pname, len(sums) - 1, wm_idx() if m else None))
            elif pname == "min":
                mins.append(_MATCHED + arg + low._const(math.inf) + [(FS.SEL, 0)] if m else arg)
                slot_map.append(("min", len(mins) - 1, wm_idx() if m else None))
            else:
                maxs.append(_MATCHED + arg + low._const(-math.inf) + [(FS.SEL, 0)] if m else arg)
                slot_map.append(("max", len(maxs) - 1, wm_idx() if m else None))
    except _Unsupported:
        return None
    # every used int column within +-2**24: exact in the f32 blocks (the
    # fact key among them, which the kernel converts back to int32)
    for c in list(low.used_columns.values()) + list(low.dim_used.values()):
        if c.data.dtype.kind in "iu" and c.data.size:
            lo, hi = _int_range(c)
            if lo < -(1 << 24) or hi > (1 << 24):
                return None
    if len(low.used_columns) + len(low.dim_used) + 1 > _MAX_BLOCK_ROWS:
        return None
    if outer:
        where = base_where  # only the user WHERE masks
    else:
        where = _MATCHED if base_where is None else _MATCHED + base_where + [(FS.AND, 0)]
    return low, fact_key, where, keys, sums, mins, maxs, slot_map


def _try_cuda_join(conn, k5, dim, lookup, kmax_dim, n, n_groups, strides, plan_key, blocks):
    """Run K5 on the plan ``_lower_k5`` gave. Returns the _assemble_result
    5-tuple; None when the plan is over K5's shared-memory budget (the
    program runs it); ``_TRIPPED`` when the key guard tripped (the host
    answers). A kernel that fails to build or launch raises."""
    low, fact_key, where, keys, sums, mins, maxs, slot_map = k5
    (xc, row_map), (dim_xc, dim_rows) = blocks
    low.dim_row_map = {"__dim__." + k: r for k, r in dim_rows.items()}
    try:
        spec = FS.JoinSpec(fact_key=row_map[fact_key], kmax=kmax_dim, n_dim=dim.num_rows,
                           n_cols=dim_xc.shape[0])
        plan = low.fused_plan(where, keys, sums, mins, maxs, strides, n_groups, row_map,
                              join=spec)
    except _Unsupported:
        return None
    if not FS.smem_fits(plan):
        return None
    packed = _packed(conn, plan_key + (id(xc), id(dim_xc)), plan, xc, lookup, dim_xc)
    res = FS.execute_fused_plan(packed, xc, n, dim_xc)
    if res is None:
        return _TRIPPED

    def fold64(i):
        s, c = res["sums"][i]
        return np.asarray(s, np.float64) + np.asarray(c, np.float64)

    results: list = []
    for spec_name, si, wmi in slot_map:
        if spec_name == "key":
            results.append(np.asarray(res["kmaxs"][si]))
        elif spec_name == "count":
            results.append(res["count"])
        elif spec_name == "count_matched":
            results.append(fold64(si))
        elif spec_name in ("sum", "avg", "mean"):
            if wmi is None:
                results.append(res["sums"][si])
            else:
                s, c = res["sums"][si]
                results.append((s, c, fold64(wmi)))
        elif spec_name == "min":
            v = np.asarray(res["mins"][si])
            results.append(v if wmi is None else (v, fold64(wmi)))
        else:
            v = np.asarray(res["maxs"][si])
            results.append(v if wmi is None else (v, fold64(wmi)))
    return (results, res["count"], res["kmins"], res["kmaxs"], res["fracs"])


def _join_prologue(lowerer, dim_rows, fact_key, kmax_dim, outer):
    """The join program's prologue over ``cols``: reads the fact key (the
    f32 block's row, or exactly the int64 one past ±2**24), looks up each
    row's dim row in ``cols["__lookup__"]`` (``in_range & ridx >= 0`` is the
    match), gathers every dim column the plan reads from
    ``cols["__dimxc__"]``, publishes the match as ``cols["__matched__"]``
    and returns the base mask: the match for INNER, None (every row) for an
    outer join."""
    gathers = [(dk, dim_rows[dk[len("__dim__."):]]) for dk in sorted(lowerer.dim_used)]

    def prologue(c):
        lookup_t, dim_xc = c["__lookup__"], c["__dimxc__"]
        fk = c[fact_key].long() if fact_key in c else c[fact_key + _INT]
        ridx = lookup_t[fk.clamp(0, kmax_dim)]
        matched = (fk >= 0) & (fk <= kmax_dim) & (ridx >= 0)
        ridx = torch.where(matched, ridx, 0)
        for dk, row in gathers:
            c[dk] = dim_xc[row].index_select(0, ridx)
        c["__matched__"] = matched
        # an outer join keeps its unmatched rows: their gathers read dim
        # row 0, which every matched-validity aggregate drops
        return None if outer else matched

    return prologue


def _run_join_mesh(conn, mesh, lowerer, fact, fact_key, blocks, lookup, kmax_dim, n, outer,
                   where_fn, key_fns, strides, n_groups, agg_plans, agg_validity, phases):
    """The join program over the mesh (``infera_tpu``'s mesh branch of the
    join tier): the fact rows row-sharded, the dim block and the key lookup
    replicated, the prologue on each shard, the aggregate tail merged
    through the partial-table exchange (``sql/mesh_plan.py``). Returns the
    _assemble_result 5-tuple, or None where a guard tripped."""
    (xc, fact_rows), (dim_xc, dim_rows) = blocks
    sharded = {k: (c, "f32") for k, c in lowerer.used_columns.items() if _block_eligible(c)}
    if fact_key not in sharded:
        sharded[fact_key + _INT] = (fact.columns[fact_key], "i64")
    replicated = {"__lookup__": torch.from_numpy(lookup.astype(np.int64)), "__dimxc__": dim_xc}
    return MP.execute_fused_on_mesh(
        conn, mesh, n=n, sharded=sharded, replicated=replicated,
        prologue=_join_prologue(lowerer, dim_rows, fact_key, kmax_dim, outer),
        where_fn=where_fn, key_fns=key_fns, strides=strides, n_groups=n_groups,
        agg_plans=agg_plans, validity=agg_validity, phases=phases)


def _run_join_program(conn, lowerer, fact, fact_key, blocks, lookup, kmax_dim, n, outer,
                      where_fn, key_fns, strides, n_groups, agg_plans, agg_validity,
                      plan_key, device, phases):
    """The torch join program (``infera_tpu``'s XLA join ``program``):
    ``_build_program`` behind a prologue that reads the fact key (from the
    f32 block, or exactly from the int64 block past ±2**24), looks up each
    row's dim row on the device (``in_range & ridx >= 0`` is the match),
    gathers every dim column the plan reads through it and publishes the
    match as ``cols["__matched__"]``; INNER's base mask is the match, an
    outer join's every row. Cached per plan key with the blocks and the
    lookup it reads. Returns the _assemble_result 5-tuple, or None where a
    guard tripped or the engine declined (the host answers)."""
    t0 = time.perf_counter()
    (xc, _), (dim_xc, dim_rows) = blocks
    cols = {k: device_column_array(k, blocks[0], n)
            for k, c in lowerer.used_columns.items() if _block_eligible(c)}
    if fact_key not in cols:
        cols[fact_key + _INT] = get_int_block(fact, device, [fact_key])[0, :n]
    cache = getattr(conn, "_device_program_cache", None)
    if cache is None:
        cache = {}
        conn._device_program_cache = cache
    key = plan_key + (id(xc), id(dim_xc), id(lookup))
    ent = cache.get(key)
    if ent is None:
        lookup_t = torch.from_numpy(lookup.astype(np.int64)).to(device)
        gather = _join_prologue(lowerer, dim_rows, fact_key, kmax_dim, outer)

        def prologue(c):
            c["__lookup__"], c["__dimxc__"] = lookup_t, dim_xc
            return gather(c)

        ent = (xc, dim_xc, lookup, _build_program(
            where_fn, key_fns, strides, n_groups, agg_plans, {}, n, device,
            prologue=prologue, validity=agg_validity))
        if len(cache) >= 16:
            cache.pop(next(iter(cache)))
        cache[key] = ent  # the VALUE pins the blocks and the lookup
    phases["upload_ms"] += _ms(t0)
    t0 = time.perf_counter()
    try:
        results, count, kmins, kmaxs, fracs, trip = _to_host(ent[3](cols))
    except (_Unsupported, OnnxError):
        return None
    phases["exec_ms"] = _ms(t0)
    return None if trip else (results, count, kmins, kmaxs, fracs)


def try_execute_join_on_device(conn, sel: A.Select, analyze_only: bool = False):
    """Run a join-aggregate SELECT on the device; a Table or None (the host
    executor answers).

    The join tiers in ``infera_tpu``'s order: the fact→dim tiers
    (``_try_join_tiers``: K5, then the torch join program), then, for a
    join they decline, the big×big shuffle join
    (``shuffle_join_plan.try_execute_shuffle_join``, looked up at call time;
    ``conn._shuffle_join_used``, path ``shuffle_join``). ``infera_tpu``'s
    executor calls the two in turn; here one entry holds both, so a caller
    that turns the join tiers away reaches the host join. With
    ``analyze_only`` returns the tier's name ("kernel K5", "torch join
    program" or "shuffle join") or None."""
    conn._shuffle_join_used = False
    out = _try_join_tiers(conn, sel, analyze_only)
    if out is not None:
        return out
    out = shuffle_join_plan.try_execute_shuffle_join(conn, sel, analyze_only)
    if analyze_only:
        return "shuffle join" if out else None
    conn._shuffle_join_used = out is not None
    return out


def _try_join_tiers(conn, sel: A.Select, analyze_only: bool = False):
    """Run a fact→dim join-aggregate SELECT on the device; a Table or None
    (the shuffle join or the host executor answers).

    The tiers run in ``infera_tpu``'s order: kernel K5 where
    ``FS.tier_enabled`` (``conn._cuda_plan_used``; path
    ``device_join_plan_cuda``), then the torch join program for a plan K5
    declines or with K5 off (path ``device_join_plan``). With
    ``analyze_only`` returns the tier's name ("kernel K5" or "torch join
    program") or None after eligibility checking and lowering, without
    touching the device (EXPLAIN). Records the phases (plan_ms, upload_ms,
    exec_ms: the tier's run with the read back, assemble_ms, and phantom_ms
    for FULL) on ``conn._last_phases``."""
    t0 = time.perf_counter()
    phases: dict = {}
    conn._cuda_plan_used = False
    conn._mesh_plan_used = False
    j = sel.from_
    if (
        not isinstance(j, A.Join)
        or j.kind not in ("INNER", "LEFT", "RIGHT", "FULL")
        or not isinstance(j.left, A.BaseTable)
        or not isinstance(j.right, A.BaseTable)
        or sel.having is not None
        or sel.distinct
        or len(sel.group_by) > 4
    ):
        return None
    outer = j.kind != "INNER"
    full = j.kind == "FULL"
    # FULL runs as a LEFT pass on the device plus the phantom side on the
    # host: dim rows with no fact match, every fact column NULL
    cond = j.on
    if j.using and len(j.using) == 1 and cond is None:
        cond = A.Binary("=", A.ColumnRef(j.using[0], j.left.alias or j.left.name),
                        A.ColumnRef(j.using[0], j.right.alias or j.right.name))
    if not (
        isinstance(cond, A.Binary)
        and cond.op == "="
        and isinstance(cond.left, A.ColumnRef)
        and isinstance(cond.right, A.ColumnRef)
    ):
        return None
    lt = conn.catalog.tables.get(j.left.name.lower())
    rt = conn.catalog.tables.get(j.right.name.lower())
    if lt is None or rt is None:
        return None  # missing table → host path raises the catalog error

    def names_of(ref):
        return {ref.name, ref.alias} if ref.alias else {ref.name}

    def key_col_of(table, refs_names, keyref):
        if keyref.table and keyref.table.lower() not in {s.lower() for s in refs_names}:
            return None
        for k in table.columns:
            if k.split(".")[-1].lower() == keyref.name.lower():
                return table.columns[k]
        return None

    # orient: which side is the dimension (unique small int keys)? For an
    # outer join the preserved side MUST be the fact side (LEFT preserves
    # the left table, RIGHT the right)
    combos = [
        (lt, names_of(j.left), cond.left, rt, names_of(j.right), cond.right),
        (rt, names_of(j.right), cond.right, lt, names_of(j.left), cond.left),
    ]
    if j.kind == "LEFT":
        combos = combos[:1]
    elif j.kind == "RIGHT":
        combos = combos[1:]
    plan = None
    for fact, fnames, fkey_ref, dim, dnames, dkey_ref in combos:
        if not (MIN_DEVICE_ROWS <= fact.num_rows < (1 << 24)):
            continue
        if dim.num_rows > DIM_MAX_ROWS or dim.num_rows == 0:
            continue
        dk = key_col_of(dim, dnames, dkey_ref)
        fk = key_col_of(fact, fnames, fkey_ref)
        if dk is None or fk is None:
            continue
        if dk.validity is not None or fk.validity is not None:
            continue
        if dk.data.dtype.kind not in "iu" or fk.data.dtype.kind not in "iu":
            continue
        # fact keys outside int32 would alias mod 2**32 in infera_tpu's
        # int32 lookup and spuriously match dim keys
        if fk.data.size and (
            _int_range(fk)[0] < -(1 << 31) or _int_range(fk)[1] >= (1 << 31)
        ):
            continue
        dim_keys = _dim_key_lookup(dk)
        if dim_keys is None:
            continue  # out of range, or duplicate dim keys (row expansion)
        plan = (fact, fnames, fkey_ref, dim, dnames, dim_keys)
        break
    if plan is None:
        return None
    fact, fnames, fkey_ref, dim, dnames, (dvals, kmax_dim, lookup) = plan

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
                return None  # DISTINCT aggregates stay on the host path
            items_plan.append(("agg", e))
        elif sel.group_by and e in sel.group_by:
            items_plan.append(("key", sel.group_by.index(e)))
        else:
            return None

    device = get_device()
    lowerer = _JoinLowerer(fact, fnames, dim, dnames, device)

    def _float_only(expr: A.Expr) -> bool:
        """sum/avg/min/max run on f32 values: only over float columns
        (integer sums need exact arithmetic; the host keeps those)."""
        ok = True

        def walk(e):
            nonlocal ok
            if isinstance(e, A.ColumnRef):
                try:
                    key = lowerer._column(e.name, e.table)
                except _Unsupported:
                    ok = False
                    return
                t = lowerer.col_for_key(key).sql_type
                if not (t.is_float or t.name == "DECIMAL"):
                    ok = False
            if isinstance(e, A.FuncCall):
                if e.name.lower() == "infera_predict":
                    return
                for a in e.args:
                    if isinstance(a, A.Expr):
                        walk(a)
                return
            for attr in ("operand", "left", "right", "low", "high"):
                child = getattr(e, attr, None)
                if isinstance(child, A.Expr):
                    walk(child)

        walk(expr)
        return ok

    try:
        fact_key = lowerer._column(fkey_ref.name, fkey_ref.table)
        if fact_key.startswith("__dim__."):
            raise _Unsupported("join key resolution crossed sides")
        if outer and sel.where is not None and lowerer.validity(sel.where) == "matched":
            # three-valued logic over NULL-able predicates (e.g. dim_col
            # inside OR) is beyond the static lattice — host path
            return None
        where_fn = lowerer.lower(sel.where) if sel.where is not None else None
        key_fns = [lowerer.lower(g) for g in sel.group_by]
        if key_fns and not _group_keys_int32_safe(lowerer, sel.group_by):
            return None
        if outer and any(lowerer.validity(g) == "matched" for g in sel.group_by):
            return None  # NULL group keys for unmatched rows → host
        agg_plans = []
        agg_validity = []  # parallel: "all" | "matched" input rows
        for kind, node in items_plan:
            if kind == "key":
                agg_plans.append(("key", node))
                agg_validity.append("all")
                continue
            name = node.name.lower()
            if name not in ("count", "sum", "avg", "mean", "min", "max"):
                return None  # var/stddev family: single-table plans only
            if full and name in ("avg", "mean"):
                return None  # finalized avgs don't combine with phantoms
            if node.is_star or not node.args:
                if name != "count":
                    return None
                agg_plans.append(("count_star", None))
                agg_validity.append("all")
            else:
                if name != "count" and not _float_only(node.args[0]):
                    return None
                v = lowerer.validity(node.args[0]) if outer else "all"
                if name == "count" and v == "matched":
                    # count(non-null expr): count only matched rows
                    agg_plans.append(("count_matched", None))
                    agg_validity.append(v)
                    continue
                agg_plans.append((name, lowerer.lower(node.args[0])))
                agg_validity.append(v)
    except (_Unsupported, OnnxError, SqlError):
        return None

    n = fact.num_rows
    # group sizing: plain column refs probe host-side; anything else uses
    # the guarded MAX_GROUPS fallback
    n_groups = 1
    strides = [1] * len(key_fns)
    if key_fns:
        try:
            radices = []
            for g in sel.group_by:
                if not isinstance(g, A.ColumnRef):
                    raise ValueError
                col = lowerer.col_for_key(lowerer._column(g.name, g.table))
                if not len(col.data):
                    kmax = 0
                elif col.data.dtype.kind in "iu":
                    kmax = max(_int_range(col)[1], 0)
                else:
                    kmax = int(np.max(np.maximum(np.asarray(col.data, np.int64), 0)))
                radices.append(kmax + 1)
            domain = 1
            for r in radices:
                domain = min(domain * r, 1 << 40)
            for i in range(len(radices) - 2, -1, -1):
                strides[i] = strides[i + 1] * radices[i + 1]
            n_groups = 8
            while n_groups < domain and n_groups < MAX_GROUPS:
                n_groups <<= 1
        except ValueError:
            for i in range(len(key_fns) - 2, -1, -1):
                strides[i] = strides[i + 1] * MAX_GROUPS
            n_groups = MAX_GROUPS

    mesh = MP.get_mesh(conn)
    k5 = None
    if FS.tier_enabled(device) and mesh is None:   # with a mesh set K5 does not run
        k5 = _lower_k5(sel, fact, fnames, dim, dnames, fkey_ref, n_groups, agg_plans,
                       items_plan, outer, agg_validity)
    if analyze_only:
        return ("torch join program on the mesh" if mesh is not None
                else "kernel K5" if k5 is not None else "torch join program")

    plan_key = (
        "join", repr(sel),
        tuple(sorted((k, c.data.dtype.str, len(c))
                     for k, c in lowerer.used_columns.items())),
        tuple(sorted((k, c.data.dtype.str, len(c))
                     for k, c in lowerer.dim_used.items())),
        tuple(sorted((name, id(m)) for name, m in lowerer.models.items())),
        n, n_groups, kmax_dim,
    )
    phases["plan_ms"] = _ms(t0)
    t0 = time.perf_counter()
    blocks = (get_table_block(fact, device), get_table_block(dim, device))
    phases["upload_ms"] = _ms(t0)
    t0 = time.perf_counter()
    out = None
    conn._mesh_decline = None
    if mesh is not None:
        conn._mesh_decline = MP.mesh_declines(mesh, n, n_groups, agg_plans,
                                              validity=agg_validity)
    if mesh is not None and conn._mesh_decline is None:
        fact_block = (None, {}) if blocks[0] is None else blocks[0]
        out = _run_join_mesh(conn, mesh, lowerer, fact, fact_key, (fact_block, blocks[1]), lookup,
                             kmax_dim, n, outer, where_fn, key_fns, strides, n_groups, agg_plans,
                             agg_validity, phases)
        phases["mesh_exec_ms"] = _ms(t0)
        if out is None:
            return None   # a guard tripped in the program: the host answers
        conn._mesh_plan_used = True
    if k5 is not None and blocks[0] is not None:
        out = _try_cuda_join(conn, k5, dim, lookup, kmax_dim, n, n_groups, strides,
                             plan_key, blocks)
        if out is _TRIPPED:
            return None  # the program's bucketing would trip the same guard
        phases["exec_ms"] = _ms(t0)
        conn._cuda_plan_used = out is not None
    if out is None:
        # the dim key keeps the dim block; a fact table of wide integers
        # alone has none
        blocks = ((None, {}) if blocks[0] is None else blocks[0], blocks[1])
        out = _run_join_program(conn, lowerer, fact, fact_key, blocks, lookup, kmax_dim, n,
                                outer, where_fn, key_fns, strides, n_groups, agg_plans,
                                agg_validity, plan_key, device, phases)
        if out is None:
            return None
    t0 = time.perf_counter()
    out_table = _assemble_result(sel, items_plan, agg_plans, [], *out,
                                 has_keys=bool(key_fns))
    phases["assemble_ms"] = _ms(t0)
    if out_table is None:
        conn._cuda_plan_used = False
        conn._mesh_plan_used = False
        return None  # collision/frac guard or a NULL-producing group → host path
    if full:
        t0 = time.perf_counter()
        try:
            out_table = _combine_full_phantom(conn, sel, out_table, items_plan, lowerer, fact,
                                              fnames, fact_key, dim, dnames, dvals)
        except Exception:
            conn._cuda_plan_used = False
            conn._mesh_plan_used = False
            return None  # a phantom-side oddity (host evaluation) → host path, as infera_tpu
        phases["phantom_ms"] = _ms(t0)
    conn._last_phases = phases
    return out_table


def _norm_key(v):
    """Canonical group-key value for device↔phantom row matching: device
    keys render as int64/float64, phantom keys come back as Python
    scalars — map both onto (None | int | float) with int-valued floats
    collapsed to int."""
    if v is None:
        return None
    f = float(v)
    return int(f) if f.is_integer() else f


def _combine_full_phantom(conn, sel, out, items_plan, lowerer, fact, fnames,
                          fact_key, dim, dnames, dvals):
    """FULL join = the kernel's LEFT pass + the phantom side: dim rows with
    no fact match contribute one row each with every fact column NULL. The
    phantom side is at most |dim| rows, so it evaluates host-side with the
    full 3VL evaluator: the WHERE predicate filters phantom rows (NULL
    fact columns eliminate most predicates, but e.g. coalesce keeps rows),
    GROUP BY keys are evaluated per phantom row (fact-sourced keys go
    NULL), and each phantom group merges into the device group table —
    matching key tuples combine (count/sum add, min/max meet; avg was
    excluded at plan time), new key tuples append as new result rows."""
    from ..columnar import Column, Table
    from .executor import Scope

    fk_host = np.asarray(lowerer.used_columns[fact_key].data, np.int64)
    unmatched = ~np.isin(dvals, fk_host)
    n_ph = int(unmatched.sum())
    if n_ph == 0:
        return out
    cols: dict = {}
    fact_bares = {k.split(".")[-1].lower() for k in fact.columns}
    for k, c in dim.columns.items():
        bare = k.split(".")[-1]
        pc = Column(np.asarray(c.data)[unmatched], c.sql_type,
                    None if c.validity is None else
                    np.asarray(c.validity)[unmatched])
        for alias in dnames:
            cols[f"{alias}.{bare}"] = pc
        if bare.lower() not in fact_bares:
            cols[bare] = pc
    dim_bares = {k.split(".")[-1].lower() for k in dim.columns}
    for k, c in fact.columns.items():
        bare = k.split(".")[-1]
        nc = Column(np.zeros(n_ph, c.data.dtype), c.sql_type,
                    np.zeros(n_ph, bool))
        for alias in fnames:
            cols[f"{alias}.{bare}"] = nc
        if bare.lower() not in dim_bares:
            cols[bare] = nc
    scope = Scope(Table(cols))
    if sel.where is not None:
        # host 3VL: only rows where the predicate is TRUE (not NULL) stay
        wc = conn._eval(sel.where, scope)
        keep = wc.valid_mask() & np.asarray(wc.data, bool)
        if not keep.all():
            n_ph = int(keep.sum())
            if n_ph == 0:
                return out
            cols = {k: c.filter(keep) for k, c in
                    scope.table.columns.items()}
            scope = Scope(Table(cols))

    # evaluate each aggregate's argument once over the whole phantom side
    arg_cols = []
    for kind, node in items_plan:
        if kind == "key" or node.is_star or not node.args:
            arg_cols.append(None)
        else:
            arg_cols.append(conn._eval(node.args[0], scope))

    def agg_over(rows_idx, node, pc, dev_v):
        """Combine one aggregate over the phantom rows rows_idx with the
        device value dev_v (None for a fresh group)."""
        agg = node.name.lower()
        if node.is_star or not node.args:
            return (dev_v or 0) + len(rows_idx)
        valid = pc.valid_mask()[rows_idx]
        vals = np.asarray(pc.data, np.float64)[rows_idx][valid]
        if agg == "count":
            return (dev_v or 0) + int(valid.sum())
        if len(vals) == 0:
            return dev_v
        if agg == "sum":
            return (0.0 if dev_v is None else dev_v) + float(vals.sum())
        if agg == "min":
            return float(vals.min()) if dev_v is None else min(
                dev_v, float(vals.min()))
        if agg == "max":
            return float(vals.max()) if dev_v is None else max(
                dev_v, float(vals.max()))
        raise ValueError(agg)

    out_names = list(out.columns)
    out_cols = list(out.columns.values())
    if not sel.group_by:
        all_rows = np.arange(n_ph)
        new_cols = {}
        for (kind, node), name_out, col, pc in zip(
                items_plan, out_names, out_cols, arg_cols):
            v = agg_over(all_rows, node, pc, col.value(0))
            new_cols[name_out] = Column.from_values([v], col.sql_type)
        return Table(new_cols)

    # --- grouped combine -------------------------------------------------
    key_cols = [conn._eval(g, scope) for g in sel.group_by]
    groups: dict = {}
    for i in range(n_ph):
        kt = tuple(_norm_key(kc.value(i)) for kc in key_cols)
        groups.setdefault(kt, []).append(i)
    # device rows keyed by their group-key tuple (items_plan "key" slots);
    # the device pass only fuses when every group key appears among the
    # select items, so key_slots covers sel.group_by exactly
    key_slots = [si for si, (kind, _n) in enumerate(items_plan)
                 if kind == "key"]
    slot_order = sorted(key_slots, key=lambda si: items_plan[si][1])
    n_dev = out.num_rows
    dev_index = {}
    for r in range(n_dev):
        kt = tuple(_norm_key(out_cols[si].value(r)) for si in slot_order)
        dev_index[kt] = r
    values = [[c.value(r) for r in range(n_dev)] for c in out_cols]
    for kt, rows_idx in groups.items():
        rows_idx = np.asarray(rows_idx)
        r = dev_index.get(kt)
        if r is None:
            r = len(values[0]) if values else 0
            for si, (kind, _node) in enumerate(items_plan):
                values[si].append(
                    kt[slot_order.index(si)] if kind == "key" else None)
            dev_index[kt] = r
        for si, ((kind, node), pc) in enumerate(zip(items_plan, arg_cols)):
            if kind == "key":
                continue
            values[si][r] = agg_over(rows_idx, node, pc, values[si][r])
    new_cols = {}
    for si, (name_out, col) in enumerate(zip(out_names, out_cols)):
        styp = col.sql_type
        kind = items_plan[si][0]
        if kind == "key" and any(
                v is not None and not float(v).is_integer()
                for v in values[si]):
            from ..columnar import types as T
            styp = T.DOUBLE
        new_cols[name_out] = Column.from_values(values[si], styp)
    return Table(new_cols)
