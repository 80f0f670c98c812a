"""Big×big shuffle join (BASELINE config 5's missing half).

Counterpart of ``infera_tpu/sql/shuffle_join_plan.py``. Query shape: ``SELECT aggs
FROM A JOIN B ON A.k = B.k [WHERE ...] [GROUP BY A-side int keys]`` where
both sides are large fact tables with arbitrary (duplicate, skewed) integer
join keys: the shape ``device_join_plan`` declines (it needs a unique-key
dimension side) and the host join would expand into pairs.

No pair is built: the join-aggregate decomposes through per-key partials,

    count(*)              = Σ_a |B_{k(a)}|
    sum of pure-A f(a)    = Σ_a f(a)·|B_{k(a)}|
    sum of pure-B g(b)    = Σ_a sumB_g[k(a)]
    sum of f(a)·g(b)      = Σ_a f(a)·sumB_g[k(a)]
    min/max over pairs    = the meet of the per-side per-key extremes

1. **B pre-pass** (once per plan, cached): the B-side WHERE, one stable
   device sort of the keys (``INT32_MAX`` for the rows the WHERE drops),
   the unique keys and, per key, an int64 count, f64 sums, f32 minima and
   maxima.
2. **A pass in ``A_CHUNK_ROWS`` chunks** (``ops/streaming.stream_query``):
   ``torch.searchsorted`` finds each A row's key among the unique keys, the
   row's pair count is that key's count (int64, exact), and the row's
   partials reduce into the group table, which folds on the device and
   comes back in one copy.

A hot key costs O(|A_k| + |B_k|), not O(|A_k|·|B_k|), so the plan is
linear in |A| + |B| for any key distribution. ``infera_tpu`` carries pair
counts in 8-bit limbs and products in compensated f32 pairs; the card has
int64 and f64. A zero-pair global group renders NULL. Anything outside the
shape returns None, and the host join keeps the full semantics.

With a mesh set (``sql/mesh_plan.get_mesh``; path ``shuffle_join_mesh``)
both sides hash-exchange by join key: B pre-reduced to per-key records on
each shard before its exchange (``_b_mesh``: a hot key sends at most one
record from each shard), each A chunk's rows to the owner of their key
(``_a_pass_mesh``), each owner's pre-aggregated join against its own
per-key table, and the owners' ``[G]`` partials merged; pair counts stay
int64.
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
from ..parallel import shuffle
from . import ast as A
from . import mesh_plan as MP
from .device_plan import (_AGG_NAMES, _find_aggs, _find_column_refs, _full, _int_range, _ms,
                          _to_host, _Unsupported)
from .streaming_plan import (_ChunkLowerer, _float_only, column_sources, combined_keys, fold,
                             group_sizing, mesh_merge, render)

SHUFFLE_JOIN_MIN_ROWS = 1 << 15
A_CHUNK_ROWS = 1 << 20
INT32_MAX = (1 << 31) - 1

_SUMS = ("sum", "avg", "mean")


def _split_conjuncts(expr):
    if isinstance(expr, A.Binary) and expr.op == "AND":
        return _split_conjuncts(expr.left) + _split_conjuncts(expr.right)
    return [expr]


def _product_factors(expr):
    if isinstance(expr, A.Binary) and expr.op == "*":
        return _product_factors(expr.left) + _product_factors(expr.right)
    return [expr]


def _chain(exprs, op):
    out = exprs[0]
    for e in exprs[1:]:
        out = A.Binary(op, out, e)
    return out


def _upload(data: np.ndarray, device) -> torch.Tensor:
    """A host column on the device (a read-only memmap is copied first)."""
    if not data.flags.writeable:
        data = np.array(data)
    return torch.from_numpy(np.ascontiguousarray(data)).to(device)


def _orient(sel, j, cond, lt, rt, items_plan):
    """``infera_tpu``'s orientation and eligibility: the first of (left as
    A, right as A) whose sides are both large, whose join keys are plain
    integer columns without NULLs inside int32 (``INT32_MAX`` excluded: the
    sort's filler), whose GROUP BY keys are A-side integer columns, whose
    WHERE conjuncts each read one side and whose aggregates each read one
    side or multiply an A factor by a B factor. Returns the plan tuple or
    None."""

    def names_of(ref):
        out = {ref.name.lower()}
        if ref.alias:
            out.add(ref.alias.lower())
        return out

    def col_of(table, refs_names, keyref):
        if keyref.table and keyref.table.lower() not in refs_names:
            return None
        for k in table.columns:
            if k.split(".")[-1].lower() == keyref.name.lower():
                return table.columns[k]
        return None

    lnames, rnames = names_of(j.left), names_of(j.right)
    combos = [(lt, lnames, cond.left, rt, rnames, cond.right),
              (rt, rnames, cond.right, lt, lnames, cond.left)]
    for at, anames, akey_ref, bt, bnames, bkey_ref in combos:
        if at.num_rows < SHUFFLE_JOIN_MIN_ROWS or bt.num_rows < SHUFFLE_JOIN_MIN_ROWS:
            continue
        ak = col_of(at, anames, akey_ref)
        bk = col_of(bt, bnames, bkey_ref)
        if ak is None or bk is None or ak.validity is not None or bk.validity is not None:
            continue
        if ak.data.dtype.kind not in "iu" or bk.data.dtype.kind not in "iu":
            continue
        (alo, ahi), (blo, bhi) = _int_range(ak), _int_range(bk)
        if min(alo, blo) < -(1 << 31) or max(ahi, bhi) >= INT32_MAX:
            continue

        def side_of_ref(ref, at=at, anames=anames, bt=bt, bnames=bnames):
            q = ref.table.lower() if ref.table else None
            in_a = (q is None or q in anames) and col_of(at, anames, ref) is not None
            in_b = (q is None or q in bnames) and col_of(bt, bnames, ref) is not None
            if in_a and in_b:
                raise _Unsupported(f"ambiguous column {ref.name}")
            if in_a:
                return "a"
            if in_b:
                return "b"
            raise _Unsupported(f"unknown column {ref.name}")

        def side_of_expr(expr, side_of_ref=side_of_ref):
            refs: list = []
            _find_column_refs(expr, refs)
            sides = {side_of_ref(r) for r in refs}
            if len(sides) > 1:
                raise _Unsupported("expression spans both join sides")
            return sides.pop() if sides else "a"

        try:
            # group keys: plain A-side integer column refs (the streaming rule)
            if not all(isinstance(g, A.ColumnRef) and side_of_expr(g) == "a" for g in sel.group_by):
                continue
            gcols = [col_of(at, anames, g) for g in sel.group_by]
            if any(c is None or c.validity is not None or c.data.dtype.kind not in "iu"
                   for c in gcols):
                continue
            a_wheres, b_wheres = [], []
            if sel.where is not None:
                for cj in _split_conjuncts(sel.where):
                    (a_wheres if side_of_expr(cj) == "a" else b_wheres).append(cj)
            specs = []  # parallel to items_plan: (name, side, arg)
            for kind, node in items_plan:
                if kind == "key":
                    specs.append(("key", None, node))
                    continue
                name = node.name.lower()
                if name not in ("count", "sum", "avg", "mean", "min", "max"):
                    raise _Unsupported(name)
                if node.is_star or not node.args:
                    if name != "count":
                        raise _Unsupported(name)
                    specs.append(("count_star", None, None))
                    continue
                try:
                    side = side_of_expr(node.args[0])
                except _Unsupported:
                    # a mixed-side product sum: sum(f(a)*g(b)) = Σ_a f(a)·sumB_g[k(a)]
                    if name not in _SUMS:
                        raise
                    fs = _product_factors(node.args[0])
                    sides = [side_of_expr(f) for f in fs]
                    a_fs = [f for f, s in zip(fs, sides) if s == "a"]
                    b_fs = [f for f, s in zip(fs, sides) if s != "a"]
                    if not a_fs or not b_fs:
                        raise
                    specs.append((f"ab{name}", "ab", (_chain(a_fs, "*"), _chain(b_fs, "*"))))
                    continue
                # count(expr) is the pair count only when the argument is
                # never NULL: the lowering below checks it
                specs.append(("count_arg" if name == "count" else name, side, node.args[0]))
            return at, ak, bt, bk, a_wheres, b_wheres, specs
        except _Unsupported:
            continue
    return None


class _Plan:
    """The lowered plan: each side's lowerer and WHERE, the group keys, the
    B slots (sums, minima, maxima, product sums) and agg_plans, one
    ``(name, payload)`` a select item."""

    def __init__(self, sel, at, bt, a_wheres, b_wheres, specs, device):
        self.a_low = _ChunkLowerer(at, device)
        self.b_low = _ChunkLowerer(bt, device)
        self.a_where = self.a_low.lower(_chain(a_wheres, "AND")) if a_wheres else None
        self.b_where = self.b_low.lower(_chain(b_wheres, "AND")) if b_wheres else None
        self.key_keys = [self.a_low._column(g.name, g.table) for g in sel.group_by]
        self.b_fns = {"sum": [], "min": [], "max": [], "csum": []}
        self.agg_plans = []
        for pname, side, arg in specs:
            if pname in ("key", "count_star"):
                self.agg_plans.append((pname, arg))
            elif pname == "count_arg":
                low = self.a_low if side == "a" else self.b_low
                if isinstance(arg, A.ColumnRef):
                    low._column(arg.name, arg.table)   # raises on a nullable column
                else:
                    low.lower(arg)
                self.agg_plans.append(("count_star", None))
            elif side == "ab":
                a_expr, b_expr = arg
                if not (_float_only(self.a_low, a_expr) and _float_only(self.b_low, b_expr)):
                    raise _Unsupported("integer factor in a product sum")
                self.agg_plans.append((pname, (self.a_low.lower(a_expr),
                                               self._b_slot("csum", b_expr))))
            elif side == "a":
                if not _float_only(self.a_low, arg):
                    raise _Unsupported("integer A argument")
                self.agg_plans.append((f"a{pname}", self.a_low.lower(arg)))
            else:
                if not _float_only(self.b_low, arg):
                    raise _Unsupported("integer B argument")
                slot = "sum" if pname in _SUMS else pname
                self.agg_plans.append((f"b{pname}", self._b_slot(slot, arg)))

    def _b_slot(self, kind, expr) -> int:
        self.b_fns[kind].append(self.b_low.lower(expr))
        return len(self.b_fns[kind]) - 1


def _b_prepass(plan: _Plan, bt: Table, bk, device, rows: slice = slice(None)) -> dict:
    """The B side's per-key table over its rows ``rows``: unique keys ``uk``
    (ascending int64), the count of rows the WHERE keeps a key (``cnt``),
    and per slot the f64 sums, f32 minima and maxima and f64 product sums
    of those rows."""
    keys = sorted(plan.b_low.f32_columns)
    arrays, src = column_sources({k: bt.columns[k].data[rows] for k in keys})
    bkeys = bk.data[rows]
    nb = len(bkeys)
    dev = [_upload(a, device) for a in arrays]
    cols = {k: dev[src[k]].float() for k in keys}
    cols["__n__"], cols["__pred__"] = nb, {}
    vb = torch.ones(nb, dtype=torch.bool, device=device)
    if plan.b_where is not None:
        vb = vb & (_full(plan.b_where(cols), nb) != 0)   # NaN is true
    ks = torch.where(vb, _upload(bkeys, device).long(), INT32_MAX)
    ks_s, order = torch.sort(ks, stable=True)
    uk, uidx, counts = torch.unique_consecutive(ks_s, return_inverse=True, return_counts=True)
    U = uk.numel()
    vb_s = vb[order]
    out = {"uk": uk, "cnt": torch.where(uk == INT32_MAX, 0, counts)}
    vals = {kind: [_full(fn(cols), nb)[order] for fn in fns] for kind, fns in plan.b_fns.items()}
    out["sum"] = [GG.segment_sum(v, uidx, U) for v in vals["sum"]]
    out["csum"] = [GG.segment_sum(v, uidx, U) for v in vals["csum"]]
    out["min"] = [GG.segment_minmax([v], uidx, U, [vb_s])[0][0] for v in vals["min"]]
    out["max"] = [GG.segment_minmax([v], uidx, U, [vb_s])[1][0] for v in vals["max"]]
    return out


def try_execute_shuffle_join(conn, sel: A.Select, analyze_only: bool = False):
    """Run a big×big join-aggregate; a Table or None (the host join
    answers). With ``analyze_only`` returns True after eligibility checking
    and lowering (EXPLAIN). Records the phases on ``conn._last_phases``:
    plan_ms, b_prepass_ms (0 when cached), a_stream_ms (of it stage_ms,
    upload_ms, compute_ms as in ``streaming_plan``), assemble_ms."""
    t0 = time.perf_counter()
    phases: dict = {}
    j = sel.from_
    if (
        not isinstance(j, A.Join)
        or j.kind != "INNER"
        or not isinstance(j.left, A.BaseTable)
        or not isinstance(j.right, A.BaseTable)
        or sel.having is not None
        or sel.distinct
        or len(sel.group_by) > 4
    ):
        return None
    cond = j.on
    if j.using and len(j.using) == 1 and cond is None:
        cond = A.Binary("=", A.ColumnRef(j.using[0], j.left.alias or j.left.name),
                        A.ColumnRef(j.using[0], j.right.alias or j.right.name))
    if not (isinstance(cond, A.Binary) and cond.op == "="
            and isinstance(cond.left, A.ColumnRef) and isinstance(cond.right, A.ColumnRef)):
        return None
    lt = conn.catalog.tables.get(j.left.name.lower())
    rt = conn.catalog.tables.get(j.right.name.lower())
    if lt is None or rt is None:
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
                return None
            items_plan.append(("agg", e))
        elif sel.group_by and e in sel.group_by:
            items_plan.append(("key", sel.group_by.index(e)))
        else:
            return None

    oriented = _orient(sel, j, cond, lt, rt, items_plan)
    if oriented is None:
        return None
    at, ak, bt, bk, a_wheres, b_wheres, specs = oriented
    device = get_device()
    try:
        plan = _Plan(sel, at, bt, a_wheres, b_wheres, specs, device)
    except (_Unsupported, OnnxError, SqlError):
        return None
    if analyze_only:
        return True

    # group sizing (host probe, the streaming rule)
    ranges = [_int_range(at.columns[k]) for k in plan.key_keys]
    if any(lo < 0 or hi >= (1 << 31) for lo, hi in ranges):
        return None
    n_groups, strides = group_sizing(ranges)
    phases["plan_ms"] = _ms(t0)
    t0 = time.perf_counter()

    G = n_groups
    a_f32 = sorted(plan.a_low.f32_columns)
    named = {k: at.columns[k].data for k in a_f32 + plan.key_keys}
    named["__akey__"] = ak.data
    arrays, src = column_sources(named)
    kinds = ["add"] + ["min", "max"] * len(plan.key_keys)
    for pname, _ in plan.agg_plans:
        if pname in ("amin", "bmin"):
            kinds.append("min")
        elif pname in ("amax", "bmax"):
            kinds.append("max")
        elif pname not in ("key", "count_star"):
            kinds.append("add")

    # the B side's per-key tables, cached per plan (per mesh with a mesh
    # set: each local owner's merged table)
    conn._mesh_plan_used = False
    mesh = MP.get_mesh(conn)
    if mesh is not None and min(at.num_rows, bt.num_rows) < mesh.shape["dp"]:
        mesh = None   # fewer rows than shards: one device
    cache = getattr(conn, "_shuffle_join_cache", None)
    if cache is None:
        cache = conn._shuffle_join_cache = {}
    bkey = ("sjoin_b", repr(sel), id(bt), bt.num_rows, tuple(sorted(plan.b_low.f32_columns)),
            tuple(sorted((nm, id(m)) for nm, m in plan.b_low.models.items())), str(device),
            None if mesh is None else ("mesh", id(mesh)))
    ent = cache.get(bkey)
    try:
        if ent is None or ent[1] is not mesh:
            b = (_b_prepass(plan, bt, bk, device) if mesh is None
                 else _b_mesh(mesh, plan, bt, bk))
            ent = (bt, mesh, b)  # the VALUE pins the table and the mesh
            if len(cache) >= 16:
                cache.pop(next(iter(cache)))
            cache[bkey] = ent
    except (_Unsupported, OnnxError):
        return None
    b = ent[2]
    phases["b_prepass_ms"] = _ms(t0)
    t0 = time.perf_counter()

    if mesh is not None:
        try:
            acc = _a_pass_mesh(mesh, plan, b, arrays, src, a_f32, strides, G, kinds, phases)
        except (_Unsupported, OnnxError):
            return None
        conn._mesh_plan_used = True
        phases["a_stream_ms"] = _ms(t0)
        return _finish(conn, sel, items_plan, plan, acc, phases, time.perf_counter())
    stats: dict = {}
    try:
        acc = S.stream_query(S.chunked(tuple(arrays), A_CHUNK_ROWS),
                             _a_step(plan, b, src, a_f32, strides, G, device),
                             fold(kinds), None, device=device, stats=stats)
    except (_Unsupported, OnnxError):
        return None
    phases["a_stream_ms"] = _ms(t0)
    phases.update({k: (round(v, 3) if isinstance(v, float) else v) for k, v in stats.items()})
    return _finish(conn, sel, items_plan, plan, acc, phases, time.perf_counter())


def _finish(conn, sel, items_plan, plan, acc, phases, t0):
    """The folded partials read back in one copy and rendered."""
    res = iter(_to_host(acc))
    count64 = next(res)
    kmin, kmax = [], []
    for _ in plan.key_keys:
        kmin.append(next(res))
        kmax.append(next(res))
    outs = [None if p in ("key", "count_star") else next(res) for p, _ in plan.agg_plans]
    out = _assemble(sel, items_plan, plan.agg_plans, outs, count64, kmin, kmax,
                    bool(plan.key_keys))
    phases["assemble_ms"] = _ms(t0)
    if out is not None:
        conn._last_phases = phases
    return out


def _a_step(plan, b, src, a_f32, strides, G, device):
    """The A pass's step over one chunk (``chunk`` tensors of the arrays
    ``src`` indexes, on ``device``) against the per-key table ``b``: each
    row's pair count and partials reduced into the group table. ``valid``
    (optional) drops padding rows."""
    U = b["uk"].numel()

    def step(*chunk, valid=None):
        m = chunk[0].shape[0]
        cols = {k: chunk[src[k]].float() for k in a_f32}
        cols["__n__"], cols["__pred__"] = m, {}
        mask = torch.ones(m, dtype=torch.bool, device=device) if valid is None else valid
        if plan.a_where is not None:
            mask = mask & (_full(plan.a_where(cols), m) != 0)
        ka = chunk[src["__akey__"]].long()
        idx = torch.searchsorted(b["uk"], ka).clamp_(0, U - 1)
        matched = (b["uk"][idx] == ka) & mask
        wi = torch.where(matched, b["cnt"][idx], 0)   # the row's pairs, int64
        live = wi > 0
        kcols = [chunk[src[k]].long() for k in plan.key_keys]
        keys = combined_keys(kcols, strides, G, m, device)
        slot = torch.where(live, keys, G)   # G: a row without pairs
        out = GG.segment_sum_int_exact([wi], slot, G)
        for kc in kcols:
            out += [g.long() for g in GG.segment_minmax_int32(kc, keys, G, live)]
        for pname, payload in plan.agg_plans:
            if pname in ("key", "count_star"):
                continue
            if pname in ("asum", "aavg", "amean"):
                out.append(GG.segment_sum(_full(payload(cols), m).double() * wi, slot, G))
            elif pname in ("bsum", "bavg", "bmean"):
                out.append(GG.segment_sum(b["sum"][payload][idx], slot, G))
            elif pname in ("absum", "abavg", "abmean"):
                a_fn, ci = payload
                out.append(GG.segment_sum(_full(a_fn(cols), m).double() * b["csum"][ci][idx],
                                          slot, G))
            elif pname in ("amin", "amax"):
                (mn,), (mx,) = GG.segment_minmax([_full(payload(cols), m)], slot, G)
                out.append(mn if pname == "amin" else mx)
            elif pname == "bmin":
                out.append(GG.segment_minmax([b["min"][payload][idx]], slot, G)[0][0])
            else:  # bmax
                out.append(GG.segment_minmax([b["max"][payload][idx]], slot, G)[1][0])
        return out

    return step


def _b_mesh(mesh, plan, bt, bk) -> list:
    """The B side over the mesh: each shard pre-reduces its rows to per-key
    records (``_b_prepass``), so a hot key sends at most one record from
    each shard; the records exchange to the owner ``key % dp``, which merges
    them into its own per-key table (counts and sums add, extremes meet).
    Returns each local owner's table."""
    dp = mesh.shape["dp"]
    per = -(-bt.num_rows // dp)
    recs = []
    for s, d in zip(mesh.local, mesh.local_devices):
        b = _b_prepass(plan, bt, bk, d, slice(s * per, (s + 1) * per))
        keep = torch.nonzero(b["cnt"] > 0).reshape(-1)
        cols = [b["uk"], b["cnt"], *b["sum"], *b["csum"], *b["min"], *b["max"]]
        recs.append([c[keep] for c in cols])
    parts = [torch.remainder(r[0], dp) for r in recs]
    cap = shuffle.bucket_cap(mesh, parts)
    sends, valids = [], []
    for part, r in zip(parts, recs):
        packed, send_valid = shuffle._pack_buckets(part, r, dp, cap)
        sends.append(packed)
        valids.append(send_valid)
    rvalid = M.all_to_all(mesh, valids)
    recv = [M.all_to_all(mesh, [p[i] for p in sends]) for i in range(len(recs[0]))]
    ns, nc = len(plan.b_fns["sum"]), len(plan.b_fns["csum"])
    tables = []
    for j, v in enumerate(rvalid):
        v = v.reshape(-1)
        got = [r[j].reshape(-1)[v] for r in recv]
        # a sentinel record keeps every owner's table non-empty
        uk = torch.cat([got[0], got[0].new_full((1,), INT32_MAX)])
        uk, inv = torch.unique(uk, sorted=True, return_inverse=True)
        inv = inv[:-1]
        U = uk.numel()
        (cnt,) = GG.segment_sum_int_exact([got[1]], inv, U)
        sums = [GG.segment_sum(x, inv, U) for x in got[2:2 + ns + nc]]
        exts = got[2 + ns + nc:]
        nm = len(plan.b_fns["min"])
        mins = [GG.segment_minmax([x], inv, U)[0][0] for x in exts[:nm]]
        maxs = [GG.segment_minmax([x], inv, U)[1][0] for x in exts[nm:]]
        tables.append({"uk": uk, "cnt": cnt, "sum": sums[:ns], "csum": sums[ns:],
                       "min": mins, "max": maxs})
    return tables


def _a_pass_mesh(mesh, plan, tables, arrays, src, a_f32, strides, G, kinds, phases):
    """The A pass of the shuffle join over the mesh (``infera_tpu``'s
    ``_execute_mesh``, after ``_b_mesh``): A in global chunks of
    ``A_CHUNK_ROWS × dp`` rows, each shard's part hash-exchanged by join
    key, each owner's step against its own per-key table ``tables[j]``, and
    the owners' group partials merged by psum, pmin and pmax. Returns the
    folded partials on the first local shard's device; records the
    exchange's share (``mesh_exchange_ms``, after a synchronise)."""
    dp = mesh.shape["dp"]
    steps = [_a_step(plan, b, src, a_f32, strides, G, d)
             for b, d in zip(tables, mesh.local_devices)]
    akey = src["__akey__"]
    exchange_ms = [0.0]

    def run(*chunk):
        te = time.perf_counter()
        per = -(-chunk[0].shape[0] // dp)
        parts, payloads = [], []
        for s, d in zip(mesh.local, mesh.local_devices):
            pay = [c[s * per:(s + 1) * per].to(d, non_blocking=True) for c in chunk]
            parts.append(torch.remainder(pay[akey].long(), dp))
            payloads.append(pay)
        cap = shuffle.bucket_cap(mesh, parts)
        sends, valids = [], []
        for part, pay in zip(parts, payloads):
            packed, send_valid = shuffle._pack_buckets(part, pay, dp, cap)
            sends.append(packed)
            valids.append(send_valid)
        rvalid = M.all_to_all(mesh, valids)
        recv = [M.all_to_all(mesh, [p[i] for p in sends]) for i in range(len(chunk))]
        M.synchronize(mesh)
        exchange_ms[0] += (time.perf_counter() - te) * 1e3
        outs = []
        for j, step in enumerate(steps):
            v = rvalid[j].reshape(-1)
            keep = torch.nonzero(v).reshape(-1)
            outs.append(step(*(r[j].reshape(-1)[keep] for r in recv)))
        return mesh_merge(mesh, outs, kinds)

    stats: dict = {}
    acc = S.stream_query(S.chunked(tuple(arrays), A_CHUNK_ROWS * dp), run, fold(kinds), None,
                         device=mesh.local_devices[0], stats=stats)
    phases.update({k: (round(v, 3) if isinstance(v, float) else v) for k, v in stats.items()})
    phases["mesh_exchange_ms"] = round(exchange_ms[0], 3)
    return acc


def _assemble(sel, items_plan, agg_plans, acc_outs, count64, acc_kmin, acc_kmax, has_keys):
    """``infera_tpu``'s ``_assemble``: count64 is the exact int64 pair count
    of each group (the avg divisor and the live-group mask); a key guard
    that trips returns None."""
    count64 = np.asarray(count64, np.int64)
    live = count64 > 0 if has_keys else np.array([True])
    for kmn, kmx in zip(acc_kmin, acc_kmax):
        if (kmn[live] != kmx[live]).any():
            return None  # the modulo bucket held distinct keys: the host answers
    out_cols: dict = {}
    c64 = count64[live]
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
            out_cols[name] = Column(acc_kmax[node][live].astype(np.int64), T.BIGINT)
            continue
        if pname == "count_star":
            out_cols[name] = Column(c64, T.BIGINT)
            continue
        # zero-pair groups render NULL (only the global group can have none)
        res = np.asarray(acc_outs[idx], np.float64)[live]
        if pname.endswith(("avg", "mean")):
            res = res / np.where(c64 == 0, 1, c64)
        out_cols[name] = render(res, T.DOUBLE, c64 == 0)
    return Table(out_cols)
