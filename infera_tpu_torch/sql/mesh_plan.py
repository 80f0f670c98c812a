"""Mesh-partitioned execution of the fused SQL plans.

Counterpart of ``infera_tpu/sql/mesh_plan.py``. With a data-parallel mesh
set (``Connection.set_mesh`` or ``INFERA_MESH=N``), the aggregate plans of
``device_plan`` and ``device_join_plan`` run over the mesh's shards
(``parallel/mesh.py``) instead of as one program on one device:

1. The table's columns upload once, row-sharded over ``dp`` and
   zero-padded to a multiple of the mesh, with a validity mask; each
   column as the single-device program reads it (a row of the f32 block, or
   int64 for the exact integer slots), cached on the Column per mesh.
   Replicated arrays (a join's dimension block and key lookup) go to every
   shard's device.
2. Each shard runs the plan's closures — WHERE, the join prologue,
   ``infera_predict``, the mixed-radix key — and reduces its rows into a
   ``[G]`` table of partials that merge by a sum, a minimum or a maximum:
   counts, int64 sums and extremes, f64 sums, the variance's (sum, M2)
   pair, DISTINCT presence and MODE count matrices, HLL registers, arg
   words, and the matched-row count of outer joins.
3. The partial tables exchange by owner ``repr_key % dp`` through
   ``parallel/shuffle._pack_buckets`` and one ``all_to_all`` a payload
   array (capacity G is exact under any skew); medians and quantiles send
   each selected row's value to the owner of its key instead, which sorts
   them as the single-device program does, so they equal its answer.
4. Each owner merges what it receives (segment reductions with an overflow
   slot for dead buckets), the merged tables are gathered in shard order
   and returned in the single-device contract ``(results, group_count,
   key_mins, key_maxs, frac_flags)``, ``[dp * G]`` long, which
   ``device_plan._finalize_agg`` and ``_assemble_result`` render.

``infera_tpu`` carries f32 partials with compensated pairs, 8-bit limbs,
``(hi, lo)`` words and an f32-sortable bisection because its TPU program
runs with x64 off; the card has int64 and f64, so the partials here are
those, and the variance merges its per-shard (count, sum, M2) exactly
(Chan et al.). A plan the mesh does not take is declined by explicit rule
(``mesh_declines``) and runs the single-device program; an error inside the
mesh program is raised, never swallowed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import fused_sql as FS
from ..ops import gemm_groupby as GG
from ..parallel import mesh as M
from ..parallel import shuffle
from . import int_agg

_UNSET = object()
_I64 = torch.iinfo(torch.int64)
# infera_tpu's exchange bound on the HLL register table (n_groups * 512)
HLL_MESH_MAX = 1 << 21
_MESH_AGGS = frozenset(
    {"key", "count", "count_star", "count_matched", "isum", "iavg", "imin", "imax", "hll",
     "sum", "avg", "mean", "var", "median", "quantile", "cif", "band", "bor", "min", "max",
     "prod", "argmn", "argmx", "mode", "dcount", "dsum", "davg"})
_SUMS = ("sum", "avg", "mean")


def get_mesh(conn):
    """The connection's dp mesh: ``set_mesh`` wins, else the read-once
    ``INFERA_MESH`` knob (a mesh of that many shards on the port's device),
    else None (one device)."""
    mesh = getattr(conn, "_mesh", _UNSET)
    if mesh is not _UNSET:
        return mesh
    from ..config import get_config

    n = get_config().mesh_devices
    mesh = M.make_mesh(n) if n and n > 1 else None
    conn._mesh = mesh
    return mesh


def mesh_declines(mesh, n: int, n_groups: int, agg_plans, dist_domains=None,
                  validity=None) -> str | None:
    """Why the mesh does not take a plan (the single-device program runs
    it), or None: fewer rows than shards, a slot the reference's mesh
    refuses (an aggregate other than count/sum/avg/min/max over an outer
    join's matched rows), an HLL register table past the exchange bound,
    DISTINCT or MODE without a value domain."""
    ndev = mesh.shape["dp"]
    if n < ndev:
        return f"{n} rows, fewer than the {ndev} shards"
    for ai, (name, _fn) in enumerate(agg_plans):
        if name not in _MESH_AGGS:
            return f"aggregate {name}"
        if validity is not None and validity[ai] == "matched" \
                and name not in _SUMS + ("min", "max", "count_matched"):
            return f"{name} over an outer join's matched rows"
        if name == "hll" and n_groups * 512 > HLL_MESH_MAX:
            return f"HLL registers of {n_groups} groups past the exchange bound"
        if name in ("dcount", "dsum", "davg", "mode") and not (dist_domains and ai in dist_domains):
            return f"{name} without a value domain"
    return None


def shard_column(col, mesh, n: int, kind: str) -> list:
    """Each local shard's rows of ``col`` on its device, ``kind`` "f32" (as
    the f32 table block holds it) or "i64", zero-padded; cached on the
    Column per mesh (the mesh pinned in the cache value)."""
    cache = col.__dict__.setdefault("_mesh_shards", {})
    key = (id(mesh), n, kind)
    ent = cache.get(key)
    if ent is None or ent[0] is not mesh:
        host = np.asarray(col.data, np.float32 if kind == "f32" else np.int64)
        ent = (mesh, M.shard_rows(mesh, host)[0])
        if len(cache) >= 4:
            cache.pop(next(iter(cache)))
        cache[key] = ent
    return ent[1]


def _valid_masks(conn, mesh, n: int) -> list:
    """The padding masks of an n-row table on the mesh, cached per mesh."""
    cache = conn.__dict__.setdefault("_mesh_valid_cache", {})
    key = (id(mesh), n)
    ent = cache.get(key)
    if ent is None or ent[0] is not mesh:
        ent = (mesh, M.shard_rows(mesh, np.zeros(n, np.bool_))[1])
        if len(cache) >= 8:
            cache.pop(next(iter(cache)))
        cache[key] = ent
    return ent[1]


def _merge(x: torch.Tensor, op: str, mkeys: torch.Tensor, G: int) -> torch.Tensor:
    """Received partial rows ``x [R, ...]`` merged into ``[G, ...]`` by
    ``op`` ("sum", "min" or "max") over their bucket ``mkeys`` (G drops a
    row): f64 sums, f32 extremes with NaN winning, int64 exactly."""
    tail = tuple(x.shape[1:])
    width = int(np.prod(tail)) if tail else 1
    k = mkeys
    if tail:
        cells = torch.arange(width, device=x.device)
        k = torch.where(mkeys[:, None] == G, G * width, mkeys[:, None] * width + cells).reshape(-1)
        x = x.reshape(-1)
    span = G * width
    if op == "sum":
        out = (GG.segment_sum(x, k, span) if x.is_floating_point()
               else GG.segment_sum_int_exact([x], k, span)[0])
    elif x.is_floating_point():
        mns, mxs = GG.segment_minmax([x], k, span)
        out = (mns if op == "min" else mxs)[0]
    else:
        out = GG.segment_extreme_int64(x, k, span, None, op == "min").to(x.dtype)
    return out.view((G,) + tail)


class _Plan:
    """The plan's closures and shape, shared by every shard."""

    def __init__(self, ndev, where_fn, key_fns, strides, n_groups, agg_plans, dist_domains,
                 validity, prologue):
        self.ndev = ndev
        self.where_fn, self.key_fns, self.strides = where_fn, key_fns, strides
        self.G = n_groups
        self.agg_plans = agg_plans
        self.dist_domains = dist_domains or {}
        self.validity = validity
        self.prologue = prologue


def _local_partials(plan: _Plan, cols: dict, valid: torch.Tensor, row0: int) -> dict:
    """One shard's pass over its rows: the ``[G]`` partial tables (each
    with its merge op), the flags that OR over the mesh (per key a
    fractional key, then each DISTINCT/MODE domain flag, then the trip),
    the recipe that turns merged partials into ``_finalize_agg``'s shapes,
    and the rows medians and quantiles send to their owners."""
    from . import device_plan as DP

    _full, _INT = DP._full, DP._INT
    G = plan.G
    m = valid.shape[0]
    dev = valid.device
    cols = dict(cols, __n__=m, __pred__={})
    base = None if plan.prologue is None else plan.prologue(cols)
    mask = valid if base is None else valid & base
    if plan.where_fn is not None:
        mask = mask & (_full(plan.where_fn(cols), m) != 0)   # NaN is true
    combined = torch.zeros(m, dtype=torch.int64, device=dev)
    trip = torch.zeros((), dtype=torch.bool, device=dev)
    flags, raws = [], []
    for kf, stride in zip(plan.key_fns, plan.strides):
        r = _full(kf(cols), m)
        ri = FS.key_to_int32(r)
        combined = combined + ri * (stride & 0x7FFFFFFF)
        flags.append((mask & (r != ri.to(torch.float32))).any())
        trip = trip | (mask & (r.abs() >= FS.F32_EXACT)).any()
        raws.append(ri)
    keys = torch.remainder(combined, G)
    slot = torch.where(mask, keys, G)   # G: a row the WHERE drops
    (count,) = GG.segment_sum_int_exact([torch.ones_like(slot)], slot, G)
    # the bucket's representative key routes it; then the count and guards
    out = [(GG.segment_extreme_int64(combined, keys, G, mask, False), "max"), (count, "sum")]
    for ri in raws:
        mn, mx = GG.segment_minmax_int32(ri, keys, G, mask)
        out += [(mn, "min"), (mx, "max")]
    rows = row0 + torch.arange(m, dtype=torch.int64, device=dev)
    matched: list = []
    qvals: list = []
    recipe: list = []

    def add(t, op) -> int:
        out.append((t, op))
        return len(out) - 1

    def flag(t) -> int:
        flags.append(t)
        return len(flags) - 1

    def matched_slot():
        if not matched:
            ms = torch.where(mask & cols["__matched__"], keys, G)
            (mc,) = GG.segment_sum_int_exact([torch.ones_like(ms)], ms, G)
            matched.append((ms, add(mc, "sum")))
        return matched[0]

    for ai, (name, fn) in enumerate(plan.agg_plans):
        if name == "key":
            recipe.append(("key", fn))
            continue
        if name in ("count", "count_star"):
            recipe.append(("count",))
            continue
        if name == "count_matched":
            recipe.append(("one", matched_slot()[1]))
            continue
        if name in ("isum", "iavg"):
            total, est = int_agg.device_limb_sums(cols[fn + _INT], mask, keys, G)
            recipe.append(("tuple", add(total, "sum"), add(est, "sum")))
            continue
        if name in ("imin", "imax"):
            ext = int_agg.device_lex_minmax(cols[fn + _INT], mask, keys, G, name == "imin")
            recipe.append(("one", add(ext, name[1:])))
            continue
        if name == "hll":
            ckey, dt = fn
            x = cols[ckey] if dt.startswith("float") else cols[ckey + _INT]
            recipe.append(("hll", add(DP._hll_registers(x, dt, mask, keys, G), "max")))
            continue
        vfn = fn[0] if name in ("var", "quantile", "argmn", "argmx") else fn
        v = _full(vfn(cols), m)
        if plan.validity is not None and plan.validity[ai] == "matched":
            # a dropped row's gathers read dim row 0: the slot drops it
            ms, mi = matched_slot()
            if name in _SUMS:
                recipe.append(("msum", add(GG.segment_sum(v, ms, G), "sum"), mi))
            else:
                (mn,), (mx,) = GG.segment_minmax([v], ms, G)
                recipe.append(("mext", add(mn if name == "min" else mx, name), mi))
            continue
        if name in _SUMS:
            recipe.append(("sum", add(GG.segment_sum(v, slot, G), "sum")))
        elif name == "var":
            # this shard's sum and M2 about its own group means, in f64
            vd = v.double()
            s = GG.segment_sum(vd, slot, G)
            d = vd - (s / count.clamp(min=1))[keys]
            recipe.append(("var", add(s, "raw"), add(GG.segment_sum(d * d, slot, G), "raw")))
        elif name in ("median", "quantile"):
            qvals.append(v)
            recipe.append(("q", name, fn, len(qvals) - 1))
        elif name == "cif":
            recipe.append(("sum", add(GG.segment_sum(v != 0, slot, G), "sum")))
        elif name in ("band", "bor", "min", "max"):
            if name in ("band", "bor"):
                v = (v != 0).to(torch.float32)
            (mn,), (mx,) = GG.segment_minmax([v], slot, G)
            lo = name in ("band", "min")
            recipe.append(("one", add(mn if lo else mx, "min" if lo else "max")))
        elif name == "prod":
            lv = torch.where(v != 0, torch.log2(v.double().abs()), 0.0)
            parts = GG.segment_sum([v < 0, v == 0, lv], slot, G)
            recipe.append(("prod", *(add(p, "sum") for p in parts)))
        elif name in ("argmn", "argmx"):
            # global row ids: the smallest at the extreme wins, as one device
            is_min = name == "argmn"
            nan = torch.isnan(v)
            trip = trip | (mask & nan).any()
            empty = _I64.max if is_min else _I64.min
            w = torch.where(nan, empty, FS.arg_words(v, rows, is_min))
            best = GG.segment_extreme_int64(w, slot, G, None, is_min)
            recipe.append(("arg", add(best, "min" if is_min else "max"), is_min))
        elif name == "mode":
            V = plan.dist_domains[ai]
            counts, first, bad = int_agg.mode_matrices(v, mask, keys, G, V, rows)
            recipe.append(("mode", add(counts, "sum"), add(first, "min"), flag(bad), V))
        else:   # dcount / dsum / davg
            V = plan.dist_domains[ai]
            pres, bad = int_agg.device_presence(v, mask, keys, G, V)
            recipe.append(("dist", name, add(pres.long(), "max"), flag(bad), V))
    flags.append(trip)
    qrows = None
    if qvals:
        idx = torch.nonzero(mask).reshape(-1)
        qrows = (torch.remainder(combined[idx], plan.ndev), [keys[idx]] + [q[idx] for q in qvals])
    return {"out": out, "flags": flags, "recipe": recipe, "qrows": qrows}


def _owner_quantiles(plan: _Plan, rvalid, rcols):
    """The medians and quantiles of one owner's ``[G]`` buckets from the
    rows it received, by the single-device program's sort
    (``device_plan._group_sorted``)."""
    from . import device_plan as DP

    G = plan.G
    dev = rvalid.device
    # one padding row keeps an owner that received nothing well-formed
    rvalid = torch.cat([rvalid, torch.zeros(1, dtype=torch.bool, device=dev)])
    rkeys = torch.cat([rcols[0], torch.zeros(1, dtype=rcols[0].dtype, device=dev)])
    slot = torch.where(rvalid, rkeys, G)
    (count,) = GG.segment_sum_int_exact([torch.ones_like(slot)], slot, G)
    out = []
    for v in rcols[1:]:
        v = torch.cat([v, torch.zeros(1, dtype=v.dtype, device=dev)])
        out.append(DP._group_sorted(v, slot, count) + (v.shape[0],))
    return count, out


def _finalize(plan: _Plan, recipe, merged, recv, mkeys, live, flags, quant):
    """One owner's ``[G]`` results in ``_finalize_agg``'s shapes."""
    G = plan.G
    res = []
    for ent in recipe:
        kind = ent[0]
        if kind == "key":
            res.append(merged[3 + 2 * ent[1]])
        elif kind == "count":
            res.append(merged[1])
        elif kind == "one":
            res.append(merged[ent[1]])
        elif kind == "tuple":
            res.append((merged[ent[1]], merged[ent[2]]))
        elif kind == "hll":
            from .device_plan import _hll_histogram

            # a dead bucket's max-merge identity is int64's minimum: no register
            res.append(_hll_histogram(merged[ent[1]].clamp(min=0)))
        elif kind == "msum":
            res.append((merged[ent[1]], 0.0, merged[ent[2]]))
        elif kind == "mext":
            res.append((merged[ent[1]], merged[ent[2]]))
        elif kind == "sum":
            res.append((merged[ent[1]], 0.0))
        elif kind == "var":
            # Chan's merge: M2 = sum of M2_i + sum of n_i (mean_i - mean)^2
            cnt = torch.where(live, recv[1], 0).double()
            s_i = torch.where(live, recv[ent[1]], 0.0)
            k = torch.where(live, mkeys, G)
            n_tot = GG.segment_sum(cnt, k, G)
            mean = GG.segment_sum(s_i, k, G) / n_tot.clamp(min=1.0)
            dev_i = s_i / cnt.clamp(min=1.0) - torch.cat([mean, mean.new_zeros(1)])[k]
            m2 = GG.segment_sum(torch.where(live, recv[ent[2]], 0.0) + cnt * dev_i * dev_i, k, G)
            res.append((torch.zeros_like(m2), m2))
        elif kind == "q":
            _, name, fn, qi = ent
            count, sorts = quant
            svals, start, nrows = sorts[qi]

            def at(r, svals=svals, start=start, nrows=nrows):
                return svals[(start + r.clamp(min=0)).clamp(0, nrows - 1)]

            if name == "median":
                res.append((at((count - 1) // 2), at(count // 2)))
            elif fn[2]:   # continuous: (floor value, ceil value, fraction)
                pos = fn[1] * (count.double() - 1.0)
                lo = torch.floor(pos).long()
                res.append((at(lo), at(torch.minimum(lo + 1, count - 1)), pos - lo.double()))
            else:         # discrete: the ceil(q*n)-1 element
                res.append((at(torch.ceil(fn[1] * count.double()).long() - 1),))
        elif kind == "prod":
            res.append(tuple(merged[i] for i in ent[1:]) + (0.0,))
        elif kind == "arg":
            best, is_min = merged[ent[1]], ent[2]
            empty = _I64.max if is_min else _I64.min
            low = best & ((1 << FS.ROW_BITS) - 1)
            rid = low if is_min else (1 << FS.ROW_BITS) - 1 - low
            res.append((torch.where(best == empty, -1, rid),))
        elif kind == "mode":
            mode_v, mcount = int_agg.mode_select(merged[ent[1]], merged[ent[2]], ent[4])
            res.append((mode_v, mcount, flags[ent[3]]))
        else:   # dist
            _, name, pi, fi, V = ent
            dcount, dsum = int_agg.presence_reduce(merged[pi] > 0, V)
            res.append((dcount, flags[fi]) if name == "dcount" else (dcount, dsum, flags[fi]))
    return res


def _leaves(tree, out):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _leaves(t, out)
    return out


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return tree


def execute_fused_on_mesh(conn, mesh, *, n, sharded, replicated, prologue, where_fn, key_fns,
                          strides, n_groups, agg_plans, dist_domains=None, validity=None,
                          phases=None):
    """Run a fused plan data-parallel over the mesh.

    - ``sharded``: {name in the plan's cols: (Column, "f32" | "i64")},
      row-sharded over dp (``shard_column``);
    - ``replicated``: {name: tensor}, on every shard's device (a join's
      dimension block and key lookup);
    - ``prologue(cols) -> mask | None`` runs first on each shard (the join
      gather; an outer join publishes ``cols["__matched__"]`` and returns
      None); ``validity``: one "all" or "matched" per agg_plans entry, as
      ``device_plan._build_program`` takes it.

    The caller has checked ``mesh_declines``. Returns the host arrays
    (results, group_count, key_mins, key_maxs, frac_flags), ``[dp * G]``
    long, as the single-device program returns them, or None when a guard
    tripped in the program (a key past f32's exact integers, a NaN arg
    order): the host answers. Records the phases (``mesh_partials_ms``,
    ``mesh_exchange_ms``, ``mesh_merge_ms``, each after a synchronise)
    into ``phases``."""
    from . import device_plan as DP

    ndev = mesh.shape["dp"]
    G = n_groups
    local_n = M.local_rows(n, ndev)
    plan = _Plan(ndev, where_fn, key_fns, strides, G, agg_plans, dist_domains, validity,
                 prologue)
    t0 = time.perf_counter()
    shard_cols = [{} for _ in mesh.local]
    for name, (col, kind) in sharded.items():
        for d, t in zip(shard_cols, shard_column(col, mesh, n, kind)):
            d[name] = t
    for name, arr in replicated.items():
        for d, t in zip(shard_cols, M.replicate(mesh, arr)):
            d[name] = t
    valid = _valid_masks(conn, mesh, n)

    # 1. each shard's partial tables
    parts = [_local_partials(plan, c, v, s * local_n)
             for c, v, s in zip(shard_cols, valid, mesh.local)]
    ops = [op for _t, op in parts[0]["out"]]
    recipe = parts[0]["recipe"]
    M.synchronize(mesh)
    t1 = time.perf_counter()

    # 2. the exchange: partial buckets to the owner of their key
    sends, svalid = [], []
    for p in parts:
        out = p["out"]
        owner = torch.where(out[1][0] > 0, torch.remainder(out[0][0], ndev), 0)
        packed, send_valid = shuffle._pack_buckets(owner, [t for t, _op in out], ndev, G)
        sends.append(packed)
        svalid.append(send_valid)
    rvalid = [v.reshape(-1) for v in M.all_to_all(mesh, svalid)]
    recv = [[r.reshape((ndev * G,) + tuple(r.shape[2:])) for r in
             M.all_to_all(mesh, [s[i] for s in sends])] for i in range(len(ops))]
    flags = M.psum(mesh, [torch.stack([f.long() for f in p["flags"]]) for p in parts])[0] > 0
    qrecv = None
    if parts[0]["qrows"] is not None:
        qparts = [p["qrows"][0] for p in parts]
        cap = shuffle.bucket_cap(mesh, qparts)
        qsends, qvalid = [], []
        for p in parts:
            packed, send_valid = shuffle._pack_buckets(p["qrows"][0], p["qrows"][1], ndev, cap)
            qsends.append(packed)
            qvalid.append(send_valid)
        nq = len(parts[0]["qrows"][1])
        qrecv = ([v.reshape(-1) for v in M.all_to_all(mesh, qvalid)],
                 [[r.reshape(-1) for r in M.all_to_all(mesh, [s[i] for s in qsends])]
                  for i in range(nq)])
    M.synchronize(mesh)
    t2 = time.perf_counter()

    # 3. each owner merges what it received and finalizes its [G] buckets
    n_keys = len(key_fns)
    owner_trees = []
    for j in range(len(mesh.local)):
        r = [recv[i][j] for i in range(len(ops))]
        live = rvalid[j] & (r[1] > 0)
        mkeys = torch.where(live, torch.remainder(r[0], G), G)
        merged = {i: _merge(r[i], op, mkeys, G) for i, op in enumerate(ops) if op != "raw"}
        quant = None
        if qrecv is not None:
            quant = _owner_quantiles(plan, qrecv[0][j], [c[j] for c in qrecv[1]])
        results = _finalize(plan, recipe, merged, r, mkeys, live, flags, quant)
        kmins = [merged[2 + 2 * k] for k in range(n_keys)]
        kmaxs = [merged[3 + 2 * k] for k in range(n_keys)]
        owner_trees.append((results, merged[1], kmins, kmaxs))
    # 4. the merged tables gathered in shard order (a 0-dim flag is global)
    leaves = [_leaves(t, []) for t in owner_trees]
    gathered = [lv[0] if lv[0].dim() == 0 else M.all_gather(mesh, [o[i] for o in leaves])[0]
                for i, lv in enumerate(zip(*leaves))]
    results, count, kmins, kmaxs = _rebuild(owner_trees[0], iter(gathered))
    fracs = [flags[k] for k in range(n_keys)]
    host = DP._to_host((results, count, kmins, kmaxs, fracs, flags[-1]))
    if phases is not None:
        phases["mesh_partials_ms"] = round((t1 - t0) * 1e3, 3)
        phases["mesh_exchange_ms"] = round((t2 - t1) * 1e3, 3)
        phases["mesh_merge_ms"] = round((time.perf_counter() - t2) * 1e3, 3)
    if host[5]:
        return None
    return host[:5]
