"""The port's kernels of two checkouts on one card: a change against its
parent.

Run as a script (not with ``-m``, which would import this checkout's package
first), one process a side, in turns (parent, change, change, parent), in one
call on the card::

    python infera_tpu_torch/testing/ab_kernels.py run ROOT TAG OUT_DIR [sql [QUERY...]|routes]
    python infera_tpu_torch/testing/ab_kernels.py compare OUT_DIR TAG...
    python infera_tpu_torch/testing/ab_kernels.py sass ROOT...

``run`` imports ``infera_tpu_torch`` and ``chip_smoke`` (for its queries)
from ROOT (a checkout, or a ``git archive`` of one) and, over the bench's
1,048,576-row table (``default_rng(1)``):

- K7a in bf16 (over a bf16 table) and in f32, and K1 in bf16 and f32 (over
  the table's feature-major copy): ms per call over 200 queued calls (CUDA
  events around them, after three warm-up calls);
- K6 over the table with the bench MLP and its softmax: ms per call over
  200 queued calls; the outputs are saved as their SHA-256 and every
  4,096th row;
- where the checkout runs the f32 kernels in halves (``query_halves``),
  K7a and K1 in f32 and K6 at one half a block as well (times only);
- K3 and K7b over the table's feature-major int8 copy, quantized as the
  bench quantizes it (calibration sample ``default_rng(7)``): ms per call
  over 200 queued calls;
- K8a and the five K8b stages over the bf16 table: ms per call over 100
  queued calls; where the checkout has K7a's ring, ``ring_sweep`` (K8a with
  0 to 6 of its buffers, on K7a's grid and on twice as many blocks);
- K2/K5 on the plans of SQL queries A, B (f32 and bf16), C, D and E (K4's
  regressor and classifier, config 4), F, G-LEFT, G-FULL, H, I, J and K at
  ``chip_smoke``'s sizes (the plans come from
  ``Connection.execute``): the median of 25 calls each between its own
  CUDA events (``chip_smoke``'s ``device_ms``), the ms per call over 100
  queued calls, and ``call_split`` (the main kernel and the fold alone from
  a profiler trace, the call's host part, the grid);

With ``sql`` last, ``run`` measures the K2/K5 plans alone; queries named
after it (``J``, say) are the only ones planned and run, so a plan can be
timed without the others' tables on the card before it. With ``routes``
last, it times K4 on both of its routes instead (``forest_route_sweep``).
``sass`` prints, for each checkout's built ``fused_sql`` library, each
kernel instance's SASS instructions and its local-memory loads, stores and
calls (``cuobjdump``).

prints a line per measurement and saves every output to
OUT_DIR/ab_TAG.npz. ``compare`` holds every TAG's outputs to the first
TAG's of its side (a side is the tag without its trailing digits: parent
and parent2, change and change2): K7a, K1, K6, K3, K7b and K8 bit for bit;
K2/K5 counts, flags, min/max rows, int slots, arg words and DISTINCT counts
equal, f64 sums and estimates within rtol 1e-12, atol 1e-9 (their
summation order may change with the grid). Across the sides the same,
but for the kernels whose arithmetic a change may redesign (``REDESIGNED``:
K7a and K1 in bf16, K8a, K8b, and K2′ bf16, query B's bf16 plan
``B-bf16``), held within rtol 2e-2, atol 1e-2, with the largest difference
printed, and the f32 query's sums (``F32_SUMS``: K7a
and K1 in f32), held within rtol 1e-6: a launch shape may group their f64
partials otherwise, while their counts, and K6's outputs, stay bit for
bit. K3's and K7b's counts and sums (``EXACT``) are held bit for bit
across the sides as well: their s32 layers are exact in any order.
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile
import time

import numpy as np

N = 1 << 20
_SUM_KEYS = ("sums", "iest")
REDESIGNED = ("K7a bf16", "K1 bf16", "K8a", "K8b", "B-bf16")
EXACT = ("K3", "K7b")
F32_SUMS = ("K7a f32:sums", "K1 f32:sums")


def _host_ms(torch, fn, runs: int) -> float:
    """Median host-clock time a call of ``fn`` takes to return (its checks,
    allocations and launches; the card runs on behind it)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(host))


def call_split(torch, fn, runs: int = 20) -> dict:
    """Where one call of ``fn`` (a K2/K5 wrapper call, of any checkout)
    spends its time: ``kernel_ms`` and ``fold_ms``, the device time of
    fused_sql_kernel and fused_sql_fold a launch in a profiler trace of
    ``runs`` calls (over the launches the trace recorded); ``host_ms``,
    ``_host_ms``."""
    from torch.profiler import ProfilerActivity, profile

    host = _host_ms(torch, fn, runs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    dev = {"fused_sql_kernel": [0.0, 0], "fused_sql_fold": [0.0, 0]}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        for name, acc in dev.items():
            if name in e.key and us > 0:
                acc[0] += us / 1e3
                acc[1] += e.count
    per = {k: t / max(c, 1) for k, (t, c) in dev.items()}
    return {"kernel_ms": per["fused_sql_kernel"], "fold_ms": per["fused_sql_fold"],
            "host_ms": host}


def split_by_events(torch, packed, xc, n, dim_xc=None, int_xc=None, runs: int = 25) -> dict:
    """``call_split``'s numbers for this checkout's K2/K5 by CUDA events:
    the kernel alone and the fold alone (the launch entry's ``parts``), each
    the median of ``runs`` launches between their own events, on the grid
    and workspace ``fused_sql`` gives the plan; the host part of a whole
    call; the grid and resident blocks an SM."""
    from ..ops import _kernels
    from ..ops import fused_sql as fs

    dev = xc.device
    smem = packed.smem_bytes
    grid, per_sm = fs.plan_grid(packed, n, dev)
    part, out = fs._workspace(packed, grid, dev)
    words = fs._launch_words(packed, xc, n, dim_xc, int_xc, part, out, grid, smem)
    lib = _kernels.load("fused_sql")
    stream = _kernels.stream_handle(dev)

    def launch(parts):
        _kernels.check(lib, lib.infera_fused_sql_launch(words, parts, stream), "fused_sql")

    res = {"grid": grid, "resident": per_sm,
           "host_ms": _host_ms(torch, lambda: fs.fused_sql(packed, xc, n, dim_xc, int_xc), 20)}
    for key, parts in (("kernel_ms", 1), ("fold_ms", 2)):
        for _ in range(3):
            launch(parts)
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(parts)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        res[key] = float(np.median(times))
    return res


def _queued_ms(torch, fn, calls: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def ring_sweep(torch, _kernels, pq, x, want, tag) -> None:
    """K8a (the stage kernel's scan) with the ring's buffers and the grid
    set by hand: 0 (the scalar load), 1, 2, 4 and 6 buffers, on K7a's grid
    and on twice as many blocks; each result must equal K8a's."""
    lib = _kernels.load("profile_query")
    dev = x.device
    stage = 64 * pq.fq.ring_stride(32, 2)
    base = pq._stage_smem_bytes((32,)) - pq.ring_stages((32,)) * stage
    blocks0 = pq._k7a_blocks(x, pq.PROFILE_DIMS)
    # the stage kernel's activation width, an argument until its tiles
    # were sized from the dims (the tensor-core layout)
    widest = () if hasattr(pq, "stage_resident_blocks") else (32,)
    stream = _kernels.stream_handle(dev)
    for blocks in (blocks0, 2 * blocks0):
        part = torch.empty((blocks, 128), dtype=torch.float64, device=dev)
        out = torch.empty(128, dtype=torch.float32, device=dev)
        for stages in (0, 1, 2, 4, 6):
            def fn(stages=stages, blocks=blocks, part=part, out=out):
                _kernels.check(lib, lib.infera_profile_stage(
                    0, x.data_ptr(), x.shape[0], x.data_ptr(), 0, _kernels.int_array((32,)), 0,
                    *widest, stages, part.data_ptr(), out.data_ptr(), blocks,
                    base + stages * stage, stream), "ring sweep")
            ms = _queued_ms(torch, fn, 100)
            same = np.array_equal(out[:32].cpu().numpy(), want)
            print(f"{tag} K8a ring sweep: {stages} buffers, {blocks} blocks: {ms:.4f} ms "
                  f"(mean of 100 queued calls), {'equal to' if same else 'DIFFERS from'} K8a",
                  flush=True)


def sql_plans(torch, itt, cs, only=()) -> dict:
    """{query: (xc, packed, dim_xc, int_xc)}: the K2/K5 plans of queries A,
    B-f32, B-bf16, C, D, E, F, G-LEFT, G-FULL, H, I, J and K (or those in
    ``only``), each run once through Connection.execute on the card at
    chip_smoke's tables and models."""
    from infera_tpu_torch.columnar import Column, Table
    from infera_tpu_torch.columnar import types as T
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.sql import Connection

    with tempfile.TemporaryDirectory() as d:
        for name, model in (
                ("m", builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1)),
                ("m3", builder.mlp_model(in_dim=8, hidden=(), out_dim=4, softmax=False, seed=0)),
                ("mt", builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1, softmax=False)),
                ("mk", builder.mlp_model(in_dim=32, hidden=(128, 128), out_dim=16,
                                         softmax=True))):
            proto.save_model_file(model, f"{d}/{name}.onnx")
            itt.load_model(name, f"{d}/{name}.onnx")
        # queries D and E's forests (config 4)
        for name, model in (("gbt", builder.gbt_regressor_model(**cs.GBT)),
                            ("gbc", builder.gbt_classifier_model(**cs.GBC))):
            proto.save_model_file(model, f"{d}/{name}.onnx")
            itt.load_model(name, f"{d}/{name}.onnx")
        # query B's models: K's bench MLP at f32 and bf16
        itt.load_model("mlp_sql", f"{d}/mk.onnx")
        itt.load_model("mlp_sql_bf16", f"{d}/mk.onnx", "bf16")
    conn = Connection()
    conn.execute("create table big as select x % 64 as g, x % 5 as h, "
                 "(x % 100)::float / 10.0 as f1, "
                 "((x + 3) % 50)::float / 5.0 as f2, ((x * 7) % 30)::float / 3.0 as f3, "
                 f"((x * 11) % 90)::float / 9.0 as f4 from range({N}) r(x)")
    rng = np.random.default_rng(0)
    ids = rng.permutation(N).astype(np.int64)
    x8 = rng.standard_normal((N, 8), dtype=np.float32)
    mid = np.arange(N, dtype=np.int64)
    w_meta = np.random.default_rng(1).standard_normal(N, dtype=np.float32)
    src = {"id": Column(ids, T.BIGINT)}
    src.update({f"x{k}": Column(np.ascontiguousarray(x8[:, k]), T.FLOAT) for k in range(8)})
    conn.register_table("src", Table(src))
    conn.register_table("meta", Table({"id": Column(mid, T.BIGINT), "w": Column(w_meta, T.FLOAT),
                                       "cat": Column(mid % 16, T.BIGINT)}))
    conn.execute(f"create table fact as select x % 1100 as k, (x % 40)::float / 4.0 as v, "
                 f"x % 6 as og from range({N}) r(x)")
    conn.execute("create table dim as select x as k, (x * 2)::float as w from range(1000) r(x)")
    conn.execute(cs.TAIL_TABLE.format(n=N))
    x_rows = np.random.default_rng(1).standard_normal((N, 32)).astype(np.float32)
    wide = {f"c{k}": Column(np.ascontiguousarray(x_rows[:, k]), T.FLOAT) for k in range(32)}
    wide.update(g=Column(mid % 64, T.BIGINT), h=Column(mid % 5, T.BIGINT), id=Column(mid, T.BIGINT))
    conn.register_table("wide", Table(wide))
    cols = ", ".join(f"c{k}" for k in range(32))
    queries = {"A": cs.SQL_A, "B-f32": cs.SQL_B.format(m="mlp_sql", cols=cols),
               "B-bf16": cs.SQL_B.format(m="mlp_sql_bf16", cols=cols), "C": cs.SQL_C,
               "D": cs.SQL_D, "E": cs.SQL_E, "F": cs.SQL_F, "G-LEFT": cs.SQL_G.format(kind="left"),
               "G-FULL": cs.SQL_G.format(kind="full"), "H": cs.SQL_H, "I": cs.SQL_I,
               "J": cs.SQL_J, "K": cs.SQL_K.format(cols=cols)}
    plans = {}
    for key, q in queries.items():
        if only and key not in only:
            continue
        before = set(getattr(conn, "_device_plan_cache", {}))
        conn.execute(q)
        new = [k for k in conn._device_plan_cache if k not in before]
        if len(new) != 1 or not conn._exec_path.startswith("device_"):
            raise RuntimeError(f"query {key}: path {conn._exec_path}, {len(new)} plans")
        plans[key] = conn._device_plan_cache[new[0]]
    torch.cuda.synchronize()
    return plans


def run(root: str, tag: str, out_dir: str, parts: str = "all", *only: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import infera_tpu_torch as itt
    from infera_tpu_torch.bench import build_params
    from infera_tpu_torch.ops import _kernels
    from infera_tpu_torch.ops import fused_mlp as fm
    from infera_tpu_torch.ops import fused_query as fq
    from infera_tpu_torch.ops import fused_sql as fs
    from infera_tpu_torch.testing import profile_query as pq

    for mod in (itt, cs):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"imported {mod.__file__}, not from {root}")
    dev = torch.device("cuda")
    itt.set_device(dev)
    os.environ.pop("INFERA_PALLAS_SQL", None)   # the kernel tier, as on CUDA by default
    card = torch.cuda.get_device_name(0)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((N, 32)).astype(np.float32),
                        device=dev)
    x_bf16 = x.to(torch.bfloat16)
    one_half = hasattr(fq, "query_halves")   # the f32 kernels also launch at one half a block
    out = {}
    if parts == "routes":
        forest_route_sweep(torch, itt, cs, fs, tag)
        return
    if parts == "sql":
        sql_phase(torch, itt, cs, _kernels, fs, tag, out, only)
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, f"ab_{tag}.npz"), **out)
        return

    # K7a, K8a, K8b: queued calls
    for mode, dtype, table in (("bf16", torch.bfloat16, x_bf16), ("f32", torch.float32, x)):
        w = fq.params_from_numpy(build_params(seed=0), dev, dtype)
        counts, sums = fq.fused_mlp_query(w, table)
        out[f"K7a {mode}:counts"] = counts.cpu().numpy()
        out[f"K7a {mode}:sums"] = sums.cpu().numpy()
        ms = _queued_ms(torch, lambda: fq.fused_mlp_query(w, table), 200)
        print(f"{tag} K7a {mode}: {ms:.4f} ms (mean of 200 queued calls, {card})", flush=True)
        xc = table.T.contiguous()
        counts, sums = fq.fused_mlp_query_columnar(w, xc)
        out[f"K1 {mode}:counts"] = counts.cpu().numpy()
        out[f"K1 {mode}:sums"] = sums.cpu().numpy()
        ms = _queued_ms(torch, lambda: fq.fused_mlp_query_columnar(w, xc), 200)
        print(f"{tag} K1 {mode}: {ms:.4f} ms (mean of 200 queued calls)", flush=True)
        if mode == "f32" and one_half:
            for name, fn in (("K7a", lambda: fq._launch_f32(w, table, True, 1)),
                             ("K1", lambda: fq._launch_f32(w, xc, False, 1))):
                ms = _queued_ms(torch, fn, 200)
                print(f"{tag} {name} f32, one half a block: {ms:.4f} ms (mean of 200 queued "
                      f"calls)", flush=True)
        del xc
    # K6: the bench MLP with its softmax over the row-major table
    mw = fm.mlp_weights(build_params(seed=0), dev)
    k6 = fm.fused_mlp(mw, x, True).cpu().numpy()
    out["K6:sha256"] = np.frombuffer(hashlib.sha256(k6.tobytes()).digest(), np.uint8)
    out["K6:rows"] = k6[::4096]
    ms = _queued_ms(torch, lambda: fm.fused_mlp(mw, x, True), 200)
    print(f"{tag} K6: {ms:.4f} ms (mean of 200 queued calls)", flush=True)
    if one_half:
        ms = _queued_ms(torch, lambda: fm._launch(mw, x, True, 1), 200)
        print(f"{tag} K6, one half a block: {ms:.4f} ms (mean of 200 queued calls)", flush=True)
    # K3, K7b: queued calls over the int8 table
    params = build_params(seed=0)
    x_cal = np.random.default_rng(7).standard_normal((1 << 14, 32)).astype(np.float32)
    xc = x.T.contiguous()
    qparams, s0, _ = fq.quantize_mlp_shift(params, x_cal, max_flip_rate=0.04)
    qparams_s, s0_s = fq.quantize_mlp_static(params, x_cal)
    int8 = {"K3": (fq.fused_mlp_query_columnar_int8_shift, fq.qparams_from_numpy(qparams, dev),
                   s0),
            "K7b": (fq.fused_mlp_query_columnar_int8, fq.qparams_static_from_numpy(qparams_s, dev),
                    s0_s)}
    for name, (kern, w, scale) in int8.items():
        xq = torch.clamp(torch.round(xc / float(scale)), -127, 127).to(torch.int8)
        counts, sums = kern(w, xq)
        out[f"{name}:counts"] = counts.cpu().numpy()
        out[f"{name}:sums"] = sums.cpu().numpy()
        ms = _queued_ms(torch, lambda kern=kern, w=w, xq=xq: kern(w, xq), 200)
        print(f"{tag} {name}: {ms:.4f} ms (mean of 200 queued calls)", flush=True)
    del xc

    sw = pq.stage_weights(pq._params(), dev)
    k8 = {"K8a": lambda: pq.empty_grid_scan(x_bf16)}
    for v in pq.VARIANTS:
        k8[f"K8b {v}"] = lambda v=v: pq.query_stage(sw, x_bf16, v)
    for name, fn in k8.items():
        out[f"{name}:out"] = fn().cpu().numpy()
        ms = _queued_ms(torch, fn, 100)
        print(f"{tag} {name}: {ms:.4f} ms (mean of 100 queued calls)", flush=True)
    if hasattr(pq, "ring_stages"):
        ring_sweep(torch, _kernels, pq, x_bf16, out["K8a:out"], tag)

    sql_phase(torch, itt, cs, _kernels, fs, tag, out)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"ab_{tag}.npz"), **out)


def sql_phase(torch, itt, cs, _kernels, fs, tag, out, only=()) -> None:
    """K2/K5 on the SQL plans (``sql_plans``) of the checkout's package:
    each plan's outputs into ``out``, a line of times each."""
    dev = torch.device("cuda")
    for key, (xc, packed, dim_xc, int_xc) in sql_plans(torch, itt, cs, only).items():
        def call(packed=packed, xc=xc, dim_xc=dim_xc, int_xc=int_xc):
            return fs.fused_sql(packed, xc, N, dim_xc, int_xc)

        res = call()
        for k, t in res.items():
            out[f"{key}:{k}"] = t.cpu().numpy()
        per_call = float(np.median(cs.device_ms(torch, call)))
        queued = _queued_ms(torch, call, 100)
        split = call_split(torch, call)
        smem = packed.smem_bytes
        tiles = -(-N // fs.SLOT_ROWS)
        if hasattr(fs, "plan_grid"):
            grid, per_sm = fs.plan_grid(packed, N, dev)
        elif hasattr(fs, "resident_blocks"):
            per_sm = fs.resident_blocks(dev, smem)
            grid = _kernels.grid_blocks(dev, tiles, smem, per_sm)
        else:
            per_sm, grid = None, _kernels.grid_blocks(dev, tiles, smem)
        print(f"{tag} K2/K5 {key}: {per_call:.4f} ms per call (median of 25, events around "
              f"each call), {queued:.4f} ms queued (100 calls); kernel {split['kernel_ms']:.4f}, "
              f"fold {split['fold_ms']:.4f} ms (trace), host part {split['host_ms']:.4f} ms; "
              f"grid {grid} blocks, resident {per_sm} a SM, {smem} B of shared memory, "
              f"G {packed.plan.n_groups}", flush=True)


ROUTE_TREES = (64, 96, 128)


def forest_route_sweep(torch, itt, cs, fs, tag) -> None:
    """K4 on depth-6 regressors over 16 features (config 4's shape, query D's
    SQL) of ``ROUTE_TREES`` trees over ``N`` rows, each plan packed twice:
    its records in shared memory with one block's 227 KB as their budget
    (past about 91 trees one block an SM) and in device memory (two blocks
    an SM). A line of times each (median of 25 calls, each between CUDA
    events, and ms per call over 100 queued calls); the two routes' counts
    and min/max must be equal and their sums within rtol 1e-12."""
    from infera_tpu_torch.columnar import Column, Table
    from infera_tpu_torch.columnar import types as T
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.sql import Connection

    dev = torch.device("cuda")
    x = np.random.default_rng(1).standard_normal((N, 16)).astype(np.float32)
    cols = {f"c{k}": Column(np.ascontiguousarray(x[:, k]), T.FLOAT) for k in range(16)}
    cols["g"] = Column(np.arange(N, dtype=np.int64) % 64, T.BIGINT)
    conn = Connection()
    conn.register_table("wide", Table(cols))
    two_blocks = fs.TWO_BLOCK_SMEM
    for trees in ROUTE_TREES:
        name = f"gbt{trees}"
        with tempfile.TemporaryDirectory() as d:
            proto.save_model_file(builder.gbt_regressor_model(**{**cs.GBT, "n_trees": trees}),
                                  f"{d}/{name}.onnx")
            itt.load_model(name, f"{d}/{name}.onnx")
        before = set(getattr(conn, "_device_plan_cache", {}))
        conn.execute(cs.SQL_D.replace("'gbt'", f"'{name}'"))
        new = [k for k in conn._device_plan_cache if k not in before]
        if len(new) != 1 or conn._exec_path != "device_plan_cuda":
            raise RuntimeError(f"{trees} trees: path {conn._exec_path}, {len(new)} plans")
        xc = conn._device_plan_cache[new[0]][0]
        plan = conn._device_plan_cache[new[0]][1].plan
        outs = {}
        for route, budget in (("shared", fs.SMEM_LIMIT), ("device", 0)):
            fs.TWO_BLOCK_SMEM = budget   # the records' budget in smem_layout
            try:
                packed = fs.pack_plan(plan, dev)
            finally:
                fs.TWO_BLOCK_SMEM = two_blocks
            if fs.forest_routes(packed)[0]["records"] != route:
                raise RuntimeError(f"{trees} trees: {fs.forest_routes(packed)}, not {route}")

            def call(packed=packed):
                return fs.fused_sql(packed, xc, N)

            outs[route] = {k: t.cpu().numpy() for k, t in call().items()}
            per_call = float(np.median(cs.device_ms(torch, call)))
            queued = _queued_ms(torch, call, 100)
            grid, per_sm = fs.plan_grid(packed, N, dev)
            print(f"{tag} K4 {trees} trees, records {route}: {per_call:.4f} ms per call (median "
                  f"of 25, events around each call), {queued:.4f} ms queued (100 calls); grid "
                  f"{grid} blocks, resident {per_sm} a SM, {packed.smem_bytes} B of shared "
                  f"memory", flush=True)
        a, b = outs["shared"], outs["device"]
        for k in a:
            same = (np.allclose(a[k], b[k], rtol=1e-12, atol=1e-9) if k in _SUM_KEYS
                    else np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"))
            if not same:
                raise RuntimeError(f"{trees} trees: {k} differs between the routes")
        print(f"{tag} K4 {trees} trees: outputs of both routes equal (sums within rtol 1e-12)",
              flush=True)


def sass_report(roots) -> None:
    """Per checkout, each kernel instance of its built ``fused_sql`` library:
    SASS instructions, LDL, STL and CALL (``cuobjdump --dump-sass``)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import subprocess

    from infera_tpu_torch.ops import _kernels

    for root in roots:
        lib = os.path.join(root, "infera_tpu_torch", "_build", "libfused_sql.so")
        sass = subprocess.run([_kernels._cuda_tool("cuobjdump"), "--dump-sass", lib],
                              check=True, capture_output=True, text=True).stdout
        counts = {op: _kernels.count_sass(sass, op) for op in ("", "LDL", "STL", "CALL")}
        for fn in counts[""]:
            print(f"{root} {fn[:48]}: {counts[''][fn]} instructions, {counts['LDL'][fn]} LDL, "
                  f"{counts['STL'][fn]} STL, {counts['CALL'][fn]} CALL", flush=True)


def _side(tag: str) -> str:
    return tag.rstrip("0123456789")


def compare(out_dir: str, tags) -> bool:
    runs = {tag: np.load(os.path.join(out_dir, f"ab_{tag}.npz")) for tag in tags}
    first = {}
    for tag in tags:
        first.setdefault(_side(tag), tag)
    ok = True
    ref_tag = tags[0]
    for key in runs[ref_tag].files:
        for tag in tags[1:]:
            base = first[_side(tag)] if first[_side(tag)] != tag else ref_tag
            ref, got = runs[base][key], runs[tag][key]
            across = _side(base) != _side(tag)
            if key.startswith(EXACT):
                same = np.array_equal(got, ref)
            elif across and key in F32_SUMS:
                same = got.shape == ref.shape and np.allclose(got, ref, rtol=1e-6, atol=0)
            elif across and key.startswith(REDESIGNED):
                same = got.shape == ref.shape and np.allclose(got, ref, rtol=2e-2, atol=1e-2)
                if same and tag == first[_side(tag)] and got.size:
                    rel = np.abs(got.astype(np.float64) - ref) / np.maximum(np.abs(ref), 1e-30)
                    print(f"{key}: {tag} against {base}: max abs diff "
                          f"{float(np.abs(got.astype(np.float64) - ref).max()):.4e}, max rel "
                          f"{float(rel.max()):.4e}")
            elif key.split(":")[1] in _SUM_KEYS:
                same = got.shape == ref.shape and np.allclose(got, ref, rtol=1e-12, atol=1e-9)
            else:
                same = np.array_equal(got, ref, equal_nan=got.dtype.kind == "f")
            if not same:
                ok = False
                print(f"{key}: {tag} differs from {base}")
    print(f"outputs of {', '.join(tags)}: {'equal' if ok else 'DIFFER'} (each side bit for bit "
          f"but K2/K5 sums within rtol 1e-12; across sides {', '.join(REDESIGNED)} within rtol "
          f"2e-2, {', '.join(F32_SUMS)} within rtol 1e-6, {', '.join(EXACT)} bit for bit)")
    return ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["run"] and (len(argv) == 4 or argv[4:] == ["routes"]
                                or argv[4:5] == ["sql"]):
        run(*argv[1:])
        return 0
    if argv[:1] == ["compare"] and len(argv) >= 3:
        return 0 if compare(argv[1], argv[2:]) else 1
    if argv[:1] == ["sass"] and len(argv) >= 2:
        sass_report(argv[1:])
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
