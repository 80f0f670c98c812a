"""The port's kernels of two checkouts on one card: a change against its
parent.

Run as a script (not with ``-m``, which would import this checkout's package
first), one process a side, in turns (parent, change, change, parent), in one
call on the card::

    python infera_tpu_torch/testing/ab_kernels.py run ROOT TAG OUT_DIR
    python infera_tpu_torch/testing/ab_kernels.py compare OUT_DIR TAG...

``run`` imports ``infera_tpu_torch`` and ``chip_smoke`` (for its queries)
from ROOT (a checkout, or a ``git archive`` of one) and, over the bench's
1,048,576-row table (``default_rng(1)``):

- K7a in bf16 (over a bf16 table) and in f32: ms per call over 200 queued
  calls (CUDA events around them, after three warm-up calls);
- K8a and the five K8b stages over the bf16 table: ms per call over 100
  queued calls; where the checkout has K7a's ring, ``ring_sweep`` (K8a with
  0 to 6 of its buffers, on K7a's grid and on twice as many blocks);
- K2/K5 on the plans of SQL queries A, C, F, G-LEFT, G-FULL, H, I and J at
  ``chip_smoke``'s sizes (the plans come from ``Connection.execute``): the
  median of 25 calls each between its own CUDA events (``chip_smoke``'s
  ``device_ms``), the ms per call over 100 queued calls, and ``call_split``
  (the main kernel and the fold alone from a profiler trace, the call's
  host part, the grid);

prints a line per measurement and saves every output to
OUT_DIR/ab_TAG.npz. ``compare`` holds every TAG's outputs to the first's:
K7a and K8 bit for bit; K2/K5 counts, flags, min/max rows, int slots, arg
words and DISTINCT counts equal, f64 sums and estimates within rtol 1e-12,
atol 1e-9 (their summation order may change with the grid).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

N = 1 << 20
_SUM_KEYS = ("sums", "iest")


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
    per_sm = fs.resident_blocks(dev, smem)
    grid = _kernels.grid_blocks(dev, -(-n // fs.SLOT_ROWS), smem, per_sm)
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
    stream = _kernels.stream_handle(dev)
    for blocks in (blocks0, 2 * blocks0):
        part = torch.empty((blocks, 128), dtype=torch.float64, device=dev)
        out = torch.empty(128, dtype=torch.float32, device=dev)
        for stages in (0, 1, 2, 4, 6):
            def fn(stages=stages, blocks=blocks, part=part, out=out):
                _kernels.check(lib, lib.infera_profile_stage(
                    0, x.data_ptr(), x.shape[0], x.data_ptr(), 0, _kernels.int_array((32,)), 0,
                    32, stages, part.data_ptr(), out.data_ptr(), blocks,
                    base + stages * stage, stream), "ring sweep")
            ms = _queued_ms(torch, fn, 100)
            same = np.array_equal(out[:32].cpu().numpy(), want)
            print(f"{tag} K8a ring sweep: {stages} buffers, {blocks} blocks: {ms:.4f} ms "
                  f"(mean of 100 queued calls), {'equal to' if same else 'DIFFERS from'} K8a",
                  flush=True)


def sql_plans(torch, itt, cs) -> dict:
    """{query: (xc, packed, dim_xc, int_xc)}: the K2/K5 plans of queries A,
    C, F, G-LEFT, G-FULL, H, I and J, each run once through
    Connection.execute on the card at chip_smoke's tables and models."""
    from infera_tpu_torch.columnar import Column, Table
    from infera_tpu_torch.columnar import types as T
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.sql import Connection

    with tempfile.TemporaryDirectory() as d:
        for name, model in (
                ("m", builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1)),
                ("m3", builder.mlp_model(in_dim=8, hidden=(), out_dim=4, softmax=False, seed=0)),
                ("mt", builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1, softmax=False))):
            proto.save_model_file(model, f"{d}/{name}.onnx")
            itt.load_model(name, f"{d}/{name}.onnx")
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
    queries = {"A": cs.SQL_A, "C": cs.SQL_C, "F": cs.SQL_F, "G-LEFT": cs.SQL_G.format(kind="left"),
               "G-FULL": cs.SQL_G.format(kind="full"), "H": cs.SQL_H, "I": cs.SQL_I,
               "J": cs.SQL_J}
    plans = {}
    for key, q in queries.items():
        before = set(getattr(conn, "_device_plan_cache", {}))
        conn.execute(q)
        new = [k for k in conn._device_plan_cache if k not in before]
        if len(new) != 1 or not conn._exec_path.startswith("device_"):
            raise RuntimeError(f"query {key}: path {conn._exec_path}, {len(new)} plans")
        plans[key] = conn._device_plan_cache[new[0]]
    torch.cuda.synchronize()
    return plans


def run(root: str, tag: str, out_dir: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import infera_tpu_torch as itt
    from infera_tpu_torch.bench import build_params
    from infera_tpu_torch.ops import _kernels
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
    out = {}

    # K7a, K8a, K8b: queued calls
    for mode, dtype, table in (("bf16", torch.bfloat16, x_bf16), ("f32", torch.float32, x)):
        w = fq.params_from_numpy(build_params(seed=0), dev, dtype)
        counts, sums = fq.fused_mlp_query(w, table)
        out[f"K7a {mode}:counts"] = counts.cpu().numpy()
        out[f"K7a {mode}:sums"] = sums.cpu().numpy()
        ms = _queued_ms(torch, lambda: fq.fused_mlp_query(w, table), 200)
        print(f"{tag} K7a {mode}: {ms:.4f} ms (mean of 200 queued calls, {card})", flush=True)
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

    # K2/K5 on the SQL plans
    for key, (xc, packed, dim_xc, int_xc) in sql_plans(torch, itt, cs).items():
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
        if hasattr(fs, "resident_blocks"):
            per_sm = fs.resident_blocks(dev, smem)
            grid = _kernels.grid_blocks(dev, tiles, smem, per_sm)
        else:
            per_sm, grid = None, _kernels.grid_blocks(dev, tiles, smem)
        print(f"{tag} K2/K5 {key}: {per_call:.4f} ms per call (median of 25, events around "
              f"each call), {queued:.4f} ms queued (100 calls); kernel {split['kernel_ms']:.4f}, "
              f"fold {split['fold_ms']:.4f} ms (trace), host part {split['host_ms']:.4f} ms; "
              f"grid {grid} blocks, resident {per_sm} a SM, {smem} B of shared memory, "
              f"G {packed.plan.n_groups}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"ab_{tag}.npz"), **out)


def compare(out_dir: str, tags) -> bool:
    runs = [np.load(os.path.join(out_dir, f"ab_{tag}.npz")) for tag in tags]
    ok = True
    for key in runs[0].files:
        ref = runs[0][key]
        for tag, r in zip(tags[1:], runs[1:]):
            got = r[key]
            if key.split(":")[1] in _SUM_KEYS:
                same = got.shape == ref.shape and np.allclose(got, ref, rtol=1e-12, atol=1e-9)
            else:
                same = np.array_equal(got, ref, equal_nan=got.dtype.kind == "f")
            if not same:
                ok = False
                print(f"{key}: {tag} differs from {tags[0]}")
    print(f"outputs of {', '.join(tags)}: {'equal' if ok else 'DIFFER'} (K7a, K8 bit for bit; "
          f"K2/K5 exact but sums within rtol 1e-12)")
    return ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["run"] and len(argv) == 4:
        run(*argv[1:])
        return 0
    if argv[:1] == ["compare"] and len(argv) >= 3:
        return 0 if compare(argv[1], argv[2:]) else 1
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
