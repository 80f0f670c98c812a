#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, builds every kernel of ``infera_tpu_torch/csrc`` with nvcc (sm_90a), and:

1. prints the card, its power limit, the torch and CUDA versions and the
   build time; the tensor-core paths: HMMA in the SASS (``cuobjdump``) of
   the bf16 kernels of K1, K7a and K8b and of K2's kWide instance (plans
   with a bf16 MLP slot, a 128-column f32 layer or a forest), none in the f32 and
   int8 ones nor in K2's other instance, IMMA in the int8 kernel of K3 and
   K7b and none in the f32 and bf16 ones, ptxas's registers and spills of
   each (no spill; at most 128 registers in bf16, 80 in int8 and in K2's
   other instance), and at the bench MLP the resident blocks an SM (at
   least two) and the grid they give; for the f32 layer stack (every
   instantiation of K1's and K7a's f32 kernel, and K6) ptxas's registers,
   stack and spills (no spill, at most 128 registers) and at the bench MLP
   the halves a block, its threads and the grid (two halves, 512 threads,
   one block an SM);
2. drives the main path once through the entry points a user calls, with
   every kernel's launch count set to 0 just before and read just after:
   the 13-function API (``load_model`` of ``onnx.builder``'s ``linear``,
   ``multi_output`` and a 32-128-128-16 softmax MLP; ``predict`` of the
   linear anchor, of 1,048,576 seeded rows through the MLP (kernel K6), and
   of a missing model), then the fused query over a 1,048,576-row table in
   f32 and bf16 (K1) and int8 with shifts (K3);
3. holds every kernel against its plain PyTorch version on the card, at
   1,048,576 rows and at a ragged 1,000,003, and K3 against the numpy
   integer emulation as well;
4. times each kernel, its plain version and one PyTorch library chain for
   the same function with CUDA events (median of 25 runs after warm-up),
   beside the least time the card could take (``bound_ms``), and engine
   ``predict`` of 1,048,576 rows on the host clock beside its parts;
5. the SQL form of the main path, driven only through ``load_model``,
   ``register_table`` and ``Connection.execute``, with K2's launch counts
   set to 0 just before and read just after: query A, the repo's SQL
   flagship over a 1,048,576-row ``range()`` table with a 4-32-1 MLP, and
   query B over 1,048,576 seeded rows of 32 columns with the 32-128-128-16
   softmax MLP loaded at f32 and at bf16, and query C, K2's core slots
   alone (two keys, min, max, count, HAVING) over the first table. Each
   must run on
   ``device_plan_cuda`` with K2 launched and give the host executor's rows
   (a second Connection over the same catalog with the device tiers turned
   away, ``host_rows``, as ``infera_tpu``'s tests reach the host; the
   same in steps 6–8); it prints each query's
   steady time on the host clock and its phases, holds K2 against its plain
   version on the emitted plans at 1,048,576 and 1,000,003 rows, and times
   K2, its plain version and a PyTorch library chain; for each plan with an
   MLP slot it prints the 64-row sub-tiles K2′ ran against those of a pass
   over every row (the MLP runs on the rows the WHERE keeps), and query B's
   bf16 plan must hold at least two blocks an SM;
6. the tree path, BASELINE config 4: engine ``predict`` of a 64-tree
   depth-6 GBT over 262,144 seeded rows (GEMM forest, checked against the
   gather traversal and a numpy walk), then query D (the GBT regressor in
   WHERE, avg and max) and query E (a 3-class GBT classifier's labels in
   avg and min) over the 32-column table through ``Connection.execute``,
   with K2's and K4's launch counts set to 0 just before and read just
   after. Each must run on ``device_plan_cuda`` with K4 launched and give
   the host executor's rows; K2+K4 is held against its plain version at
   1,048,576 and 1,000,003 rows and timed beside its bound, its plain
   version and a PyTorch chain (the port's GEMM forest and ``index_add_``),
   with each plan's split, where K4 reads the forest (records in shared
   memory, features in the tile), its shared memory, blocks an SM (at least
   two), trees in flight and ptxas's registers and spills (none); then a
   512-tree forest whose records stay in device memory, held against plain
   at 1,000,003 rows;
7. the join path, BASELINE config 3: query F (an 8→4 map's outputs over a
   1,048,576-row source joined back on a permuted key to a 1,048,576-row
   dimension, 16 groups) and the outer joins G-LEFT, G-FULL and H (a
   1,048,576-row fact table to a 1,000-row dimension) through
   ``Connection.execute``, with the launch counts set to 0 just before and
   read just after. Each must run on ``device_join_plan_cuda`` with exactly
   one launch of K5 and give the host executor's rows (whose join is the
   device sort-join); F's counts are also held to numpy. K5 is held against
   its plain version at 1,048,576 and 1,000,003 rows and timed beside its
   bound, its plain version and a PyTorch chain;
8. the aggregate tail (K2 b–e): queries I (variance, count_if, bool_and/or,
   product and an exact int64 average beside a 4→32→1 MLP), J (COUNT/SUM/
   AVG(DISTINCT) and MODE), K (arg_max over the config-2 MLP's prediction,
   arg_min, arg_max over ties) and L (exact int64 sum, avg, min and max of a
   BIGINT near ±2^44) over 1,048,576 rows through ``Connection.execute``,
   with the launch counts set to 0 just before and read just after. Each
   must run on ``device_plan_cuda`` as one K2 launch once its probes are
   cached and give the host executor's rows; each plan is held against its
   plain version at 1,048,576 and 1,000,003 rows and timed beside its
   bound, its plain version and a PyTorch chain; the SUM(BIGINT) overflow
   must raise the host's message; then the torch program
   (``device_plan_phase``, ``_exec_path == "device_plan"``, torch ops and
   no kernel of the port, so the kernels line gains no row) over the same
   ``big`` table and a table ``t`` of 1,048,576 rows: M (median and
   quantiles), N (approx_count_distinct, the host's HLL bit for bit), O (a
   MODE that ties in every group, which K2 declines), P (query A's MLP
   loaded as int8, which K2 declines; held to the same program on the CPU),
   Q (query A with ``INFERA_PALLAS_SQL=0``, held to K2's rows), R (4,096
   groups) and S (ORDER BY of wide integers and of f64 keys past f32's
   range, sorted on the card in the host executor: DuckDB's order). Each
   runs on its path with rows equal to the host executor's, prints its
   end-to-end time (median of 5) and phases and the host's time once, and
   M prints the device's idle share in a traced window of five calls;
9. the rest of the bench form and the int8 policy: with the launch counts of
   K7a (f32, bf16), K7b, K1 (f32, bf16) and K3 set to 0 just before and read
   just after, ``infera_tpu_torch.bench.bench_cuda`` runs all eight impls
   over its 1,048,576-row table (K7a over a row-major table in f32, in bf16
   over a bf16 table and over an f32 one; K7b over an int8 table; K1 and K3
   over its feature-major copies: their rows of the kernels line count these
   launches beside those of step 2), then
   ``load_model(..., precision="int8")`` of the 32-128-128-16 softmax MLP
   and ``predict`` of 1,048,576 seeded rows, which must run the fused int8
   chain, stay within the int8 bound of the f32 model and equal the same
   chain run on the CPU to 1e-5. K7a and K7b are held against their plain
   versions at 1,048,576 and 1,000,003 rows (K7b also against the numpy
   integer emulation) and timed beside their bounds, plain versions and
   PyTorch chains; int8 ``predict`` is timed on the host clock beside f32's;
   After each K2/K5 plan's times (queries A–C, F–H, I–L) it prints the
   plan's split: the main kernel and the fold alone (CUDA events), the
   call's host part, ptxas's registers and stack, the resident blocks an SM
   and the grid, which must not exceed them;
10. the profiling path: with the launch counts of K8a and K8b set to 0 just
   before and read just after, the seven experiments of
   ``infera_tpu_torch.testing.profile_query`` (iters, rows, empty, tiles,
   chain, variants, col) at their default sizes, printing their JSON lines;
   the timer check (a 4096² bf16 matmul) must read at least 0.9 × the card's
   floor. K8a and K8b's five stages are held against their plain versions at
   1,048,576 and 1,000,003 rows (tail_nomax and full within K7a bf16's
   bounds), K8a against K8b scan and K8b full against K7a bf16 bit for bit;
   two ``observability.trace`` windows (5 steady executions of
   query A inside ``annotate``, 20 K7a bf16 calls, whose window must
   record all 20 launches and is traced again, at most three times, when
   the profiler drops some) print their five longest device operations and
   the device's idle share; K8a and K8b are timed
   beside their bounds, plain versions and PyTorch chains (K8a with its
   ring's buffers and bytes in flight), and K7a bf16's time is split by
   stage;
11. the ONNX phase, which launches no kernel of the port (``infera_tpu``
   computes these ops in XLA, outside any Pallas kernel; the port in torch
   ops, Conv in cuDNN without TF32): the MobileNetV3-Small stand-in
   (``onnx.builder.mobilenet_like_model``, 1000 classes) through
   ``load_model`` / ``predict_from_blob`` on a seeded 602,112-byte image
   and the zero blob, and ``predict`` of 64 images (the fixed-batch path);
   the transformer encoder at ``onnx.builder``'s widths over 32,768 rows at f32,
   bf16 and int8, and through SQL ``infera_predict_from_blob``; the If,
   Loop (both paths) and Scan graphs. Each output is held against the same
   port on the CPU (same graph, same seeded input): f32 within 1e-5 of the
   output's largest magnitude, bf16 and int8 within their rounding-flip
   bounds (1e-2 and 2e-2 at the worst, 5e-4 and 1e-3 on average). It prints
   MobileNet's host-clock ms a call at batch 1 (median of 20) and images/s
   at batch 64, the encoder's rows/s at each precision, one
   ``observability.trace`` window of MobileNet at batch 1 with its idle
   share, and the phase's wall time;
12. prints the ``{"kernels": [...]}`` line, the card's name and power limit,
   and last ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero without the ``ok`` line. The script
imports nothing of JAX or ``infera_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

N_MAIN = 1 << 20        # rows of the main path (the benchmark's table)
N_RAGGED = 1_000_003    # a row count that is no multiple of the 64-row tile
TIMED_RUNS = 25

# Published dense peaks (NVIDIA data sheets): f32 on the CUDA cores, bf16 and
# int8 on the tensor cores, and the HBM rate. Keyed by a word of the card's
# name; the SXM part is the default.
PEAKS = {
    "PCIe": {"f32": 51e12, "bf16": 756e12, "int8": 1513e12, "bytes": 2.0e12},
    "NVL": {"f32": 60e12, "bf16": 835e12, "int8": 1671e12, "bytes": 3.9e12},
    "SXM": {"f32": 67e12, "bf16": 989e12, "int8": 1979e12, "bytes": 3.35e12},
}


def card_peaks(name: str) -> dict:
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def bound(ops: float, nbytes: float, op_type: str, peaks: dict) -> tuple:
    """(bound_ms, bound_by): the larger of operations over the peak rate of
    their type and bytes over the memory rate."""
    t_ops = ops / peaks[op_type] * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, runs: int = TIMED_RUNS) -> np.ndarray:
    """Device time of each of ``runs`` calls, each call between its own CUDA
    events, after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return np.array(times)


def host_ms(torch, fn, runs: int = 7) -> float:
    """Median host-clock time of ``runs`` calls, each ended by a synchronise,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def host_rows(conn, queries: dict, path: str = "host") -> tuple:
    """Each query's rows from the host executor over ``conn``'s catalog: a
    second Connection with the device tiers turned away, as
    ``infera_tpu``'s own tests reach the host (a join's host path over a
    large side is the device sort-join, ``path`` "device_join"). Returns
    (rows, host-clock ms) by query."""
    from infera_tpu_torch.sql import Connection, device_join_plan, device_plan

    host = Connection(conn.catalog)
    saved = device_plan.try_execute_on_device, device_join_plan.try_execute_join_on_device
    device_plan.try_execute_on_device = lambda *a, **k: None
    device_join_plan.try_execute_join_on_device = lambda *a, **k: None
    rows, ms = {}, {}
    try:
        for key, q in queries.items():
            t = time.perf_counter()
            rows[key] = host.execute(q).rows
            ms[key] = (time.perf_counter() - t) * 1e3
            check(host._exec_path == path, f"host query {key} ran on {host._exec_path}")
    finally:
        device_plan.try_execute_on_device, device_join_plan.try_execute_join_on_device = saved
    return rows, ms


def sql_split(torch, key, packed, xc, n, dim_xc=None, int_xc=None) -> None:
    """Print where one K2/K5 call of a plan spends its time: the main kernel
    and the fold alone (CUDA events around each launch, median of 25), the
    call's host part, ptxas's registers and stack of the kernel, its
    resident blocks an SM at the plan's shared memory and the grid, which
    must not exceed the blocks resident on the card."""
    from infera_tpu_torch.ops import _kernels
    from infera_tpu_torch.ops import fused_sql as fs
    from infera_tpu_torch.testing.ab_kernels import split_by_events

    s = split_by_events(torch, packed, xc, n, dim_xc, int_xc)
    sms = torch.cuda.get_device_properties(xc.device).multi_processor_count
    check(s["grid"] <= sms * s["resident"],
          f"K2 {key}: grid {s['grid']} over {sms} x {s['resident']} resident blocks")
    instance = sql_instance(fs.wide_instance(packed.plan))
    regs, stack, _ = _kernels.ptxas_usage("fused_sql", instance)
    print(f"K2/K5 {key} split: kernel {s['kernel_ms']:.4f} ms, fold {s['fold_ms']:.4f} ms "
          f"(CUDA events, median of 25 launches each), host part {s['host_ms']:.4f} ms; ptxas "
          f"{regs} registers, {stack} B stack; {s['resident']} blocks resident a SM at "
          f"{packed.smem_bytes} B of shared memory, grid {s['grid']} blocks; lead table "
          f"{'in use' if packed.smem['lead'] >= 0 else 'none'}")


def sql_instance(wide: bool) -> str:
    """The mangled-name stem of K2's kernel instance: kWide (plans with a
    bf16 MLP slot, an f32 layer of 128 columns or more, or a forest slot) or
    the other one."""
    return f"3sql16fused_sql_kernelILb{int(wide)}E"


def emulate_int8_shift(qparams, xq: np.ndarray):
    """The integer pipeline of ``quantize_mlp_shift`` in numpy over an int8
    table [d0, N]. The int8 products are summed in f64 BLAS, exact here
    (|y| <= 127 * 127 * din < 2**53); the last layer is f64 as in the
    emulation. Returns counts [C] int64."""
    q = xq.astype(np.float64)
    n_layers = len(qparams)
    for i, (wq, a1, a2, a3) in enumerate(qparams):
        y = (wq.astype(np.float64) @ q).astype(np.int64)
        if i < n_layers - 1:
            q = np.clip(((y << a1.astype(np.int64)) + a3) >> a2.astype(np.int64), 0, 127)
            q = q.astype(np.float64)
        else:
            h = y.astype(np.float64) * a1.astype(np.float64) + a3.astype(np.float64)
    pred = np.argmax(h, axis=0)
    sel = h[0] > 0
    return np.bincount(pred[sel], minlength=h.shape[0]).astype(np.int64)


def emulate_int8_static(qparams, xq: np.ndarray):
    """The integer pipeline of ``quantize_mlp_static`` (K7b) in numpy over
    an int8 table [d0, N]: exact int8 products (f64 BLAS, |y| < 2**53), then
    each layer's f32 multiply and add as two roundings; hidden layers
    requantize with ``np.rint`` (half to even). Returns counts [C] int64."""
    q = xq.astype(np.float64)
    n_layers = len(qparams)
    for i, (wq, comb, bq) in enumerate(qparams):
        y = (wq.astype(np.float64) @ q).astype(np.float32)
        t = y * np.asarray(comb, np.float32) + np.asarray(bq, np.float32)
        if i < n_layers - 1:
            q = np.clip(np.rint(t), 0, 127).astype(np.float64)
    pred = np.argmax(t, axis=0)
    sel = t[0] > 0
    return np.bincount(pred[sel], minlength=t.shape[0]).astype(np.int64)


SQL_A = ("select g, count(*) c,avg(infera_predict('m', f1, f2, f3, f4)) p, sum(f1) s "
         "from big where f2 > 1.0 group by g order by g")
SQL_B = ("select g, count(*), avg(infera_predict_multi_list('{m}', {cols})[1]), "
         "max(infera_predict_multi_list('{m}', {cols})[1]) from wide where c0 > 0 "
         "group by g order by g")
SQL_C = ("select g, h, min(f1) mn, max(f2) mx, count(*) c from big group by g, h "
         "having count(*) > 10 order by g, h")
# rows against the host executor: per column, None for exact (keys and
# counts) or the relative tolerance. A, C: the table block is f32 where the
# host keeps f64. B f32: the MLP's sums in another order. B bf16: a hidden
# activation's bf16 rounding can go the other way when the f32 sum before
# it differs in its last bit, which moves one row's prediction by ~1e-3.
SQL_TOL = {"A": (None, None, 1e-6, 1e-6), "B-f32": (None, None, 1e-5, 1e-5),
           "B-bf16": (None, None, 1e-3, 2e-2), "C": (None, None, 1e-7, 1e-7, None)}
# (groups in the result, K2's group slots, keys) of each query's plan
SQL_SHAPE = {"A": (64, 64, 1), "B-f32": (64, 64, 1), "B-bf16": (64, 64, 1), "C": (320, 512, 2)}


BIG_TABLE = ("create table big as select x % 64 as g, x % 5 as h, (x % 100)::float / 10.0 as f1, "
             "((x + 3) % 50)::float / 5.0 as f2, ((x * 7) % 30)::float / 3.0 as f3, "
             "((x * 11) % 90)::float / 9.0 as f4 from range({n}) r(x)")


def sql_phase(torch, itt, x_rows, peaks, device) -> list:
    """Queries A and B through Connection.execute on the card; returns the
    K2 rows of the kernels line."""
    import os

    from infera_tpu_torch.columnar import Column, Table
    from infera_tpu_torch.columnar import types as T
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.ops import fused_sql as fs
    from infera_tpu_torch.registry import MODELS
    from infera_tpu_torch.sql import Connection

    n = N_MAIN
    os.environ.pop("INFERA_PALLAS_SQL", None)   # the default: the kernel tier on CUDA
    conn = Connection()
    t0 = time.perf_counter()
    conn.execute(BIG_TABLE.format(n=n))
    wide = {f"c{k}": Column(np.ascontiguousarray(x_rows[:, k]), T.FLOAT) for k in range(32)}
    wide["g"] = Column(np.arange(n, dtype=np.int64) % 64, T.BIGINT)
    conn.register_table("wide", Table(wide))
    with tempfile.TemporaryDirectory() as d:
        proto.save_model_file(builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1), f"{d}/m.onnx")
        proto.save_model_file(
            builder.mlp_model(in_dim=32, hidden=(128, 128), out_dim=16, softmax=True),
            f"{d}/mlp.onnx")
        itt.load_model("m", f"{d}/m.onnx")
        itt.load_model("mlp_sql", f"{d}/mlp.onnx")
        itt.load_model("mlp_sql_bf16", f"{d}/mlp.onnx", "bf16")
    print(f"SQL tables and models: {time.perf_counter() - t0:.2f} s on the host clock")
    cols = ", ".join(f"c{k}" for k in range(32))
    queries = {"A": SQL_A, "B-f32": SQL_B.format(m="mlp_sql", cols=cols),
               "B-bf16": SQL_B.format(m="mlp_sql_bf16", cols=cols), "C": SQL_C}

    # ---------------------------------------------------------------- the SQL main path
    fs.fused_sql.launches = dict.fromkeys(fs.fused_sql.launches, 0)
    out, launches = {}, {}
    for key, q in queries.items():
        before = sum(fs.fused_sql.launches.values())
        out[key] = conn.execute(q).rows
        torch.cuda.synchronize()
        launches[key] = sum(fs.fused_sql.launches.values()) - before
        check(conn._exec_path == "device_plan_cuda", f"query {key} ran on {conn._exec_path}")
    print(f"SQL main path: launches {fs.fused_sql.launches}, per query {launches}")
    for key, k in launches.items():
        check(k > 0, f"K2 was not launched by query {key}")

    # ---------------------------------------------------------------- rows vs the host
    host, _ = host_rows(conn, queries)
    for key, rows in out.items():
        n_rows = SQL_SHAPE[key][0]
        check(len(rows) == len(host[key]) == n_rows, f"query {key}: {len(rows)} groups")
        worst = 0.0
        for a, b in zip(rows, host[key]):
            for x, y, rel in zip(a, b, SQL_TOL[key], strict=True):
                if rel is None:
                    check(x == y, f"query {key}: {a} vs host {b}")
                    continue
                check(np.isfinite(x) and abs(x - y) <= rel * abs(y) + 1e-12,
                      f"query {key}: {x} vs host {y}")
                worst = max(worst, abs(x - y) / max(abs(y), 1e-30))
        print(f"query {key}: {n_rows} groups, keys and counts equal the host's, worst "
              f"relative difference {worst:.3e}")

    # ---------------------------------------------------------------- steady time, phases
    for key, q in queries.items():
        conn.execute(q)
        times = []
        for _ in range(5):
            t = time.perf_counter()
            conn.execute(q)
            times.append((time.perf_counter() - t) * 1e3)
        print(f"query {key} end to end: median {float(np.median(times)):.3f} ms of 5 on the "
              f"host clock ({n / np.median(times) * 1e3:,.0f} rows/s); phases "
              f"{conn._last_phases}")

    # ---------------------------------------------------------------- K2 vs plain, times
    plans = [ent for ent in conn._device_plan_cache.values()]
    check(len(plans) == len(queries), f"{len(plans)} plans cached, expected {len(queries)}")
    tw_all = {}
    for name in ("m", "mlp_sql"):
        tw_all[name] = [(torch.as_tensor(w, device=device), torch.as_tensor(b, device=device))
                        for w, b in MODELS.get(name).mlp_plan[0]]

    def library(key, xc, row_map):
        """One PyTorch chain of the same function: addmm MLP, then index_add_
        and scatter_reduce per group; timed only, the port never calls it."""
        if key == "C":
            f1, f2 = xc[row_map["f1"]], xc[row_map["f2"]]
            slot = xc[row_map["g"]].long() * 5 + xc[row_map["h"]].long()
            cnt = torch.zeros(320, device=xc.device).index_add_(0, slot, torch.ones_like(f1))
            mn = torch.full((320,), torch.inf, device=xc.device).scatter_reduce(
                0, slot, f1, "amin")
            mx = torch.full((320,), -torch.inf, device=xc.device).scatter_reduce(
                0, slot, f2, "amax")
            return cnt, mn, mx
        if key == "A":
            f = xc[[row_map["f1"], row_map["f2"], row_map["f3"], row_map["f4"]]].T
            sel = f[:, 1] > 1.0
            h = f
            for i, (w, b) in enumerate(tw_all["m"]):
                h = torch.addmm(b, h, w)
                if i < len(tw_all["m"]) - 1:
                    h = torch.relu(h)
            vals = [h[:, 0], f[:, 0]]
        else:
            f = xc[[row_map[f"c{k}"] for k in range(32)]].T
            sel = f[:, 0] > 0
            dt = torch.bfloat16 if key == "B-bf16" else torch.float32
            h = f.to(dt)
            for i, (w, b) in enumerate(tw_all["mlp_sql"]):
                h = torch.addmm(b.to(dt), h, w.to(dt))
                if i < 2:
                    h = torch.relu(h)
            vals = [torch.softmax(h.float(), dim=1)[:, 1]]
        g = xc[row_map["g"]].long()
        slot = torch.where(sel, g, torch.full_like(g, 64))
        cnt = torch.zeros(65, device=xc.device).index_add_(0, slot, torch.ones_like(vals[0]))
        sums = [torch.zeros(65, device=xc.device).index_add_(0, slot, v) for v in vals]
        mx = torch.full((65,), -torch.inf, device=xc.device).scatter_reduce(
            0, slot, vals[0], "amax")
        return cnt, sums, mx

    rows = []
    for (key, q), (xc, packed, _, _) in zip(queries.items(), plans):
        plan = packed.plan
        check((plan.n_groups, len(plan.keys)) == SQL_SHAPE[key][1:],
              f"query {key}: plan of {plan.n_groups} groups, {len(plan.keys)} keys")
        err = 0.0
        sum_rtol, mm_rtol = (1e-3, 2e-2) if plan.bf16 else (1e-5, 1e-5)
        for n_valid in (n, N_RAGGED):
            got = fs.fused_sql(packed, xc, n_valid)
            want = fs.fused_sql_plain(packed, xc, n_valid)
            torch.cuda.synchronize()
            check(torch.equal(got["count"], want["count"]), f"K2 {key} @ {n_valid}: counts")
            check(torch.equal(got["flags"], want["flags"]), f"K2 {key} @ {n_valid}: flags")
            torch.testing.assert_close(got["sums"], want["sums"], rtol=sum_rtol, atol=1e-9)
            torch.testing.assert_close(got["mm"], want["mm"], rtol=mm_rtol, atol=mm_rtol)
            e = max([0.0] + [float((got[k] - want[k]).abs().max())
                             for k in ("sums", "mm") if got[k].numel()])
            err = max(err, e)
            print(f"K2 {key} @ {n_valid} rows: counts and flags equal plain, max abs err {e:.3e}")
        row_map = _block_rows(conn, "wide" if key.startswith("B") else "big", xc)
        kern_times = device_ms(torch, lambda: fs.fused_sql(packed, xc, n))
        ms, q25, q75 = (float(v) for v in np.percentile(kern_times, [50, 25, 75]))
        plain_ms = float(np.median(device_ms(torch, lambda: fs.fused_sql_plain(packed, xc, n),
                                             runs=5)))
        library_ms = float(np.median(device_ms(torch, lambda: library(key, xc, row_map))))
        res = fs.fused_sql(packed, xc, n)
        n_sel = int(res["count"].sum())
        macs = sum(w.shape[0] * w.shape[1] for m in plan.mlps for w, _ in m.params)
        used = {arg for prog in plan.slot_programs + [f for m in plan.mlps for f in m.features]
                for op, arg in prog if op == fs.COL}
        b_ms, b_by = bound(2.0 * n_sel * macs, 4.0 * len(used) * n,
                           "bf16" if plan.bf16 else "f32", peaks)
        # a plan with MLP slots is K2 with K2' inside it (the MLP is most of
        # its work); query C is K2's core slots alone
        if plan.mlps:
            label = "K2'-bf16 fused_sql with in-kernel MLP" if plan.bf16 else \
                "K2'-f32 fused_sql with in-kernel MLP"
            replaces = "infera_tpu/sql/device_plan.py:633"
        else:
            label, replaces = "K2 fused_sql core slots", "infera_tpu/ops/pallas_sql.py:71"
        rows.append({"name": f"{label} (query {key[0]})", "route": "cuda",
                     "source": "infera_tpu_torch/csrc/fused_sql.cu",
                     "replaces": replaces, "launches": launches[key],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms})
        print(f"K2 {key}: kernel {ms:.4f} ms (quartiles {q25:.4f}-{q75:.4f}), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"{len(used)} columns, {n_sel} selected rows, {2.0 * n_sel * macs / 1e9:.2f} G "
              f"MLP operations, {packed.smem_bytes} B of shared memory")
        if plan.mlps:
            run, dense = fs.mlp_subtiles(packed, xc, n)
            on = "the rows the WHERE keeps" if fs.mlp_on_kept_rows(plan) else "every row"
            print(f"K2' {key}: {run} MLP sub-tiles of 64 rows run (on {on}), against {dense} "
                  f"in a pass over every row")
        sql_split(torch, key, packed, xc, n)
        if plan.bf16:
            per_sm = fs.resident_blocks(device, packed.smem_bytes, True)
            check(per_sm >= 2, f"K2 {key}: {per_sm} blocks resident an SM, expected 2 or more")
    return rows


# config 4 (BASELINE.json): a 64-tree depth-6 GBT over 16 features, and a
# 3-class classifier of the same shape with labels 7, 19, 42
N_TREE_ENGINE = 262_144   # infera_tpu/testing/benchmarks.py bench_config4_gbt's rows
GBT = dict(n_features=16, n_trees=64, depth=6, seed=0)
GBC = dict(n_features=16, n_trees=64, depth=6, n_classes=3, labels=[7, 19, 42], seed=3)
TREE_FEATS = ", ".join(f"c{k}" for k in range(16))
SQL_D = ("select g, count(*) c, avg(infera_predict('gbt', {f})) p, "
         "max(infera_predict('gbt', {f})) mx from wide "
         "where infera_predict('gbt', {f}) > 0.5 group by g order by g").format(f=TREE_FEATS)
SQL_E = ("select g, count(*), avg(infera_predict('gbc', {f})), "
         "min(infera_predict('gbc', {f})) from wide group by g order by g").format(f=TREE_FEATS)
# a forest whose records (512 x 127 x 8 B, 520 KB) stay in device memory:
# 512 trees of depth 6 over 8 features, inside the 2 MiB strip limit of
# kernel_forest (over 16 features it would not be)
GBT512 = dict(n_features=8, n_trees=512, depth=6, seed=9)
SQL_D512 = ("select g, count(*) c, avg(infera_predict('gbt512', {f})) p, "
            "max(infera_predict('gbt512', {f})) mx from wide "
            "where infera_predict('gbt512', {f}) > 0.5 group by g order by g").format(
                f=", ".join(f"c{k}" for k in range(8)))
# rows against the host executor: keys and counts exact; D's prediction
# aggregates rel 1e-5 (the host's GEMM forest adds the leaves in another
# order); E's labels exact, so their average and minimum too
TREE_TOL = {"D": (None, None, 1e-5, 1e-5), "E": (None, None, None, None)}


def numpy_walk(model, x: np.ndarray) -> np.ndarray:
    """The regressor's value per row of x by walking each tree from the
    model's node attributes in numpy (every branch BRANCH_LEQ)."""
    a = {k: v.value for k, v in model.graph.nodes[0].attributes.items()}
    at = {(t, nd): k for k, (t, nd) in enumerate(zip(a["nodes_treeids"], a["nodes_nodeids"]))}
    leaf_w = {(t, nd): w for t, nd, w in zip(a["target_treeids"], a["target_nodeids"],
                                             a["target_weights"])}
    out = np.full(len(x), a["base_values"][0], np.float64)
    for i, row in enumerate(x):
        for t in sorted(set(a["nodes_treeids"])):
            k = at[(t, 0)]
            while a["nodes_modes"][k] != "LEAF":
                go = row[a["nodes_featureids"][k]] <= np.float32(a["nodes_values"][k])
                k = at[(t, a["nodes_truenodeids"][k] if go else a["nodes_falsenodeids"][k])]
            out[i] += leaf_w[(t, a["nodes_nodeids"][k])]
    return out


def tree_phase(torch, itt, x_rows, peaks, device) -> list:
    """Config 4 on the card: engine predict of the GBT over 262,144 rows,
    then queries D (regressor) and E (classifier) through Connection.execute
    with K4 inside K2, each plan's route, split and registers, and the
    512-tree forest on the device-memory route; returns the K4 rows of the
    kernels line."""
    import os

    from infera_tpu_torch.columnar import Column, Table
    from infera_tpu_torch.columnar import types as T
    from infera_tpu_torch.onnx import builder, ml_ops, proto
    from infera_tpu_torch.ops import fused_sql as fs
    from infera_tpu_torch.registry import MODELS
    from infera_tpu_torch.sql import Connection

    gbt_model = builder.gbt_regressor_model(**GBT)
    with tempfile.TemporaryDirectory() as d:
        proto.save_model_file(gbt_model, f"{d}/gbt.onnx")
        proto.save_model_file(builder.gbt_classifier_model(**GBC), f"{d}/gbc.onnx")
        itt.load_model("gbt", f"{d}/gbt.onnx")
        itt.load_model("gbc", f"{d}/gbc.onnx")

    # ---------------------------------------------------------------- engine predict
    os.environ.pop("INFERA_TREE_MODE", None)          # auto: the GEMM forest
    x_eng = np.random.default_rng(0).standard_normal((N_TREE_ENGINE, 16)).astype(np.float32)
    res = itt.predict("gbt", x_eng)
    check((res.rows, res.cols) == (N_TREE_ENGINE, 1), f"tree predict {res.rows}x{res.cols}")
    check(bool(np.isfinite(res.data).all()), "tree predict: non-finite output")
    os.environ["INFERA_TREE_MODE"] = "gather"
    gathered = itt.predict("gbt", x_eng).data
    os.environ.pop("INFERA_TREE_MODE")
    np.testing.assert_allclose(res.data, gathered, rtol=1e-5, atol=1e-6)
    sample = np.random.default_rng(5).choice(N_TREE_ENGINE, 2000, replace=False)
    np.testing.assert_allclose(res.data[sample], numpy_walk(gbt_model, x_eng[sample]),
                               rtol=1e-5, atol=1e-6)
    packed_trees = ml_ops._cached_pack(MODELS.get("gbt").graph.nodes[0], 1, "target")
    x_eng_dev = torch.as_tensor(x_eng, device=device)
    forest_ms = float(np.median(device_ms(torch, lambda: packed_trees.evaluate(x_eng_dev),
                                          runs=10)))
    predict_ms = host_ms(torch, lambda: itt.predict("gbt", x_eng), runs=5)
    print(f"engine tree predict @ {N_TREE_ENGINE} rows (config 4, 64 trees of depth 6): "
          f"{predict_ms:.3f} ms on the host clock = {N_TREE_ENGINE / predict_ms * 1e3:,.0f} "
          f"rows/s; GEMM forest alone {forest_ms:.4f} ms by CUDA events; outputs equal the "
          f"gather traversal and a numpy walk of 2000 rows to 1e-5")

    # ---------------------------------------------------------------- queries D and E
    n = N_MAIN
    os.environ.pop("INFERA_PALLAS_SQL", None)
    conn = Connection()
    wide = {f"c{k}": Column(np.ascontiguousarray(x_rows[:, k]), T.FLOAT) for k in range(32)}
    wide["g"] = Column(np.arange(n, dtype=np.int64) % 64, T.BIGINT)
    conn.register_table("wide", Table(wide))
    queries = {"D": SQL_D, "E": SQL_E}

    fs.fused_sql.launches = dict.fromkeys(fs.fused_sql.launches, 0)
    out, launches = {}, {}
    for key, q in queries.items():
        before = fs.fused_sql.launches["forest"]
        out[key] = conn.execute(q).rows
        torch.cuda.synchronize()
        launches[key] = fs.fused_sql.launches["forest"] - before
        check(conn._exec_path == "device_plan_cuda", f"query {key} ran on {conn._exec_path}")
    print(f"tree SQL main path: launches {fs.fused_sql.launches}, K4 per query {launches}")
    for key, k in launches.items():
        check(k > 0, f"K4 was not launched by query {key}")

    host, _ = host_rows(conn, queries)
    for key, rows in out.items():
        check(len(rows) == len(host[key]) == 64, f"query {key}: {len(rows)} groups")
        worst = 0.0
        for a, b in zip(rows, host[key]):
            for x, y, rel in zip(a, b, TREE_TOL[key], strict=True):
                if rel is None:
                    check(x == y, f"query {key}: {a} vs host {b}")
                    continue
                check(np.isfinite(x) and abs(x - y) <= rel * abs(y) + 1e-12,
                      f"query {key}: {x} vs host {y}")
                worst = max(worst, abs(x - y) / max(abs(y), 1e-30))
        if key == "E":
            check(all(r[3] in (7.0, 19.0, 42.0) for r in rows), "query E: a label not 7/19/42")
        print(f"query {key}: 64 groups, {sum(r[1] for r in rows)} rows kept, keys and counts "
              f"equal the host's, worst relative difference {worst:.3e}")

    for key, q in queries.items():
        conn.execute(q)
        times = []
        for _ in range(5):
            t = time.perf_counter()
            conn.execute(q)
            times.append((time.perf_counter() - t) * 1e3)
        print(f"query {key} end to end: median {float(np.median(times)):.3f} ms of 5 on the "
              f"host clock ({n / np.median(times) * 1e3:,.0f} rows/s); phases "
              f"{conn._last_phases}")

    # ---------------------------------------------------------------- K2+K4 vs plain, times
    plans = list(conn._device_plan_cache.values())
    check(len(plans) == len(queries), f"{len(plans)} plans cached, expected {len(queries)}")
    gbc_trees = ml_ops._cached_pack(MODELS.get("gbc").graph.nodes[0], 3, "class")
    labels = torch.tensor([7.0, 19.0, 42.0], device=device)

    def library(key, xc, row_map):
        """One PyTorch chain of the same function: the port's GEMM forest,
        then index_add_ and scatter_reduce per group; timed only, the port's
        kernel tier never calls it."""
        f = xc[[row_map[f"c{k}"] for k in range(16)]].T
        g = xc[row_map["g"]].long()
        if key == "D":
            v = packed_trees.gemm_eval(f)[:, 0] + 0.5
            slot = torch.where(v > 0.5, g, torch.full_like(g, 64))
            ext = torch.full((65,), -torch.inf, device=xc.device).scatter_reduce(
                0, slot, v, "amax")
        else:
            v = labels[gbc_trees.gemm_eval(f).argmax(dim=1)]
            slot = g
            ext = torch.full((65,), torch.inf, device=xc.device).scatter_reduce(
                0, slot, v, "amin")
        cnt = torch.zeros(65, device=xc.device).index_add_(0, slot, torch.ones_like(v))
        sums = torch.zeros(65, device=xc.device).index_add_(0, slot, v)
        return cnt, sums, ext

    from infera_tpu_torch.ops import _kernels

    rows = []
    for (key, q), (xc, packed, _, _) in zip(queries.items(), plans):
        plan = packed.plan
        (slot,) = plan.forests
        # where K4 reads the forest, the instance it runs in and its blocks
        (route,) = fs.forest_routes(packed)
        _grid, per_sm = fs.plan_grid(packed, n, xc.device)
        regs, stack, spill = _kernels.ptxas_usage("fused_sql",
                                                  sql_instance(fs.wide_instance(plan)))
        check(spill == 0, f"K4 {key}: ptxas spills {spill} B in its instance")
        check(route["records"] == "shared" and route["features"] == "tile" and per_sm >= 2,
              f"K4 {key}: route {route}, {per_sm} blocks an SM")
        sql_split(torch, key, packed, xc, n)
        check((plan.n_groups, len(plan.keys), slot.n_trees) == (64, 1, 64),
              f"query {key}: plan of {plan.n_groups} groups, {len(plan.keys)} keys")
        err = 0.0
        for n_valid in (n, N_RAGGED):
            got = fs.fused_sql(packed, xc, n_valid)
            want = fs.fused_sql_plain(packed, xc, n_valid)
            torch.cuda.synchronize()
            check(torch.equal(got["count"], want["count"]), f"K4 {key} @ {n_valid}: counts")
            check(torch.equal(got["flags"], want["flags"]), f"K4 {key} @ {n_valid}: flags")
            # each row's prediction is the plain version's bit for bit; only
            # the order of the f64 sums differs
            torch.testing.assert_close(got["sums"], want["sums"], rtol=1e-12, atol=1e-9)
            torch.testing.assert_close(got["mm"], want["mm"], rtol=0, atol=0)
            e = max([0.0] + [float((got[k] - want[k]).abs().max()) for k in ("sums", "mm")])
            err = max(err, e)
            print(f"K4 {key} @ {n_valid} rows: counts and flags equal plain, max abs err {e:.3e}")
        row_map = _block_rows(conn, "wide", xc)
        kern_times = device_ms(torch, lambda: fs.fused_sql(packed, xc, n))
        ms, q25, q75 = (float(v) for v in np.percentile(kern_times, [50, 25, 75]))
        plain_ms = float(np.median(device_ms(torch, lambda: fs.fused_sql_plain(packed, xc, n),
                                             runs=5)))
        library_ms = float(np.median(device_ms(torch, lambda: library(key, xc, row_map),
                                               runs=5)))
        used = {arg for prog in plan.slot_programs + [f for p in plan.preds for f in p.features]
                for op, arg in prog if op == fs.COL}
        # per row: depth compares in every tree, one add per tree and class
        ops = float(n) * slot.n_trees * (slot.max_depth + (slot.n_out if slot.classifier else 1))
        b_ms, b_by = bound(ops, 4.0 * len(used) * n, "f32", peaks)
        kind = "classifier" if slot.classifier else "regressor"
        rows.append({"name": f"K4 {kind} (query {key})", "route": "cuda",
                     "source": "infera_tpu_torch/csrc/fused_sql.cu",
                     "replaces": "infera_tpu/sql/device_plan.py:734", "launches": launches[key],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms})
        print(f"K4 {key}: kernel {ms:.4f} ms (quartiles {q25:.4f}-{q75:.4f}), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"{len(used)} columns, {ops / 1e9:.3f} G operations, {packed.trees.numel() * 4} B "
              f"of forest tables; route: records {route['records']}, leaf weights "
              f"{route['weights']}, features {route['features']}; {packed.smem_bytes} B of "
              f"shared memory, {per_sm} blocks an SM, {fs.TREES_IN_FLIGHT} trees in flight; "
              f"ptxas {regs} registers, {stack} B stack, {spill} B spill "
              f"({sql_instance(fs.wide_instance(plan))})")

    # ---------------------------------------------------------------- 512 trees
    # records past two blocks' share of an SM: the walk reads device memory
    with tempfile.TemporaryDirectory() as d:
        proto.save_model_file(builder.gbt_regressor_model(**GBT512), f"{d}/gbt512.onnx")
        itt.load_model("gbt512", f"{d}/gbt512.onnx")
    before = fs.fused_sql.launches["forest"]
    big_rows = conn.execute(SQL_D512).rows
    torch.cuda.synchronize()
    check(conn._exec_path == "device_plan_cuda" and fs.fused_sql.launches["forest"] == before + 1,
          f"512-tree query ran on {conn._exec_path}")
    check(len(big_rows) == 64 and all(np.isfinite(r[2]) for r in big_rows if r[1]),
          "512-tree query: rows")
    xc, packed, _, _ = list(conn._device_plan_cache.values())[-1]
    (route,) = fs.forest_routes(packed)
    check(route["records"] == "device" and route["features"] == "tile",
          f"512-tree forest: route {route}")
    got = fs.fused_sql(packed, xc, N_RAGGED)
    want = fs.fused_sql_plain(packed, xc, N_RAGGED)
    torch.cuda.synchronize()
    check(torch.equal(got["count"], want["count"]) and torch.equal(got["flags"], want["flags"]),
          "K4 512 trees: counts and flags")
    torch.testing.assert_close(got["sums"], want["sums"], rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(got["mm"], want["mm"], rtol=0, atol=0)
    del want
    _grid, per_sm = fs.plan_grid(packed, n, xc.device)
    big_ms = float(np.median(device_ms(torch, lambda: fs.fused_sql(packed, xc, n))))
    print(f"K4 512 trees of depth 6 (8 features) @ {N_RAGGED} rows: counts, flags and min/max "
          f"equal plain, sums to 1e-12; route: records {route['records']}, features "
          f"{route['features']}; {packed.smem_bytes} B of shared memory, {per_sm} blocks an SM; "
          f"kernel {big_ms:.4f} ms @ {n} rows (CUDA events, median of 25)")
    return rows


# config 3 (BASELINE.json): infera_tpu/testing/benchmarks.py bench_config3_join's
# 8-feature, 4-output map as an ONNX model over a 1,048,576-row source,
# joined back to a 1,048,576-row dimension (DIM_MAX_ROWS) through SQL
P_F = "infera_predict_multi_list('m3', x0, x1, x2, x3, x4, x5, x6, x7)[{}]"
SQL_F = (f"select cat, count(*), avg({P_F.format(1)}), sum({P_F.format(2)} * w), "
         f"max({P_F.format(4)}) from src join meta on src.id = meta.id "
         f"where {P_F.format(3)} > 0 group by cat order by cat")
# infera_tpu/testing/e2e_eval.py eval_outer_join: fact keys 1000..1099 have no
# dim row; H is tests/test_pallas_sql.py's outer-join shape at the same size
SQL_G = ("select count(*), count(w), sum(v), sum(coalesce(w, 0.0)) from fact {kind} join dim "
         "on fact.k = dim.k")
SQL_H = ("select og, count(*), sum(w), min(w), max(v) from fact left join dim "
         "on fact.k = dim.k group by og order by og")
# rows against the host executor: keys, counts, minima and maxima exact (the
# host's predictions come from K6, whose layer sums in K2''s order); sums and
# averages rel 1e-5 (f64 sums of f32 values in another order, and the host
# multiplies P(2) by w in f64)
JOIN_TOL = {"F": (None, None, 1e-5, 1e-5, None), "G-LEFT": (None, None, 1e-5, 1e-5),
            "G-FULL": (None, None, 1e-5, 1e-5), "H": (None, None, 1e-5, None, None)}
JOIN_GROUPS = {"F": 16, "G-LEFT": 1, "G-FULL": 1, "H": 6}


def fma_map(x: np.ndarray, w: np.ndarray, b: np.ndarray) -> np.ndarray:
    """x [n, d] @ w [d, m] + b in f32 as the in-kernel layer sums it: from
    0, one fused multiply-add per input in input order (the product of two
    f32 values is exact in f64), then the bias."""
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k in range(x.shape[1]):
        acc = (acc.astype(np.float64) + x[:, k:k + 1].astype(np.float64)
               * w[k].astype(np.float64)).astype(np.float32)
    return acc + b.astype(np.float32)


def join_phase(torch, itt, peaks, device) -> list:
    """Config 3 on the card: query F (the multi-output map joined back to
    its source) and the outer joins G-LEFT, G-FULL and H through
    Connection.execute, each one launch of K5; returns the K5 rows of the
    kernels line."""
    import os

    from infera_tpu_torch.columnar import Column, Table
    from infera_tpu_torch.columnar import types as T
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.ops import fused_sql as fs
    from infera_tpu_torch.registry import MODELS
    from infera_tpu_torch.sql import Connection, device_plan

    n = N_MAIN
    os.environ.pop("INFERA_PALLAS_SQL", None)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        proto.save_model_file(
            builder.mlp_model(in_dim=8, hidden=(), out_dim=4, softmax=False, seed=0),
            f"{d}/m3.onnx")
        itt.load_model("m3", f"{d}/m3.onnx")
    rng = np.random.default_rng(0)
    ids = rng.permutation(n).astype(np.int64)
    x = rng.standard_normal((n, 8), dtype=np.float32)
    mid = np.arange(n, dtype=np.int64)
    w_meta = np.random.default_rng(1).standard_normal(n, dtype=np.float32)
    conn = Connection()
    src = {"id": Column(ids, T.BIGINT)}
    src.update({f"x{k}": Column(np.ascontiguousarray(x[:, k]), T.FLOAT) for k in range(8)})
    conn.register_table("src", Table(src))
    conn.register_table("meta", Table({"id": Column(mid, T.BIGINT),
                                       "w": Column(w_meta, T.FLOAT),
                                       "cat": Column(mid % 16, T.BIGINT)}))
    conn.execute(f"create table fact as select x % 1100 as k, (x % 40)::float / 4.0 as v, "
                 f"x % 6 as og from range({n}) r(x)")
    conn.execute("create table dim as select x as k, (x * 2)::float as w from range(1000) r(x)")
    print(f"join tables and model: {time.perf_counter() - t0:.2f} s on the host clock")
    queries = {"F": SQL_F, "G-LEFT": SQL_G.format(kind="left"),
               "G-FULL": SQL_G.format(kind="full"), "H": SQL_H}

    # ---------------------------------------------------------------- the join main path
    fs.fused_sql.launches = dict.fromkeys(fs.fused_sql.launches, 0)
    out, launches = {}, {}
    for key, q in queries.items():
        before = fs.fused_sql.launches["join"]
        out[key] = conn.execute(q).rows
        torch.cuda.synchronize()
        launches[key] = fs.fused_sql.launches["join"] - before
        check(conn._exec_path == "device_join_plan_cuda", f"query {key} ran on {conn._exec_path}")
        print(f"query {key}: path {conn._exec_path}, K5 launches {launches[key]}")
    print(f"join main path: launches {fs.fused_sql.launches}, K5 per query {launches}")
    for key, k in launches.items():
        check(k == 1, f"query {key} launched K5 {k} times, not once")

    # ---------------------------------------------------------------- rows vs the host
    host, host_ms_ = host_rows(conn, queries, "device_join")
    for key, ms in host_ms_.items():
        print(f"host executor, query {key}: {ms:.1f} ms on the host clock through the device "
              f"sort-join")
    for key, rows in out.items():
        check(len(rows) == len(host[key]) == JOIN_GROUPS[key], f"query {key}: {len(rows)} rows")
        worst = 0.0
        for a, b in zip(rows, host[key]):
            for v, y, rel in zip(a, b, JOIN_TOL[key], strict=True):
                if rel is None:
                    check(v == y, f"query {key}: {a} vs host {b}")
                    continue
                check(np.isfinite(v) and abs(v - y) <= rel * abs(y) + 1e-12,
                      f"query {key}: {v} vs host {y}")
                worst = max(worst, abs(v - y) / max(abs(y), 1e-30))
        print(f"query {key}: {len(rows)} rows, keys, counts, minima and maxima equal the "
              f"host's, worst relative difference {worst:.3e}: {rows[:2]}")
    # F against numpy: the lookup, the f32 map, np.add.at
    (wt, bias), = MODELS.get("m3").mlp_plan[0]
    lookup = np.full(n, -1, np.int64)
    lookup[mid] = np.arange(n)
    y = fma_map(x, np.asarray(wt, np.float32), np.asarray(bias, np.float32))
    cnt = np.zeros(16, np.int64)
    np.add.at(cnt, (mid % 16)[lookup[ids]][y[:, 2] > 0], 1)
    check([r[1] for r in out["F"]] == cnt.tolist(), f"query F counts {out['F']} vs numpy {cnt}")
    print(f"query F: counts equal numpy's ({int(cnt.sum())} rows kept)")
    g_cw = (n // 1100) * 1000 + min(n % 1100, 1000)
    for key in ("G-LEFT", "G-FULL"):
        check(out[key][0][:2] == (n, g_cw), f"query {key}: counts {out[key][0][:2]}")

    # ---------------------------------------------------------------- steady time, phases
    for key, q in queries.items():
        conn.execute(q)
        times = []
        for _ in range(5):
            t = time.perf_counter()
            conn.execute(q)
            times.append((time.perf_counter() - t) * 1e3)
        med, q25, q75 = (float(v) for v in np.percentile(times, [50, 25, 75]))
        print(f"query {key} end to end: median {med:.3f} ms of 5 (quartiles {q25:.3f}-"
              f"{q75:.3f}) on the host clock ({n / med * 1e3:,.0f} fact rows/s); phases "
              f"{conn._last_phases}")

    # ---------------------------------------------------------------- K5 vs plain, times
    plans = list(conn._device_plan_cache.values())
    check(len(plans) == len(queries), f"{len(plans)} plans cached, expected {len(queries)}")
    w3 = torch.as_tensor(np.asarray(wt, np.float32), device=device)
    b3 = torch.as_tensor(np.asarray(bias, np.float32), device=device)

    def library(key, xc, rows_f, dim_xc, rows_d, lookup_t):
        """One PyTorch chain of the same function: the lookup gather,
        index_select of the dim columns, torch.matmul for the map, then
        index_add_ and scatter_reduce per group; timed only, the port never
        calls it."""
        fk = xc[rows_f["id" if key == "F" else "k"]].long()
        ridx = lookup_t[fk.clamp(0, len(lookup_t) - 1)]
        matched = (ridx >= 0) & (fk < len(lookup_t))
        ridx = ridx.clamp(min=0).long()
        w = dim_xc[rows_d["w"]].index_select(0, ridx)
        if key == "F":
            cat = dim_xc[rows_d["cat"]].index_select(0, ridx).long()
            p = torch.matmul(xc[[rows_f[f"x{k}"] for k in range(8)]].T, w3) + b3
            slot = torch.where(matched & (p[:, 2] > 0), cat, torch.full_like(cat, 16))
            cnt = torch.zeros(17, device=xc.device).index_add_(0, slot, torch.ones_like(w))
            s1 = torch.zeros(17, device=xc.device).index_add_(0, slot, p[:, 0])
            s2 = torch.zeros(17, device=xc.device).index_add_(0, slot, p[:, 1] * w)
            mx = torch.full((17,), -torch.inf, device=xc.device).scatter_reduce(
                0, slot, p[:, 3], "amax")
            return cnt, s1, s2, mx
        wm = torch.where(matched, w, 0.0)
        v = xc[rows_f["v"]]
        if key != "H":
            return (matched.sum(), v.sum(), wm.sum())
        og = xc[rows_f["og"]].long()
        m = matched.float()
        cnt = torch.zeros(6, device=xc.device).index_add_(0, og, torch.ones_like(v))
        cw = torch.zeros(6, device=xc.device).index_add_(0, og, m)
        sw = torch.zeros(6, device=xc.device).index_add_(0, og, wm)
        mn = torch.full((6,), torch.inf, device=xc.device).scatter_reduce(
            0, og, torch.where(matched, w, torch.inf), "amin")
        mx = torch.full((6,), -torch.inf, device=xc.device).scatter_reduce(0, og, v, "amax")
        return cnt, cw, sw, mn, mx

    rows = []
    for (key, q), (xc, packed, dim_xc, _) in zip(queries.items(), plans):
        plan = packed.plan
        check(plan.join is not None and plan.n_groups >= JOIN_GROUPS[key],
              f"query {key}: plan of {plan.n_groups} groups, join {plan.join}")
        err = 0.0
        for n_valid in (n, N_RAGGED):
            got = fs.fused_sql(packed, xc, n_valid, dim_xc)
            want = fs.fused_sql_plain(packed, xc, n_valid, dim_xc)
            torch.cuda.synchronize()
            check(torch.equal(got["count"], want["count"]), f"K5 {key} @ {n_valid}: counts")
            check(torch.equal(got["flags"], want["flags"]), f"K5 {key} @ {n_valid}: flags")
            check(torch.equal(got["mm"], want["mm"]), f"K5 {key} @ {n_valid}: minima, maxima")
            # every row's values are the plain version's bit for bit; only the
            # order of the f64 sums differs
            torch.testing.assert_close(got["sums"], want["sums"], rtol=1e-12, atol=1e-9)
            e = float((got["sums"] - want["sums"]).abs().max()) if got["sums"].numel() else 0.0
            err = max(err, e)
            print(f"K5 {key} @ {n_valid} rows: counts, flags, minima and maxima equal plain, "
                  f"sums' max abs err {e:.3e}")
        fact_name, dim_name = ("src", "meta") if key == "F" else ("fact", "dim")
        rows_f = _block_rows(conn, fact_name, xc)
        rows_d = _block_rows(conn, dim_name, dim_xc)
        kern_times = device_ms(torch, lambda: fs.fused_sql(packed, xc, n, dim_xc))
        ms, q25, q75 = (float(v) for v in np.percentile(kern_times, [50, 25, 75]))
        plain_ms = float(np.median(device_ms(
            torch, lambda: fs.fused_sql_plain(packed, xc, n, dim_xc), runs=5)))
        library_ms = float(np.median(device_ms(
            torch, lambda: library(key, xc, rows_f, dim_xc, rows_d, packed.lookup))))
        progs = plan.slot_programs + [f for p in plan.preds for f in p.features]
        used_f = {arg for prog in progs for op, arg in prog if op == fs.COL} | {plan.join.fact_key}
        used_d = {arg for prog in progs for op, arg in prog if op == fs.DIM}
        nbytes = 4.0 * (len(used_f) * n + packed.lookup.numel() + len(used_d) * plan.join.n_dim)
        macs = sum(wl.shape[0] * wl.shape[1] for m in plan.mlps for wl, _ in m.params)
        instr = sum(len(prog) for prog in progs)
        b_ms, b_by = bound(float(n) * (2.0 * macs + instr), nbytes, "f32", peaks)
        rows.append({"name": f"K5 fused join plan (query {key})", "route": "cuda",
                     "source": "infera_tpu_torch/csrc/fused_sql.cu",
                     "replaces": "infera_tpu/ops/pallas_sql.py:668", "launches": launches[key],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms})
        print(f"K5 {key}: kernel {ms:.4f} ms (quartiles {q25:.4f}-{q75:.4f}), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"{len(used_f)} fact and {len(used_d)} dim columns, lookup of "
              f"{packed.lookup.numel()} entries, {nbytes / 1e6:.1f} MB, {packed.smem_bytes} B "
              f"of shared memory")
        sql_split(torch, key, packed, xc, n, dim_xc)
    return rows


# the aggregate tail (K2 b–e, infera_tpu's slot families of
# tests/test_pallas_sql.py:188-275,472-500) over 1,048,576 rows: mv's largest
# count is unique in every group; v is a BIGINT near +-2**44, past f32 and
# past f64's exact sums per group
TAIL_TABLE = ("create table tail as select x % 64 as g, x % 5 as h, x as id, x % 500 as k500, "
              "((x % 12) * (x % 5)) % 9 as mv, "
              "(case when x % 3 = 0 then -1 else 1 end) * (17592186044421 + x * 7) as v, "
              "(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
              "((x * 7) % 30)::float / 3.0 as f3, ((x * 11) % 90)::float / 9.0 as f4 "
              "from range({n}) r(x)")
P_T = "infera_predict('mt', f1, f2, f3, f4)"
P_K = "infera_predict_multi_list('mk', {cols})[1]"
SQL_I = (f"select g, stddev(f1), var_pop({P_T}), count_if({P_T} > 0.0), bool_and(f1 >= 0.0), "
         f"bool_or(f2 > 9.0), product(1.0 + f3 / 1000.0), avg(h) from tail group by g order by g")
SQL_J = ("select g, count(distinct h), sum(distinct k500), avg(distinct k500), mode(mv), "
         "count(*) from tail group by g order by g")
SQL_K = (f"select g, arg_max(id, {P_K}), arg_min(id, c0), arg_max(id, h) from wide "
         f"group by g order by g")
SQL_L = ("select g, sum(v), avg(v), min(v), max(v) from tail where f1 > 1.0 "
         "group by g order by g")
# rows against the host executor: per column None for exact (keys, counts,
# integers, DISTINCT results, modes, arg values, int64 sums and extremes) or
# the relative tolerance: 1e-3 for the variance family and the product (the
# reference's own tail tests; the f32 block and log2 sums), 1e-12 for an
# average (an exact int64 total over a count, where the host sums in f64)
TAIL_TOL = {"I": (None, 1e-3, 1e-3, None, None, None, 1e-3, 1e-12),
            "J": (None, None, None, 1e-12, None, None), "K": (None, None, None, None),
            "L": (None, None, 1e-12, None, None)}
# the family each query exercises: (row name, TPU kernel it replaces, the
# launch counter of fused_sql that counts it)
TAIL_KERNELS = {"I": ("K2 b sum-slot families", "infera_tpu/sql/device_plan.py:951", "int_sum"),
                "J": ("K2 c DISTINCT/MODE counts", "infera_tpu/ops/pallas_sql.py:264",
                      "distinct"),
                "K": ("K2 d arg_min/arg_max", "infera_tpu/ops/pallas_sql.py:294", "arg"),
                "L": ("K2 e exact int64 min/max", "infera_tpu/ops/pallas_sql.py:324",
                      "int_minmax")}


def compare_rows(key, rows, host, tols) -> float:
    """Rows against the host's, per column exact or within its relative
    tolerance; returns the largest relative difference seen."""
    check(len(rows) == len(host), f"query {key}: {len(rows)} rows vs host {len(host)}")
    worst = 0.0
    for a, b in zip(rows, host):
        for x, y, rel in zip(a, b, tols, strict=True):
            if rel is None:
                check(x == y, f"query {key}: {a} vs host {b}")
                continue
            check(np.isfinite(x) and abs(x - y) <= rel * abs(y) + 1e-12,
                  f"query {key}: {x} vs host {y}")
            worst = max(worst, abs(x - y) / max(abs(y), 1e-30))
    return worst


def tail_phase(torch, itt, x_rows, peaks, device) -> list:
    """The aggregate tail on the card: queries I–L through
    Connection.execute, each one K2 launch; returns the K2 b–e rows of the
    kernels line."""
    import os

    from infera_tpu_torch.columnar import Column, Table
    from infera_tpu_torch.columnar import types as T
    from infera_tpu_torch.errors import SqlError
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.ops import fused_sql as fs
    from infera_tpu_torch.registry import MODELS
    from infera_tpu_torch.sql import Connection

    n = N_MAIN
    os.environ.pop("INFERA_PALLAS_SQL", None)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        # the flagship's widths without its one-class softmax, which is 1.0
        # on every row: here the prediction varies
        proto.save_model_file(builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1, softmax=False),
                              f"{d}/mt.onnx")
        proto.save_model_file(
            builder.mlp_model(in_dim=32, hidden=(128, 128), out_dim=16, softmax=True),
            f"{d}/mk.onnx")
        itt.load_model("mt", f"{d}/mt.onnx")
        itt.load_model("mk", f"{d}/mk.onnx")
    conn = Connection()
    conn.execute(TAIL_TABLE.format(n=n))
    wide = {f"c{k}": Column(np.ascontiguousarray(x_rows[:, k]), T.FLOAT) for k in range(32)}
    ids = np.arange(n, dtype=np.int64)
    wide.update(g=Column(ids % 64, T.BIGINT), h=Column(ids % 5, T.BIGINT),
                id=Column(ids, T.BIGINT))
    conn.register_table("wide", Table(wide))
    print(f"tail tables and models: {time.perf_counter() - t0:.2f} s on the host clock")
    cols = ", ".join(f"c{k}" for k in range(32))
    queries = {"I": SQL_I, "J": SQL_J, "K": SQL_K.format(cols=cols), "L": SQL_L}

    # ---------------------------------------------------------------- the tail's main path
    fs.fused_sql.launches = dict.fromkeys(fs.fused_sql.launches, 0)
    out, first = {}, {}
    for key, q in queries.items():
        before = fs.fused_sql.launches["f32"]
        out[key] = conn.execute(q).rows
        torch.cuda.synchronize()
        first[key] = fs.fused_sql.launches["f32"] - before
        check(conn._exec_path == "device_plan_cuda", f"query {key} ran on {conn._exec_path}")
    main_launches = dict(fs.fused_sql.launches)
    plans = list(conn._device_plan_cache.values())
    check(len(plans) == len(queries), f"{len(plans)} plans cached, expected {len(queries)}")
    print(f"tail main path: launches {main_launches}; K2 per query, its probes included: {first}")
    for key, (_name, _src, counter) in TAIL_KERNELS.items():
        check(main_launches[counter] > 0, f"{counter} was not launched by query {key}")
    for key, q in queries.items():
        before = fs.fused_sql.launches["f32"]
        conn.execute(q)
        torch.cuda.synchronize()
        k = fs.fused_sql.launches["f32"] - before
        check(conn._exec_path == "device_plan_cuda" and k == 1,
              f"query {key} again: {conn._exec_path}, {k} K2 launches")
    print("tail queries again, their probes cached: one K2 launch each")

    # ---------------------------------------------------------------- rows vs the host
    host, host_ms_ = host_rows(conn, queries)
    for key, ms in host_ms_.items():
        print(f"host executor, query {key}: {ms:.1f} ms on the host clock")
    for key, rows in out.items():
        check(len(rows) == 64, f"query {key}: {len(rows)} groups")
        worst = compare_rows(key, rows, host[key], TAIL_TOL[key])
        print(f"query {key}: 64 groups equal the host's (integers, DISTINCT results, modes, arg "
              f"values, int64 sums and extremes exact), worst relative difference {worst:.3e}: "
              f"{rows[0]}")

    # ---------------------------------------------------------------- SUM(BIGINT) overflow
    # 16,384 rows of 2**49: the sum of |v| reaches 2**63, past the 2**62 rule
    conn.execute("create table ov as select x % 2 as g, 562949953421312 as v "
                 "from range(16384) r(x)")
    q_ov = "select g, sum(v) from ov group by g"
    messages = {}
    before = fs.fused_sql.launches["int_sum"]
    for tier, run in (("K2", lambda: conn.execute(q_ov)),
                      ("host", lambda: host_rows(conn, {"ov": q_ov}))):
        try:
            run()
            messages[tier] = None
        except SqlError as e:
            messages[tier] = str(e)
    k2_ov = fs.fused_sql.launches["int_sum"] - before
    check(messages["K2"] is not None and k2_ov == 1,
          f"SUM(BIGINT) overflow on the kernel tier: {messages['K2']}, {k2_ov} launches")
    check(messages["host"] is not None and messages["K2"] == messages["host"],
          f"overflow messages differ: {messages}")
    print(f"SUM(BIGINT) overflow: K2 raised the host's message {messages['host']!r}")

    # ---------------------------------------------------------------- steady time, phases
    for key, q in queries.items():
        conn.execute(q)
        times = []
        for _ in range(5):
            t = time.perf_counter()
            conn.execute(q)
            times.append((time.perf_counter() - t) * 1e3)
        med, q25, q75 = (float(v) for v in np.percentile(times, [50, 25, 75]))
        print(f"query {key} end to end: median {med:.3f} ms of 5 (quartiles {q25:.3f}-"
              f"{q75:.3f}) on the host clock ({n / med * 1e3:,.0f} rows/s); phases "
              f"{conn._last_phases}")

    # ---------------------------------------------------------------- K2 b-e vs plain, times
    mlp = {name: [(torch.as_tensor(w, device=device), torch.as_tensor(b, device=device))
                  for w, b in MODELS.get(name).mlp_plan[0]] for name in ("mt", "mk")}

    def run_mlp(name, f, softmax):
        h = f
        for i, (w, b) in enumerate(mlp[name]):
            h = torch.addmm(b, h, w)
            if i < len(mlp[name]) - 1:
                h = torch.relu(h)
        return torch.softmax(h, dim=1) if softmax else h

    def arg_chain(v, g, rows, is_min, G=64):
        """arg_min/arg_max as two scatter_reduce calls: the extreme per
        group, then the smallest row id reaching it."""
        ext = torch.full((G,), torch.inf if is_min else -torch.inf, device=v.device)
        ext = ext.scatter_reduce(0, g, v, "amin" if is_min else "amax")
        at = torch.where(v == ext[g], rows, torch.full_like(rows, 1 << 40))
        return torch.full((G,), 1 << 40, device=v.device).scatter_reduce(0, g, at, "amin")

    def library(key, xc, rm, xi):
        """One PyTorch chain of the same function (addmm, index_add_,
        scatter_reduce, bincount); timed only, the port never calls it."""
        g = xc[rm["g"]].long()
        G = 64
        if key == "I":
            f1, f2, f3 = xc[rm["f1"]], xc[rm["f2"]], xc[rm["f3"]]
            p = run_mlp("mt", xc[[rm[c] for c in ("f1", "f2", "f3", "f4")]].T, False)[:, 0]
            d = f1 - 3.0
            q = 1.0 + f3 / 1000.0
            vals = [d, d * d, p, p * p, (p > 0).float(), (q < 0).float(), (q == 0).float(),
                    torch.log2(q.abs())]
            sums = [torch.zeros(G, dtype=torch.float64, device=xc.device).index_add_(
                0, g, v.double()) for v in vals]
            band = torch.ones(G, device=xc.device).scatter_reduce(0, g, (f1 >= 0).float(), "amin")
            bor = torch.zeros(G, device=xc.device).scatter_reduce(0, g, (f2 > 9).float(), "amax")
            return sums, band, bor, torch.zeros(G, dtype=torch.int64, device=xc.device) \
                .index_add_(0, g, xi[0])
        if key == "J":
            outs = []
            for col, v_dom in (("h", 8), ("k500", 512), ("mv", 16)):
                m = torch.bincount(g * v_dom + xc[rm[col]].long(), minlength=G * v_dom)
                outs.append(m.view(G, v_dom).argmax(dim=1) if col == "mv" else (m > 0).sum())
            return outs
        if key == "K":
            rows = torch.arange(xc.shape[1], device=xc.device)
            p = run_mlp("mk", xc[[rm[f"c{k}"] for k in range(32)]].T, True)[:, 0]
            return (arg_chain(p, g, rows, False), arg_chain(xc[rm["c0"]], g, rows, True),
                    arg_chain(xc[rm["h"]], g, rows, False))
        sel = xc[rm["f1"]] > 1.0
        slot = torch.where(sel, g, torch.full_like(g, G))
        v = xi[0]
        i64 = torch.iinfo(torch.int64)
        return (torch.zeros(G + 1, dtype=torch.int64, device=xc.device).index_add_(0, slot, v),
                torch.zeros(G + 1, dtype=torch.float64, device=xc.device).index_add_(
                    0, slot, v.double().abs()),
                torch.full((G + 1,), i64.max, device=xc.device).scatter_reduce(0, slot, v, "amin"),
                torch.full((G + 1,), i64.min, device=xc.device).scatter_reduce(0, slot, v, "amax"))

    rows = []
    for (key, q), (xc, packed, _, xi) in zip(queries.items(), plans):
        plan = packed.plan
        log2_rows = [i for i, code in enumerate(plan.sums) if (fs.LOG2, 0) in code]
        other = [i for i in range(len(plan.sums)) if i not in log2_rows]
        err, err_log2 = 0.0, 0.0
        for n_valid in (n, N_RAGGED):
            got = fs.fused_sql(packed, xc, n_valid, int_xc=xi)
            want = fs.fused_sql_plain(packed, xc, n_valid, int_xc=xi)
            torch.cuda.synchronize()
            for k in ("count", "flags", "ints", "args", "dist", "mm"):
                check(torch.equal(got[k], want[k]), f"K2 {key} @ {n_valid}: {k} differ from plain")
            # every row's values are the plain version's bit for bit; only the
            # order of the f64 sums differs. CUDA's log2f and torch.log2 may
            # differ in a value's last bit: the product's log2 row to 1e-6
            torch.testing.assert_close(got["sums"][other], want["sums"][other], rtol=1e-12,
                                       atol=1e-9)
            torch.testing.assert_close(got["sums"][log2_rows], want["sums"][log2_rows],
                                       rtol=1e-6, atol=1e-9)
            torch.testing.assert_close(got["iest"], want["iest"], rtol=1e-12, atol=0)
            diff = [float((got[k] - want[k]).abs().max()) for k in ("iest",) if got[k].numel()]
            diff += [float((got["sums"][other] - want["sums"][other]).abs().max())] \
                if other else []
            err = max([err] + diff)
            rel = max([0.0] + [float(((got[k] - want[k]).abs() / want[k].abs().clamp(min=1e-300))
                                     .max()) for k in ("sums", "iest") if got[k].numel()])
            if log2_rows:
                err_log2 = max(err_log2, float((got["sums"][log2_rows]
                                                - want["sums"][log2_rows]).abs().max()))
            print(f"K2 {key} @ {n_valid} rows: counts, flags, int slots, arg words, DISTINCT "
                  f"counts, minima and maxima equal plain; sums' max abs err {err:.3e} (relative "
                  f"{rel:.3e})"
                  + (f", log2 rows {err_log2:.3e}" if log2_rows else ""))
        rm = _block_rows(conn, "wide" if key == "K" else "tail", xc)
        kern_times = device_ms(torch, lambda: fs.fused_sql(packed, xc, n, int_xc=xi))
        ms, q25, q75 = (float(v) for v in np.percentile(kern_times, [50, 25, 75]))
        plain_ms = float(np.median(device_ms(
            torch, lambda: fs.fused_sql_plain(packed, xc, n, int_xc=xi), runs=5)))
        library_ms = float(np.median(device_ms(torch, lambda: library(key, xc, rm, xi))))
        progs = plan.slot_programs + [f for p in plan.preds for f in p.features]
        used = {arg for prog in progs for op, arg in prog if op == fs.COL}
        nbytes = 4.0 * len(used) * n + 8.0 * len({r for r, _k in plan.ints}) * n
        macs = sum(w.shape[0] * w.shape[1] for m in plan.mlps for w, _ in m.params)
        instr = sum(len(prog) for prog in progs)
        b_ms, b_by = bound(float(n) * (2.0 * macs + instr), nbytes, "f32", peaks)
        name, replaces, counter = TAIL_KERNELS[key]
        rows.append({"name": f"{name} (query {key})", "route": "cuda",
                     "source": "infera_tpu_torch/csrc/fused_sql.cu", "replaces": replaces,
                     "launches": main_launches[counter], "max_abs_err": max(err, err_log2),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})
        print(f"{name} (query {key}): kernel {ms:.4f} ms (quartiles {q25:.4f}-{q75:.4f}), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"{len(used)} f32 and {len(plan.ints)} int columns read, {nbytes / 1e6:.1f} MB, "
              f"{instr} program instructions a row, {2.0 * macs * n / 1e9:.2f} G MLP "
              f"operations, {packed.smem_bytes} B of shared memory")
        sql_split(torch, key, packed, xc, n, int_xc=xi)
    return rows


def library_chain(torch, x, weights):
    """The row-major MLP as an addmm chain (ReLU between layers) in the
    weights' dtype; the logits in f32."""
    h = x
    for i, (w, b) in enumerate(weights):
        h = torch.addmm(b, h, w)
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h.float()


def library_rows(torch, x, weights):
    """K7a's function as a PyTorch chain: the addmm chain, then argmax, the
    filter and index_add_."""
    h = library_chain(torch, x, weights)
    pred = h.argmax(dim=1)
    sel = (h[:, 0] > 0).float()
    counts = torch.zeros(h.shape[1], device=h.device).index_add_(0, pred, sel)
    sums = torch.zeros(h.shape[1], device=h.device).index_add_(0, pred, h[:, 0] * sel)
    return counts, sums


def bench_phase(torch, itt, params, x_rows, x_dev, peaks, device, f32_predict_ms) -> tuple:
    """The bench form's K7a and K7b and the engine's int8 policy; returns
    their rows of the kernels line and the launches of K1 and K3 that the
    bench's other impls made."""
    from infera_tpu_torch.bench import bench_cuda
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.onnx.executor import compile_model_file
    from infera_tpu_torch.ops.fused_query import (
        fused_mlp_query,
        fused_mlp_query_columnar,
        fused_mlp_query_columnar_int8,
        fused_mlp_query_columnar_int8_plain,
        fused_mlp_query_columnar_int8_shift,
        fused_mlp_query_plain,
        params_from_numpy,
        qparams_static_from_numpy,
        quantize_mlp_static,
    )
    from infera_tpu_torch.registry import MODELS

    n = N_MAIN
    xc = x_dev.T.contiguous()
    x_cal = np.random.default_rng(7).standard_normal((1 << 14, 32)).astype(np.float32)
    qparams, s0 = quantize_mlp_static(params, x_cal)
    xq = torch.clamp(torch.round(xc / float(s0)), -127, 127).to(torch.int8)
    w_f32 = params_from_numpy(params, device, torch.float32)
    w_bf16 = params_from_numpy(params, device, torch.bfloat16)
    w_s = qparams_static_from_numpy(qparams, device)
    x_bf16 = x_dev.to(torch.bfloat16)

    # ---------------------------------------------------------------- the main path
    counters = {"K7a-f32": lambda: fused_mlp_query.launches["f32"],
                "K7a-bf16": lambda: fused_mlp_query.launches["bf16"],
                "K7b": lambda: fused_mlp_query_columnar_int8.launches,
                "K1-f32": lambda: fused_mlp_query_columnar.launches["f32"],
                "K1-bf16": lambda: fused_mlp_query_columnar.launches["bf16"],
                "K3": lambda: fused_mlp_query_columnar_int8_shift.launches}
    fused_mlp_query.launches = {"f32": 0, "bf16": 0}
    fused_mlp_query_columnar_int8.launches = 0
    fused_mlp_query_columnar.launches = {"f32": 0, "bf16": 0}
    fused_mlp_query_columnar_int8_shift.launches = 0
    t0 = time.perf_counter()
    best = bench_cuda(params, n, iters=20)
    torch.cuda.synchronize()
    launches = {k: read() for k, read in counters.items()}
    print(f"bench impls @ {n} rows, ms per call: "
          + ", ".join(f"{k} {v:.4f}" for k, v in best["ms_by_impl"].items())
          + f"; fastest {best['impl']}")
    check(len(best["ms_by_impl"]) == 8, f"bench ran {list(best['ms_by_impl'])}")

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/mlp.onnx"
        proto.save_model_file(
            builder.mlp_model(in_dim=32, hidden=(128, 128), out_dim=16, softmax=True), path)
        itt.load_model("mlp_int8", path, "int8")
        cpu_model = compile_model_file(path, "mlp_int8_cpu", "int8", torch.device("cpu"))
    pred8 = itt.predict("mlp_int8", x_rows)
    torch.cuda.synchronize()
    print(f"bench-form main path: {time.perf_counter() - t0:.2f} s on the host clock; "
          f"launches {launches}")
    for k, c in launches.items():
        check(c > 0, f"kernel {k} was not launched on the main path")
    model8 = MODELS.get("mlp_int8")
    check(len(model8._int8_fused_cache) == 1, "int8 predict did not run the fused int8 chain")
    got8 = pred8.data.reshape(n, 16)
    check(np.isfinite(got8).all() and pred8.cols == 16, "int8 predict: shape or values")
    ref32 = itt.predict("mlp", x_rows).data.reshape(n, 16)
    rel = float(np.abs(got8 - ref32).mean() / np.abs(ref32).mean())
    # tests/test_quantization.py's bound for int8 against f32
    check(rel < 0.08, f"int8 predict: mean abs error {rel:.4f} of the f32 output's mean")
    # the same chain on the CPU, on the card's calibrated scales
    cpu_model._int8_calibrated = True
    for nd_cpu, nd in zip(cpu_model.mlp_plan[2], model8.mlp_plan[2], strict=True):
        nd_cpu._infera_act_scale = nd._infera_act_scale
    want8 = cpu_model.run(x_rows)[0].numpy()
    check(len(cpu_model._int8_fused_cache) == 1, "the CPU model did not run the fused chain")
    np.testing.assert_allclose(got8, want8, rtol=1e-5, atol=1e-5)
    err8 = float(np.abs(got8 - want8).max())
    print(f"engine int8 predict @ {n} rows: fused int8 chain, mean abs error {rel:.4f} of "
          f"the f32 output's mean, max abs diff {err8:.3e} against the chain on the CPU; "
          f"scales {[nd._infera_act_scale for nd in model8.mlp_plan[2]]}")

    # ---------------------------------------------------------------- kernels vs plain
    def compare(key, got, want, n_rows):
        gc, gs = (t.cpu().numpy() for t in got)
        wc, ws = (t.cpu().numpy() for t in want)
        diff = int(np.abs(gc - wc).sum())
        kept = int(wc.sum())
        if key == "K7a-f32":
            # f32 sums in another order can flip an argmax near a tie or the
            # sign of score0 near 0: a few rows of a million
            check(diff <= 4, f"{key} @ {n_rows}: counts differ by {diff} rows")
            np.testing.assert_allclose(gs, ws, rtol=1e-4)
        elif key.startswith("K7a-bf16"):
            # the bf16 rounding of a ReLU output can go the other way when
            # the f32 sum before it differs in its last bit
            check(diff <= 1e-3 * kept, f"{key} @ {n_rows}: counts differ by {diff} of {kept}")
            np.testing.assert_allclose(gs, ws, rtol=2e-2, atol=1e-2)
        else:
            # integer layers are exact, the epilogues are the same two
            # roundings on both sides; only the f64 sum order differs
            check(diff == 0, f"{key} @ {n_rows}: counts differ by {diff} rows")
            np.testing.assert_allclose(gs, ws, rtol=1e-5)
        err = float(np.abs(gs - ws).max())
        print(f"{key} @ {n_rows} rows: kept {kept}, count diff {diff}, max abs sum err {err:.3e}")
        return err

    cases = {
        "K7a-f32": (w_f32, x_dev, fused_mlp_query, fused_mlp_query_plain),
        "K7a-bf16": (w_bf16, x_bf16, fused_mlp_query, fused_mlp_query_plain),
        "K7a-bf16 (f32 table)": (w_bf16, x_dev, fused_mlp_query, fused_mlp_query_plain),
        "K7b": (w_s, xq, fused_mlp_query_columnar_int8, fused_mlp_query_columnar_int8_plain),
    }
    max_err = {}
    for key, (w, table, kern, plain) in cases.items():
        rag = table[:N_RAGGED] if table.dtype != torch.int8 else table[:, :N_RAGGED].contiguous()
        errs = []
        for t, n_rows in ((table, n), (rag, N_RAGGED)):
            got = kern(w, t)
            errs.append(compare(key, got, plain(w, t), n_rows))
            if key == "K7b":
                emu = emulate_int8_static(qparams, t.cpu().numpy())
                d = int(np.abs(got[0].cpu().numpy() - emu).sum())
                check(d == 0, f"K7b @ {n_rows}: counts differ from the emulation by {d}")
                print(f"K7b @ {n_rows} rows: counts equal the numpy integer emulation")
        max_err[key.split(" ")[0]] = max(max_err.get(key.split(" ")[0], 0.0), *errs)
    # bf16 mode rounds an f32 table at load exactly as the bf16 table holds it
    for a, b in zip(fused_mlp_query(w_bf16, x_dev), fused_mlp_query(w_bf16, x_bf16)):
        check(torch.equal(a, b), "K7a bf16: an f32 table and its bf16 copy disagree")

    # ---------------------------------------------------------------- times
    tw = [(torch.as_tensor(w, device=device), torch.as_tensor(b, device=device))
          for w, b in params]
    tw_bf16 = [(w.to(torch.bfloat16), b.to(torch.bfloat16)) for w, b in tw]

    # K7b's yardstick: cuBLASLt int8 products (torch._int_mm needs more than
    # 16 rows in its first operand, so the last layer's weights are padded
    # to 32 rows) with the f32 epilogues as torch ops
    lq = []
    for i, (wq, comb, bq) in enumerate(w_s.layers):
        if i == len(w_s.layers) - 1:
            wq = torch.nn.functional.pad(wq, (0, 0, 0, 32 - wq.shape[0]))
        lq.append((wq.contiguous(), comb, bq))

    def library_int8(q):
        for i, (wq, comb, bq) in enumerate(lq):
            y = torch._int_mm(wq, q)[: comb.shape[0]].float()
            t = y * comb + bq
            if i < len(lq) - 1:
                q = torch.clamp(torch.round(t), 0, 127).to(torch.int8)
        pred = t.argmax(dim=0)
        sel = (t[0] > 0).float()
        counts = torch.zeros(t.shape[0], device=t.device).index_add_(0, pred, sel)
        sums = torch.zeros(t.shape[0], device=t.device).index_add_(0, pred, t[0] * sel)
        return counts, sums

    macs = sum(w.shape[0] * w.shape[1] for w, _ in params)
    ops = 2.0 * n * macs
    timed = {
        "K7a-f32": ("f32", n * 32 * 4, lambda: fused_mlp_query(w_f32, x_dev),
                    lambda: fused_mlp_query_plain(w_f32, x_dev),
                    lambda: library_rows(torch, x_dev, tw)),
        "K7a-bf16": ("bf16", n * 32 * 2, lambda: fused_mlp_query(w_bf16, x_bf16),
                     lambda: fused_mlp_query_plain(w_bf16, x_bf16),
                     lambda: library_rows(torch, x_bf16, tw_bf16)),
        "K7b": ("int8", n * 32, lambda: fused_mlp_query_columnar_int8(w_s, xq),
                lambda: fused_mlp_query_columnar_int8_plain(w_s, xq), lambda: library_int8(xq)),
    }
    meta = {
        "K7a-f32": ("fused_mlp_query (f32)", "infera_tpu/ops/pallas_query.py:33"),
        "K7a-bf16": ("fused_mlp_query (bf16)", "infera_tpu/ops/pallas_query.py:33"),
        "K7b": ("fused_mlp_query_columnar_int8", "infera_tpu/ops/pallas_query.py:223"),
    }
    rows = []
    for key, (op_type, nbytes, kern, plain, lib) in timed.items():
        kern_times = device_ms(torch, kern)
        ms, q25, q75 = (float(v) for v in np.percentile(kern_times, [50, 25, 75]))
        plain_ms = float(np.median(device_ms(torch, plain)))
        library_ms = float(np.median(device_ms(torch, lib)))
        b_ms, b_by = bound(ops, nbytes, op_type, peaks)
        kname, replaces = meta[key]
        rows.append({"name": f"{key} {kname}", "route": "cuda",
                     "source": "infera_tpu_torch/csrc/fused_query.cu", "replaces": replaces,
                     "launches": launches[key], "max_abs_err": max_err[key], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})
        print(f"{key}: kernel {ms:.4f} ms (quartiles {q25:.4f}-{q75:.4f}), plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    int8_ms = host_ms(torch, lambda: itt.predict("mlp_int8", x_rows))
    print(f"engine predict @ {n} rows on the host clock: int8 {int8_ms:.3f} ms "
          f"({n / int8_ms * 1e3:,.0f} rows/s), f32 {f32_predict_ms:.3f} ms")
    return rows, {k: launches[k] for k in ("K1-f32", "K1-bf16", "K3")}


# ---------------------------------------------------------------- the torch program (P4a)
# The program tier between K2 and the host (``sql/device_plan.py``,
# ``_exec_path == "device_plan"``): queries K2 declines, over sql_phase's
# ``big`` table and ``t``. O's WHERE leaves every group a tie (without it the
# 16,384 rows of a group split 5,462 / 5,461 / 5,461 and K2 takes the MODE).
DP_T = ("create table t as select x % 64 as g, x % 4096 as k, x % 6 as m, (x * 13) % 101 as iv, "
        "((x * 13) % 1000003)::float as hv, (x % 40)::float / 4.0 - 3.0 as v "
        "from range({n}) r(x)")
DP_SORT = ("create table f6 as select (x * 1000003) % 7 + 1152921504606846976 as k, x "
           "from range({n}) r(x)",
           "create table r13 as select x, case when x % 3 = 0 then 1e300 * (x % 7 + 1) "
           "else x::double end as v from range({n}) r(x)")
DP_QUERIES = {
    "M": ("select g, median(f1), quantile_cont(f2, 0.75), quantile_disc(f3, 0.25) from big "
          "where f4 > 1.0 group by g order by g"),
    "N": ("select g, approx_count_distinct(hv), approx_count_distinct(iv) from t group by g "
          "order by g"),
    "O": "select g, mode(m) from t where k < 4032 group by g order by g",
    "P": SQL_A.replace("'m'", "'m8'"),
    "Q": SQL_A,
    "R": "select k, count(*), sum(v), min(v) from t group by k order by k",
}
DP_S = {"S-F6": "select k, x from f6 order by k desc limit 3",
        "S-R13": "select x, v from r13 order by v desc limit 8"}
# per column None (exact) or the relative tolerance: M the f32 block's
# values (tests/test_device_plan.py's 1e-6); N, O, R keys, counts, HLL
# estimates, modes, quarter sums and minima exact; P the int8 graph on the
# card against the same program on the CPU; Q A's (the program against K2)
DP_TOL = {"M": (None, 1e-6, 1e-6, 1e-6), "N": (None, None, None), "O": (None, None),
          "P": (None, None, 1e-4, 1e-12), "Q": SQL_TOL["A"], "R": (None, None, None, None)}


def device_plan_expected_sorts(n: int) -> dict:
    """S's rows in DuckDB's order (numpy's stable sort of the exact keys)."""
    x = np.arange(n)
    k = (x * 1000003) % 7 + (1 << 60)
    v = np.where(x % 3 == 0, 1e300 * (x % 7 + 1), x.astype(np.float64))
    top_k = np.argsort(-k, kind="stable")[:3]
    top_v = np.argsort(-v, kind="stable")[:8]
    return {"S-F6": [(int(k[i]), int(i)) for i in top_k],
            "S-R13": [(int(i), float(v[i])) for i in top_v]}


def device_plan_phase(torch, itt, device) -> None:
    """Queries M–S through ``Connection.execute`` on the card: each on the
    torch program (``device_plan``; S's ORDER BY in the host executor with
    its sort on the card), rows held to the host executor's (P to the same
    program on the CPU, Q to K2's rows), end-to-end times and phases, the
    host's time once, and for M the device's idle share in a traced window.
    The program launches no kernel of the port: the kernels line gains no
    row."""
    with tempfile.TemporaryDirectory() as d:
        _device_plan_queries(torch, itt, device, d)


def _device_plan_queries(torch, itt, device, d) -> None:
    import os

    from infera_tpu_torch import observability as obs
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.ops import fused_sql as fs
    from infera_tpu_torch.ops import sort as sort_mod
    from infera_tpu_torch.sql import Connection
    from infera_tpu_torch.testing import profile_query as pq

    n = N_MAIN
    t0 = time.perf_counter()
    os.environ.pop("INFERA_PALLAS_SQL", None)
    conn = Connection()
    conn.execute(BIG_TABLE.format(n=n))
    conn.execute(DP_T.format(n=n))
    for sql in DP_SORT:
        conn.execute(sql.format(n=n))
    proto.save_model_file(builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1), f"{d}/m.onnx")
    itt.load_model("m", f"{d}/m.onnx")
    itt.load_model("m8", f"{d}/m.onnx", "int8")
    print(f"device-plan tables and models: {time.perf_counter() - t0:.2f} s on the host clock")

    def run(key, q, path="device_plan"):
        mode = "0" if key == "Q" else None
        if mode:
            os.environ["INFERA_PALLAS_SQL"] = mode
        try:
            rows = conn.execute(q).rows
            torch.cuda.synchronize()
        finally:
            os.environ.pop("INFERA_PALLAS_SQL", None)
        check(conn._exec_path == path, f"query {key} ran on {conn._exec_path}")
        return rows

    # ---------------------------------------------------------------- M–R on the program
    k2_before = sum(fs.fused_sql.launches.values())
    out = {key: run(key, q) for key, q in DP_QUERIES.items()}
    print(f"device-plan queries M-R: path device_plan each; K2 launches meanwhile "
          f"{sum(fs.fused_sql.launches.values()) - k2_before} (the group-key and domain "
          f"probes where K2 takes them)")
    # P on the CPU before the card's int8 model calibrates (the host's
    # predict would): the same uncalibrated graph policy on both
    itt.set_device("cpu")
    try:
        itt.load_model("m8", f"{d}/m.onnx", "int8")
        cpu = Connection(conn.catalog)
        p_cpu = cpu.execute(DP_QUERIES["P"]).rows
        check(cpu._exec_path == "device_plan", f"query P on the CPU ran on {cpu._exec_path}")
    finally:
        itt.set_device(device)
        itt.load_model("m8", f"{d}/m.onnx", "int8")
    worst = compare_rows("P", out["P"], p_cpu, DP_TOL["P"])
    print(f"query P (int8 model; K2 declines int8): 64 groups equal the same program on the "
          f"CPU, worst relative difference {worst:.3e}")
    # A's model ends in a softmax over one class (1.0 on every row): the same
    # query over the MLP without it shows the int8 policy's values
    proto.save_model_file(builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1, softmax=False),
                          f"{d}/mr.onnx")
    q_raw = DP_QUERIES["P"].replace("'m8'", "'m8r'")
    raw = {}
    for dev in (torch.device("cpu"), device):
        itt.set_device(dev)
        itt.load_model("m8r", f"{d}/mr.onnx", "int8")
        raw[dev.type] = Connection(conn.catalog).execute(q_raw).rows
    worst = compare_rows("P", raw["cuda" if device.type == "cuda" else "cpu"], raw["cpu"],
                         DP_TOL["P"])
    print(f"query P over the MLP without its softmax (int8): the card's 64 groups equal the "
          f"CPU's, worst relative difference {worst:.3e}: {raw['cpu'][0]}")
    k2_rows = run("A", SQL_A, "device_plan_cuda")
    worst = compare_rows("Q", out["Q"], k2_rows, DP_TOL["Q"])
    print(f"query Q (A with INFERA_PALLAS_SQL=0): the program's 64 groups equal K2's, worst "
          f"relative difference {worst:.3e}")

    # ---------------------------------------------------------------- S: the device sort
    calls = {"n": 0}
    argsort = sort_mod.argsort_device

    def counted(*a, **k):
        calls["n"] += 1
        return argsort(*a, **k)

    sort_mod.argsort_device = counted
    try:
        s_out = {key: run(key, q, "host") for key, q in DP_S.items()}
    finally:
        sort_mod.argsort_device = argsort
    check(calls["n"] == len(DP_S), f"the device sort ran {calls['n']} times")
    want = device_plan_expected_sorts(n)
    for key, rows in s_out.items():
        check(rows == want[key], f"query {key}: {rows} vs {want[key]}")
        print(f"query {key}: ORDER BY on the card (argsort_device), rows in DuckDB's order: "
              f"{rows[:3]}")

    # ---------------------------------------------------------------- times, then the host
    # end to end as the other phases time it: Connection.execute, without
    # rendering the rows to Python (R's 4,096 rows take ~25 ms to render);
    # A on K2 beside Q, the same plan on the program
    for key, q in {**DP_QUERIES, "A": SQL_A, **DP_S}.items():
        path = "host" if key in DP_S else "device_plan_cuda" if key == "A" else "device_plan"
        run(key, q, path)
        times = []
        for _ in range(5):
            if key == "Q":
                os.environ["INFERA_PALLAS_SQL"] = "0"
            t = time.perf_counter()
            conn.execute(q)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            os.environ.pop("INFERA_PALLAS_SQL", None)
            check(conn._exec_path == path, f"query {key} ran on {conn._exec_path}")
        print(f"query {key} end to end: median {float(np.median(times)):.3f} ms of 5 on the "
              f"host clock ({n / np.median(times) * 1e3:,.0f} rows/s), path {path}; phases "
              f"{conn._last_phases}")
    host, host_ms_ = host_rows(conn, DP_QUERIES)
    for key, rows in out.items():
        ms = host_ms_[key]
        if key == "P":   # the host's calibrated fused int8 chain against the graph's policy
            rel = max(abs(a[2] - b[2]) / abs(b[2]) for a, b in zip(rows, host[key]))
            print(f"query P: the host executor ({ms:.1f} ms on the host clock) runs the "
                  f"calibrated fused int8 chain, the program the graph's dynamic int8 policy "
                  f"(by design): averages differ by up to {rel:.3e} relative")
            continue
        worst = compare_rows(key, rows, host[key], DP_TOL[key])
        print(f"query {key}: path device_plan, {len(rows)} rows equal the host executor's "
              f"({ms:.1f} ms on the host clock), worst relative difference {worst:.3e}: "
              f"{rows[0]}")

    # ---------------------------------------------------------------- M's trace window
    with tempfile.TemporaryDirectory() as td:
        with obs.trace(f"{td}/query_m") as prof:
            for _ in range(5):
                with obs.annotate("query M"):
                    conn.execute(DP_QUERIES["M"])
            torch.cuda.synchronize()
        trace_report(pq, "query M (5 steady executions)", prof, f"{td}/query_m", {"query M": 5})


def trace_report(pq, name, prof, log_dir, spans):
    """Print a trace window's five longest device operations and the
    device's idle share, and check the trace file and its annotate spans.
    Returns the top operations, or None when the trace holds no CUDA
    activity."""
    import glob

    files = glob.glob(f"{log_dir}/*.pt.trace.json")
    check(len(files) == 1, f"trace {name}: {len(files)} trace files in {log_dir}")
    summary = pq.trace_device_summary(files[0])
    for span, count in spans.items():
        check(summary["spans"].get(span, 0) == count,
              f"trace {name}: spans {summary['spans']}, {count} '{span}' annotated")
    top = pq.top_device_ops(prof)
    if summary["device_events"] == 0 and not top:
        print(f"trace {name}: the trace holds no CUDA activity (torch.profiler recorded no "
              f"device event); window {summary['window_us'] / 1e3:.3f} ms, spans "
              f"{summary['spans']}")
        return None
    print(f"trace {name}: window {summary['window_us'] / 1e3:.3f} ms, device busy "
          f"{summary['device_busy_us'] / 1e3:.3f} ms ({summary['device_events']} device "
          f"events), idle share {summary['idle_share']:.4f}; spans {summary['spans']}")
    for op, calls, ms in top:
        print(f"  {ms:10.4f} ms  {calls:5d} calls  {op[:110]}")
    return top


def profile_phase(torch, itt, x_dev, peaks, device) -> list:
    """The profiling path: the seven experiments of
    ``infera_tpu_torch.testing.profile_query`` with K8a's and K8b's launch
    counts set to 0 just before and read just after; K8a and K8b against
    their plain versions and K8b full against K7a bf16; two traces; returns
    the K8 rows of the kernels line."""
    from infera_tpu_torch import observability as obs
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.ops import fused_query as fq
    from infera_tpu_torch.ops.fused_query import fused_mlp_query, mlp_scores_plain
    from infera_tpu_torch.sql import Connection
    from infera_tpu_torch.testing import profile_query as pq

    n = N_MAIN
    # ---------------------------------------------------------------- the main path
    pq.empty_grid_scan.launches = 0
    pq.query_stage.launches = dict.fromkeys(pq.VARIANTS, 0)
    t0 = time.perf_counter()
    lines = {name: exp(device=device) for name, exp in pq.EXPS.items()}
    torch.cuda.synchronize()
    launches = {"K8a": pq.empty_grid_scan.launches,
                **{f"K8b {v}": c for v, c in pq.query_stage.launches.items()}}
    print(f"profiling experiments: {time.perf_counter() - t0:.2f} s on the host clock; "
          f"launches {launches}")
    for k, c in launches.items():
        check(c > 0, f"kernel {k} was not launched on the main path")
    calib = lines["variants"][0]
    check(calib["ms_per_iter"] >= 0.9 * calib["expected_ms_floor"],
          f"timer check: a {pq.CALIB_N}^2 bf16 matmul read {calib['ms_per_iter']:.4f} ms, under "
          f"0.9 x the card's floor {calib['expected_ms_floor']:.4f} ms: the timer is wrong")
    for name in ("iters", "rows", "empty", "variants"):
        check(all("error" not in line for line in lines[name]), f"experiment {name}: {lines[name]}")

    # ---------------------------------------------------------------- kernels vs plain
    sw = pq.stage_weights(pq._params(), device)
    x_bf16 = x_dev.to(torch.bfloat16)
    max_err = dict.fromkeys(["K8a", *pq.VARIANTS], 0.0)
    for n_rows in (n, N_RAGGED):
        x = x_bf16[:n_rows]
        got = pq.empty_grid_scan(x)
        want = pq.empty_grid_scan_plain(x)
        # tile sums in f32 on both sides, in another order
        scale = x.float().abs().sum(0)
        err = (got - want).abs()
        check(bool((err <= 1e-6 * scale).all()), f"K8a @ {n_rows}: {float(err.max()):.3e}")
        max_err["K8a"] = max(max_err["K8a"], float(err.max()))
        outs = {v: pq.query_stage(sw, x, v) for v in pq.VARIANTS}
        check(torch.equal(outs["scan"][:32], got) and not bool(outs["scan"][32:].any()),
              f"K8a and K8b scan differ @ {n_rows}")
        for v in pq.VARIANTS:
            g, p = outs[v], pq.query_stage_plain(sw, x, v)
            if v in ("scan", "mm1", "mm_all"):
                # the layers' f32 sums in another order (the plain version's
                # matmul), then the tiles' sums in another order
                if v == "scan":
                    c, tol = 32, 1e-6 * scale
                else:
                    h = mlp_scores_plain(sw.first if v == "mm1" else sw.full, x.T)
                    c, tol = h.shape[0], 1e-4 * h.abs().double().sum(1).float()
                e = (g[:c] - p[:c]).abs()
                check(bool((e <= tol).all()) and not bool(g[c:].any()),
                      f"K8b {v} @ {n_rows}: {float(e.max()):.3e}")
            else:
                # K7a bf16's bounds: the tensor core accumulates in its own
                # order, so a bf16 rounding of a ReLU output can go the
                # other way
                diff, kept = float((g[:16] - p[:16]).abs().sum()), float(p[:16].sum())
                check(diff <= 1e-3 * kept,
                      f"K8b {v} @ {n_rows}: counts {g[:16].tolist()} vs plain {p[:16].tolist()}")
                torch.testing.assert_close(g[16:32], p[16:32], rtol=2e-2, atol=1e-2)
                e = (g - p).abs()
            max_err[v] = max(max_err[v], float(e.max()))
        counts7, sums7 = fused_mlp_query(sw.full, x)
        full = outs["full"]
        check(torch.equal(full[:16].long(), counts7),
              f"K8b full @ {n_rows}: counts {full[:16].tolist()} vs K7a bf16 {counts7.tolist()}")
        check(torch.equal(full[16:32], sums7), f"K8b full @ {n_rows}: sums differ from K7a's")
        print(f"K8a, K8b @ {n_rows} rows: within plain's bounds (max abs err K8a "
              f"{max_err['K8a']:.3e}, mm1 {max_err['mm1']:.3e}, mm_all {max_err['mm_all']:.3e}, "
              f"tail_nomax {max_err['tail_nomax']:.3e}, full {max_err['full']:.3e}); K8a == "
              f"scan; full's counts and sums bit-equal to K7a bf16's")

    # ---------------------------------------------------------------- two traces
    conn = Connection()
    conn.execute("create table big as select x % 64 as g, x % 5 as h, "
                 "(x % 100)::float / 10.0 as f1, "
                 "((x + 3) % 50)::float / 5.0 as f2, ((x * 7) % 30)::float / 3.0 as f3, "
                 f"((x * 11) % 90)::float / 9.0 as f4 from range({n}) r(x)")
    with tempfile.TemporaryDirectory() as d:
        proto.save_model_file(builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1), f"{d}/m.onnx")
        itt.load_model("m", f"{d}/m.onnx")
        conn.execute(SQL_A)
        torch.cuda.synchronize()
        check(conn._exec_path == "device_plan_cuda", f"query A ran on {conn._exec_path}")
        with obs.trace(f"{d}/query_a") as prof:
            for _ in range(5):
                with obs.annotate("query A"):
                    conn.execute(SQL_A)
            torch.cuda.synchronize()
        trace_report(pq, "query A (5 steady executions)", prof, f"{d}/query_a", {"query A": 5})
        fused_mlp_query(sw.full, x_bf16)
        torch.cuda.synchronize()
        # torch.profiler (CUPTI) now and then drops a few kernel records from a
        # window: a window that recorded fewer launches than were made is
        # traced again, at most three windows in all
        for window in range(3):
            with obs.trace(f"{d}/k7a{window}") as prof:
                for _ in range(20):
                    fused_mlp_query(sw.full, x_bf16)
                torch.cuda.synchronize()
            top = trace_report(pq, "K7a bf16 (20 calls)", prof, f"{d}/k7a{window}", {})
            if top is None or "query_bf16_kernel" not in top[0][0] or top[0][1] == 20:
                break
            print(f"trace K7a bf16: the profiler recorded {top[0][1]} of 20 launches")
        if top is not None:
            check("query_bf16_kernel" in top[0][0] and top[0][1] == 20,
                  f"trace K7a bf16: the longest device operation is {top[0]}")

    # ---------------------------------------------------------------- times
    params = pq._params()
    tw = [(torch.as_tensor(w, device=device).to(torch.bfloat16),
           torch.as_tensor(b, device=device).to(torch.bfloat16)) for w, b in params]
    macs = sum(w.shape[0] * w.shape[1] for w, _ in params)

    def library(v):
        """One PyTorch chain of the stage; timed only, the port never calls it."""
        if v == "scan":
            return torch.sum(x_bf16, 0, dtype=torch.float32)
        h = library_chain(torch, x_bf16, tw[:1] if v == "mm1" else tw)
        if v in ("mm1", "mm_all"):
            return h.sum(0)
        if v == "full":
            return library_rows(torch, x_bf16, tw)
        hit = (h == h.amax(1, keepdim=True)) & (h[:, :1] > 0)
        return hit.sum(0), (hit * h[:, :1]).sum(0)

    timed = {"K8a": ("scan", lambda: pq.empty_grid_scan(x_bf16),
                     lambda: pq.empty_grid_scan_plain(x_bf16))}
    for v in pq.VARIANTS:
        timed[v] = (v, lambda v=v: pq.query_stage(sw, x_bf16, v),
                    lambda v=v: pq.query_stage_plain(sw, x_bf16, v))
    rows, stage_ms = [], {}
    for key, (stage, kern, plain) in timed.items():
        kern_times = device_ms(torch, kern)
        ms, q25, q75 = (float(v) for v in np.percentile(kern_times, [50, 25, 75]))
        plain_ms = float(np.median(device_ms(torch, plain)))
        library_ms = float(np.median(device_ms(torch, lambda: library(stage))))
        # a row: one f32 add a value (scan), two bf16 operations a multiply-add
        ops = {"scan": 32, "mm1": 2 * 32 * 128}.get(stage, 2 * macs)
        b_ms, b_by = bound(float(n) * ops, n * 32 * 2, "f32" if stage == "scan" else "bf16",
                           peaks)
        if key == "K8a":
            name, replaces = "K8a empty_grid_scan", "infera_tpu/testing/profile_query.py:118"
            n_launch = launches["K8a"]
        else:
            name, replaces = f"K8b query_stage ({key})", "infera_tpu/testing/profile_query.py:222"
            n_launch = launches[f"K8b {key}"]
            stage_ms[key] = ms
        rows.append({"name": name, "route": "cuda",
                     "source": "infera_tpu_torch/csrc/profile_query.cu", "replaces": replaces,
                     "launches": n_launch, "max_abs_err": max_err[key], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})
        print(f"{name}: kernel {ms:.4f} ms (quartiles {q25:.4f}-{q75:.4f}), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if key == "K8a":
            stages = pq.ring_stages((32,))
            tile = 64 * 32 * 2
            smem = pq._stage_smem_bytes((32,))
            print(f"K8a ring: {stages} buffers of {64 * fq.ring_stride(32, 2)} B, "
                  f"{(stages - 1) * tile} B of the table in flight a block ahead of the tile "
                  f"it copies, {pq._k7a_blocks(x_bf16, pq.PROFILE_DIMS)} blocks (K7a bf16's "
                  f"grid; its ring {fq.ring_stages_bf16(pq.PROFILE_DIMS, 2)} buffers); "
                  f"{pq.stage_resident_blocks(device, smem)} stage kernels resident a SM at "
                  f"{smem} B")
    k7a_ms = float(np.median(device_ms(torch, lambda: fused_mlp_query(sw.full, x_bf16))))
    # each stage adds one part of K7a to the one before; the tail without
    # argmax is another tail on the same layers
    steps = [("scan", "load"), ("mm1", "layer 1"), ("mm_all", "layers 2-3"),
             ("full", "argmax tail"), ("tail_nomax", "max-compare tail")]
    prev = {"scan": None, "mm1": "scan", "mm_all": "mm1", "full": "mm_all",
            "tail_nomax": "mm_all"}
    print(f"K7a bf16 @ {n} rows: {k7a_ms:.4f} ms in this phase; by stage: " + ", ".join(
        f"{part} {stage_ms[v] - (stage_ms[prev[v]] if prev[v] else 0.0):.4f}"
        for v, part in steps) + " ms")
    return rows


ONNX_F32 = 1e-5                                # of max|y|: the repo's parity bound
ONNX_BOUNDS = {"f32": (ONNX_F32, ONNX_F32),      # (worst, mean) of max|y|
               "bf16": (1e-2, 5e-4), "int8": (2e-2, 1e-3)}
N_ENCODER = 32_768


def onnx_close(key, got, want, precision="f32") -> float:
    """Hold a card output to the CPU's: the f32 bound, or under bf16 and
    int8 the bounds of a rounding that goes the other way (a one-ulp
    difference in an f32 activation moves a value across a bf16 or int8
    boundary; each flip moves an output by one step of its operand)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    check(got.shape == want.shape, f"{key}: shape {got.shape} vs the CPU's {want.shape}")
    check(bool(np.all(np.isfinite(got))), f"{key}: non-finite outputs")
    scale = max(float(np.abs(want).max()), 1e-30)
    err = np.abs(got - want)
    worst, mean = ONNX_BOUNDS[precision]
    check(float(err.max()) <= worst * scale and float(err.mean()) <= mean * scale,
          f"{key}: max err {float(err.max()) / scale:.3e}, mean {float(err.mean()) / scale:.3e} "
          f"of max|y| against the CPU")
    return float(err.max()) / scale


def onnx_phase(torch, itt, device) -> None:
    """The ONNX engine on the card: the MobileNetV3-Small stand-in, the
    transformer encoder and the control-flow graphs through the entry points
    a user calls, each held against the same port on the CPU. No kernel of
    the port runs here (K6's count must not move)."""
    from infera_tpu_torch import observability as obs
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.onnx.executor import compile_model_bytes
    from infera_tpu_torch.ops.fused_mlp import fused_mlp
    from infera_tpu_torch.sql import Connection
    from infera_tpu_torch.testing import profile_query as pq

    t_phase = time.perf_counter()
    check(torch.backends.cudnn.allow_tf32 is False and
          torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on")
    k6_before = fused_mlp.launches
    rng = np.random.default_rng(15)
    with tempfile.TemporaryDirectory() as d:
        # ------------------------------------------------ MobileNetV3-Small
        mnv3 = builder.mobilenet_like_model()
        proto.save_model_file(mnv3, f"{d}/mnv3.onnx")
        itt.load_model("mnv3", f"{d}/mnv3.onnx")
        image = rng.standard_normal(3 * 224 * 224).astype("<f4")
        batch = rng.standard_normal((64, 3 * 224 * 224)).astype(np.float32)
        blob = image.tobytes()
        check(len(blob) == 602_112, "the stand-in's blob is 602,112 bytes")
        one = itt.predict_from_blob("mnv3", blob)
        zero = itt.predict_from_blob("mnv3", bytes(602_112))
        many = itt.predict("mnv3", batch)
        check((one.rows, one.cols, many.rows, many.cols) == (1, 1000, 64, 1000),
              f"MobileNet shapes {one.rows}x{one.cols}, {many.rows}x{many.cols}")
        cpu = compile_model_bytes(mnv3.serialize(), "mnv3-cpu", device="cpu")
        errs = [onnx_close("MobileNet b1", one.data.reshape(1, 1000),
                           cpu.run(image.reshape(1, 3, 224, 224))[0]),
                onnx_close("MobileNet zeros", zero.data.reshape(1, 1000),
                           cpu.run(np.zeros((1, 3, 224, 224), np.float32))[0]),
                onnx_close("MobileNet b64", many.data.reshape(64, 1000),
                           cpu.run(batch.reshape(64, 3, 224, 224))[0])]
        b1_ms = host_ms(torch, lambda: itt.predict_from_blob("mnv3", blob), runs=20)
        b64_ms = host_ms(torch, lambda: itt.predict("mnv3", batch), runs=5)
        print(f"ONNX MobileNet stand-in: batch 1 {b1_ms:.3f} ms a call on the host clock "
              f"(predict_from_blob, median of 20), batch 64 {b64_ms:.3f} ms = "
              f"{64 / b64_ms * 1e3:,.1f} images/s; max err against the CPU (of max|y|) "
              f"b1 {errs[0]:.3e}, zeros {errs[1]:.3e}, b64 {errs[2]:.3e}")
        with obs.trace(f"{d}/mnv3_trace") as prof:
            for _ in range(5):
                with obs.annotate("mobilenet b1"):
                    itt.predict_from_blob("mnv3", blob)
            torch.cuda.synchronize()
        trace_report(pq, "MobileNet batch 1 (5 calls)", prof, f"{d}/mnv3_trace",
                     {"mobilenet b1": 5})

        # ------------------------------------------------ transformer encoder
        enc = builder.transformer_encoder_model()  # seq 16, d_model 64, 4 heads, 2 layers
        proto.save_model_file(enc, f"{d}/enc.onnx")
        x = rng.standard_normal((N_ENCODER, 16 * 64)).astype(np.float32)
        for precision in ("f32", "bf16", "int8"):
            name = f"enc-{precision}"
            itt.load_model(name, f"{d}/enc.onnx", precision)
            got = itt.predict(name, x)  # the first call calibrates int8
            want = compile_model_bytes(enc.serialize(), "cpu", precision, device="cpu").run(x)[0]
            err = onnx_close(f"encoder {precision}", got.data.reshape(N_ENCODER, 8), want,
                             precision)
            ms = host_ms(torch, lambda name=name: itt.predict(name, x), runs=5)
            print(f"ONNX transformer encoder {precision} @ {N_ENCODER} rows: {ms:.3f} ms = "
                  f"{N_ENCODER / ms * 1e3:,.0f} rows/s on the host clock; max err against the "
                  f"CPU {err:.3e} of max|y|")
        conn = Connection()
        conn.execute(f"select infera_load_model('tfenc', '{d}/enc.onnx')")
        rows = conn.execute("select infera_predict_from_blob('tfenc', "
                            f"cast(repeat(chr(0), {16 * 64 * 4}) as blob)) r").rows
        want = compile_model_bytes(enc.serialize(), "cpu", device="cpu").run(
            np.zeros((1, 16 * 64), np.float32))[0]
        err = onnx_close("encoder SQL blob", np.asarray(rows[0][0], np.float32), want[0])
        print(f"ONNX transformer encoder through SQL infera_predict_from_blob: 8 outputs, "
              f"max err against the CPU {err:.3e} of max|y|")

    # ------------------------------------------------ If / Loop / Scan
    graphs = {
        "if (runtime, then)": (builder.if_model(), np.abs(rng.standard_normal((3, 4)))),
        "if (runtime, else)": (builder.if_model(), -np.abs(rng.standard_normal((3, 4)))),
        "if (static)": (builder.if_model(static_cond=True), rng.standard_normal((3, 4))),
        "loop (while)": (builder.loop_model(trips=5), rng.standard_normal((3, 4))),
        "loop (scan outputs)": (builder.loop_model(trips=4, scan_output=True),
                                rng.standard_normal((3, 4))),
        "scan": (builder.scan_model(), rng.standard_normal((6, 4))),
    }
    for key, (model, xg) in graphs.items():
        xg = xg.astype(np.float32)
        outs = [compile_model_bytes(model.serialize(), key, device=dev).run(xg)
                for dev in (device, "cpu")]
        for g, w in zip(*outs):
            onnx_close(f"ONNX {key}", g.cpu().numpy(), w.numpy())
    print(f"ONNX control flow: {', '.join(graphs)} equal the CPU's")
    torch.cuda.synchronize()
    check(fused_mlp.launches == k6_before, "the ONNX phase launched K6")
    print(f"ONNX phase: {time.perf_counter() - t_phase:.1f} s on the host clock; no kernel "
          f"of the port launched (torch ops, Conv in cuDNN without TF32)")


def mma_report(torch, _kernels, device) -> None:
    """The tensor-core paths: HMMA in the SASS (cuobjdump) of the bf16
    kernels of K1, K7a and K8b and none in the f32 and int8 ones, IMMA in
    K3's and K7b's int8 kernel and none in the f32 and bf16 ones; ptxas's
    registers, stack and spills of each (no spill in a tensor-core kernel);
    and at the bench MLP over 1,048,576 rows the resident blocks an SM and
    the grid, which must be at least two blocks an SM and the SMs times
    that."""
    from infera_tpu_torch.ops import fused_query as fq
    from infera_tpu_torch.testing import profile_query as pq

    # the mangled names' prefixes: namespace infera, then the kernel's name
    checks = (("fused_query", "HMMA", "6infera17query_bf16_kernel", 128),
              ("profile_query", "HMMA", "6infera12stage_kernel", 128),
              ("fused_sql", "HMMA", sql_instance(True), 128),
              ("fused_query", "IMMA", "6infera17query_int8_kernel", 80))
    for lib, opcode, mma_kernel, max_regs in checks:
        counts = _kernels.sass_opcodes(lib, opcode)
        check(sum(mma_kernel in fn for fn in counts) >= 1, f"{lib}: no kernel {mma_kernel}")
        for fn, count in sorted(counts.items()):
            mma = mma_kernel in fn
            regs, stack, spill = _kernels.ptxas_usage(lib, fn)
            print(f"SASS {lib} {fn}: {count} {opcode}; ptxas {regs} registers, {stack} B stack, "
                  f"{spill} B spilled")
            check(count > 0 if mma else count == 0,
                  f"{fn}: {count} {opcode}, expected {'some' if mma else 'none'}")
            if mma:
                check(spill == 0 and regs <= max_regs, f"{fn}: {regs} registers, {spill} B spilled")
    # K2's other instance: 3 blocks an SM, so at most 80 registers, no spill
    regs, stack, spill = _kernels.ptxas_usage("fused_sql", sql_instance(False))
    print(f"ptxas fused_sql {sql_instance(False)}: {regs} registers, {stack} B stack, "
          f"{spill} B spilled")
    check(spill == 0 and regs <= 80, f"K2: {regs} registers, {spill} B spilled")
    dims = pq.PROFILE_DIMS
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for name, table, row_major in (("K1 bf16", torch.bfloat16, False),
                                   ("K7a bf16", torch.bfloat16, True),
                                   ("K7a bf16 (f32 table)", torch.float32, True)):
        shape = (N_MAIN, 32) if row_major else (32, N_MAIN)
        x = torch.empty(shape, dtype=table, device=device)
        blocks, smem = fq.bf16_grid(x, dims, row_major)
        per_sm = fq.resident_blocks(device, table == torch.bfloat16, row_major, smem)
        print(f"{name} @ {dims}: {smem} B of shared memory, {per_sm} blocks resident a SM, "
              f"grid {blocks} blocks on {sms} SMs")
        check(per_sm >= 2 and blocks == sms * per_sm, f"{name}: {per_sm} blocks a SM, grid {blocks}")
    xq = torch.empty((32, N_MAIN), dtype=torch.int8, device=device)
    for name, static in (("K3", False), ("K7b", True)):
        blocks, smem = fq.int8_grid(xq, dims, static)
        per_sm = fq.int8_resident_blocks(device, static, smem)
        print(f"{name} @ {dims}: {smem} B of shared memory, {per_sm} blocks resident a SM, "
              f"grid {blocks} blocks on {sms} SMs")
        check(per_sm >= 2 and blocks == sms * per_sm, f"{name}: {per_sm} blocks a SM, grid {blocks}")
    smem = pq._stage_smem_bytes(dims)
    per_sm = pq.stage_resident_blocks(device, smem)
    print(f"K8b stage kernel @ {dims}: {smem} B of shared memory, {per_sm} blocks resident a SM")
    check(per_sm >= 2, f"K8b: {per_sm} blocks a SM")


def ffma_report(torch, _kernels, device) -> None:
    """The f32 layer stack of K1, K7a and K6 (``mlp_stack_ffma``): ptxas's
    registers, stack and spills of every instantiation of the f32 query
    kernel and of K6, with their FFMA counts (no spill, at most 128
    registers: a block of two halves is 512 threads), and at the bench MLP
    over 1,048,576 rows the halves a block, its threads, its shared memory
    and the grid, which must be two halves of 256 threads on one block an
    SM (K7a without its ring)."""
    from infera_tpu_torch.ops import fused_mlp as fm
    from infera_tpu_torch.ops import fused_query as fq

    for lib, kernel, want in (("fused_query", "6infera16query_f32_kernel", 4),
                              ("fused_mlp", "6infera16fused_mlp_kernel", 1)):
        counts = _kernels.sass_opcodes(lib, "FFMA")
        fns = sorted(fn for fn in counts if kernel in fn)
        check(len(fns) == want, f"{lib}: {len(fns)} kernels {kernel}, expected {want}")
        for fn in fns:
            regs, stack, spill = _kernels.ptxas_usage(lib, fn)
            print(f"SASS {lib} {fn}: {counts[fn]} FFMA; ptxas {regs} registers, {stack} B stack, "
                  f"{spill} B spilled")
            check(counts[fn] > 0 and spill == 0 and regs <= 128,
                  f"{fn}: {counts[fn]} FFMA, {regs} registers, {spill} B spilled")
    dims = (32, 128, 128, 16)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = []
    for name, table, row_major in (("K1 f32", torch.float32, False),
                                   ("K7a f32", torch.float32, True),
                                   ("K7a f32 (bf16 table)", torch.bfloat16, True)):
        shape = (N_MAIN, 32) if row_major else (32, N_MAIN)
        x = torch.empty(shape, dtype=table, device=device)
        blocks, halves, stages, smem = fq.f32_grid(x, dims, row_major)
        shapes.append((name, blocks, halves, smem, stages))
    blocks, halves, smem = fm.mlp_grid(device, dims, N_MAIN)
    shapes.append(("K6", blocks, halves, smem, 0))
    for name, blocks, halves, smem, stages in shapes:
        print(f"{name} @ {dims}: {halves} halves a block, {halves * fm.THREADS} threads, {smem} B "
              f"of shared memory, {stages} ring buffers, grid {blocks} blocks on {sms} SMs")
        check(halves == 2 and blocks == sms and stages == 0,
              f"{name}: {halves} halves, grid {blocks}, {stages} ring buffers")


def _block_rows(conn, name, xc):
    """{column: row} of the table's block on the card (the plan's block)."""
    from infera_tpu_torch.sql import device_plan

    block, row_map = device_plan.get_table_block(conn.catalog.get(name), xc.device)
    check(block is xc, f"table {name}: the plan's block is not the cached one")
    return row_map


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import infera_tpu_torch as itt
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1
    from infera_tpu_torch.bench import build_params
    from infera_tpu_torch.errors import ModelNotFound
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.ops import _kernels
    from infera_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain
    from infera_tpu_torch.ops.fused_query import (
        fused_mlp_query_columnar,
        fused_mlp_query_columnar_int8_shift,
        fused_mlp_query_columnar_int8_shift_plain,
        fused_mlp_query_columnar_plain,
        params_from_numpy,
        qparams_from_numpy,
        quantize_mlp_shift,
    )
    from infera_tpu_torch.registry import MODELS

    # ---------------------------------------------------------------- 1. card and build
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    build_s = _kernels.build_all()
    print(f"kernel build (nvcc, sm_90a, {len(_kernels.SOURCES)} sources in parallel): "
          f"{build_s:.1f} s")
    for src in _kernels.SOURCES:
        for line in _kernels.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    device = torch.device("cuda")
    itt.set_device(device)
    mma_report(torch, _kernels, device)
    ffma_report(torch, _kernels, device)

    # ---------------------------------------------------------------- data, from seeds
    params = build_params(seed=0)
    x_rows = np.random.default_rng(1).standard_normal((N_MAIN, 32)).astype(np.float32)
    xc = torch.as_tensor(np.ascontiguousarray(x_rows.T), device=device)   # [32, N] f32
    xc_bf16 = xc.to(torch.bfloat16)
    x_cal = np.random.default_rng(7).standard_normal((1 << 14, 32)).astype(np.float32)
    cal = quantize_mlp_shift(params, x_cal, max_flip_rate=0.04)
    check(cal is not None, "int8-shift calibration refused the benchmark model")
    qparams, s0, flip = cal
    print(f"int8-shift calibration: class-flip rate vs f32 {flip:.4f}")
    xq = torch.clamp(torch.round(xc / float(s0)), -127, 127).to(torch.int8)
    w_f32 = params_from_numpy(params, device, torch.float32)
    w_bf16 = params_from_numpy(params, device, torch.bfloat16)
    w_q = qparams_from_numpy(qparams, device)

    # ---------------------------------------------------------------- 2. the main path
    counters = {
        "K6": lambda: fused_mlp.launches,
        "K1-f32": lambda: fused_mlp_query_columnar.launches["f32"],
        "K1-bf16": lambda: fused_mlp_query_columnar.launches["bf16"],
        "K3": lambda: fused_mlp_query_columnar_int8_shift.launches,
    }
    fused_mlp.launches = 0
    fused_mlp_query_columnar.launches = {"f32": 0, "bf16": 0}
    fused_mlp_query_columnar_int8_shift.launches = 0

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        builder.write_reference_test_models(d)
        proto.save_model_file(
            builder.mlp_model(in_dim=32, hidden=(128, 128), out_dim=16, softmax=True),
            f"{d}/mlp.onnx")
        for model in ("linear", "multi_output", "mlp"):
            itt.load_model(model, f"{d}/{model}.onnx")
    anchor = itt.predict("linear", [[1.0, 2.0, 3.0]])
    check(abs(float(anchor.data[0]) - 1.75) < 1e-5, f"linear anchor gave {anchor.data}")
    ident = itt.predict("multi_output", [[1.0, 2.0, 3.0, 4.0]])
    check(np.array_equal(ident.data, np.array([1, 2, 3, 4], np.float32)), "multi_output")
    pred = itt.predict("mlp", x_rows)
    check((pred.rows, pred.cols) == (N_MAIN, 16), f"predict shape {pred.rows}x{pred.cols}")
    try:
        itt.predict("nope", [[1.0]])
        raise AssertionError("predict of a missing model did not raise")
    except ModelNotFound as e:
        check(str(e) == "Model not found: nope", f"error string {str(e)!r}")
    main_out = {
        "K1-f32": fused_mlp_query_columnar(w_f32, xc),
        "K1-bf16": fused_mlp_query_columnar(w_bf16, xc_bf16),
        "K3": fused_mlp_query_columnar_int8_shift(w_q, xq),
    }
    torch.cuda.synchronize()
    launches = {k: read() for k, read in counters.items()}
    print(f"main path: {time.perf_counter() - t0:.2f} s on the host clock; launches {launches}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")

    # ---------------------------------------------------------------- 3. kernels vs plain
    max_err = {}
    k6_weights = MODELS.get("mlp").mlp_weights
    x_dev = torch.as_tensor(x_rows, device=device)
    want = fused_mlp_plain(k6_weights, x_dev, final_softmax=True).cpu().numpy()
    got = pred.data.reshape(N_MAIN, 16)
    # f32 on both sides, sums in another order: the 1e-5 parity bound
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    err = float(np.abs(got - want).max())
    x_rag = x_dev[:N_RAGGED]
    got_r = fused_mlp(k6_weights, x_rag, final_softmax=True)
    want_r = fused_mlp_plain(k6_weights, x_rag, final_softmax=True)
    torch.testing.assert_close(got_r, want_r, rtol=1e-5, atol=1e-5)
    max_err["K6"] = max(err, float((got_r - want_r).abs().max()))
    print(f"K6 vs plain: max abs err {max_err['K6']:.3e}")

    def compare_query(key, got, want, n_rows):
        gc, gs = (t.cpu().numpy() for t in got)
        wc, ws = (t.cpu().numpy() for t in want)
        diff = int(np.abs(gc - wc).sum())
        kept = int(wc.sum())
        if key == "K1-f32":
            # f32 sums in another order can flip an argmax near a tie or the
            # sign of score0 near 0: a few rows of a million
            check(diff <= 4, f"{key} @ {n_rows}: counts differ by {diff} rows")
            np.testing.assert_allclose(gs, ws, rtol=1e-4)
        elif key == "K1-bf16":
            # the bf16 rounding of a ReLU output can go the other way when
            # the f32 sum before it differs in its last bit
            check(diff <= 1e-3 * kept, f"{key} @ {n_rows}: counts differ by {diff} of {kept}")
            np.testing.assert_allclose(gs, ws, rtol=2e-2, atol=1e-2)
        else:
            # integer layers are exact; the last layer is the same f32
            # multiply and add on both sides; only the f64 sum order differs
            check(diff == 0, f"{key} @ {n_rows}: counts differ by {diff} rows")
            np.testing.assert_allclose(gs, ws, rtol=1e-5)
        err = float(np.abs(gs - ws).max())
        print(f"{key} @ {n_rows} rows: kept {kept}, count diff {diff}, max abs sum err {err:.3e}")
        return err

    plains = {
        "K1-f32": (lambda t: fused_mlp_query_columnar_plain(w_f32, t), xc),
        "K1-bf16": (lambda t: fused_mlp_query_columnar_plain(w_bf16, t), xc_bf16),
        "K3": (lambda t: fused_mlp_query_columnar_int8_shift_plain(w_q, t), xq),
    }
    kernels = {
        "K1-f32": lambda t: fused_mlp_query_columnar(w_f32, t),
        "K1-bf16": lambda t: fused_mlp_query_columnar(w_bf16, t),
        "K3": lambda t: fused_mlp_query_columnar_int8_shift(w_q, t),
    }
    for key, (plain, table) in plains.items():
        e_main = compare_query(key, main_out[key], plain(table), N_MAIN)
        rag = table[:, :N_RAGGED].contiguous()
        e_rag = compare_query(key, kernels[key](rag), plain(rag), N_RAGGED)
        max_err[key] = max(e_main, e_rag)
        if key == "K3":
            xq_host = table.cpu().numpy()
            for n_rows, counts in ((N_MAIN, main_out[key][0]), (N_RAGGED, kernels[key](rag)[0])):
                emu = emulate_int8_shift(qparams, xq_host[:, :n_rows])
                diff = int(np.abs(counts.cpu().numpy() - emu).sum())
                check(diff == 0, f"K3 @ {n_rows}: counts differ from the emulation by {diff}")
                print(f"K3 @ {n_rows} rows: counts equal the numpy integer emulation")

    # ---------------------------------------------------------------- 4. times
    tw = [(torch.as_tensor(w, device=device), torch.as_tensor(b, device=device))
          for w, b in params]
    tw_bf16 = [(w.to(torch.bfloat16), b.to(torch.bfloat16)) for w, b in tw]
    twt = [(w.T.contiguous(), b.reshape(-1, 1)) for w, b in tw]
    twt_bf16 = [(w.to(torch.bfloat16), b.to(torch.bfloat16)) for w, b in twt]

    def library_mlp(x):
        h = x
        for i, (w, b) in enumerate(tw):
            h = torch.addmm(b, h, w)
            if i < len(tw) - 1:
                h = torch.relu(h)
        return torch.softmax(h, dim=-1)

    def library_tail(h):
        pred = h.argmax(dim=0)
        sel = (h[0] > 0).float()
        counts = torch.zeros(h.shape[0], device=h.device).index_add_(0, pred, sel)
        sums = torch.zeros(h.shape[0], device=h.device).index_add_(0, pred, h[0] * sel)
        return counts, sums

    def library_query(x, weights):
        h = x
        for i, (wt, b) in enumerate(weights):
            h = torch.addmm(b, wt, h)
            if i < len(weights) - 1:
                h = torch.relu(h)
        return library_tail(h.float())

    # K3's yardstick: cuBLASLt int8 products (torch._int_mm needs more than
    # 16 rows in its first operand, so the last layer's weights are padded
    # to 32 rows) with the shift epilogues as torch ops
    lq = []
    for i, (wq, a1, a2, a3) in enumerate(w_q.layers):
        if i == len(w_q.layers) - 1:
            wq = torch.nn.functional.pad(wq, (0, 0, 0, 32 - wq.shape[0]))
        lq.append((wq.contiguous(), a1, a2, a3))

    def library_int8(q):
        for i, (wq, a1, a2, a3) in enumerate(lq):
            y = torch._int_mm(wq, q)
            if i < len(lq) - 1:
                if w_q.need_sl[i]:
                    y = torch.bitwise_left_shift(y, a1)
                q = torch.clamp(torch.bitwise_right_shift(y + a3, a2), 0, 127).to(torch.int8)
            else:
                h = y[: a1.shape[0]].float() * a1 + a3
        return library_tail(h)

    macs = sum(w.shape[0] * w.shape[1] for w, _ in params)
    ops = 2.0 * N_MAIN * macs
    rows_bytes = {"K6": N_MAIN * (32 + 16) * 4, "K1-f32": N_MAIN * 32 * 4,
                  "K1-bf16": N_MAIN * 32 * 2, "K3": N_MAIN * 32}
    timed = {
        "K6": ("f32", lambda: fused_mlp(k6_weights, x_dev, True),
               lambda: fused_mlp_plain(k6_weights, x_dev, True), lambda: library_mlp(x_dev)),
        "K1-f32": ("f32", lambda: fused_mlp_query_columnar(w_f32, xc),
                   lambda: fused_mlp_query_columnar_plain(w_f32, xc),
                   lambda: library_query(xc, twt)),
        "K1-bf16": ("bf16", lambda: fused_mlp_query_columnar(w_bf16, xc_bf16),
                    lambda: fused_mlp_query_columnar_plain(w_bf16, xc_bf16),
                    lambda: library_query(xc_bf16, twt_bf16)),
        "K3": ("int8", lambda: fused_mlp_query_columnar_int8_shift(w_q, xq),
               lambda: fused_mlp_query_columnar_int8_shift_plain(w_q, xq),
               lambda: library_int8(xq)),
    }
    meta = {
        "K6": ("fused_mlp", "infera_tpu_torch/csrc/fused_mlp.cu",
               "infera_tpu/ops/pallas_mlp.py:32"),
        "K1-f32": ("fused_mlp_query_columnar (f32)", "infera_tpu_torch/csrc/fused_query.cu",
                   "infera_tpu/ops/pallas_query.py:66"),
        "K1-bf16": ("fused_mlp_query_columnar (bf16)", "infera_tpu_torch/csrc/fused_query.cu",
                    "infera_tpu/ops/pallas_query.py:66"),
        "K3": ("fused_mlp_query_columnar_int8_shift", "infera_tpu_torch/csrc/fused_query.cu",
               "infera_tpu/ops/pallas_query.py:300"),
    }
    rows = []
    for key, (op_type, kern, plain, lib) in timed.items():
        kern_times = device_ms(torch, kern)
        ms, q25, q75 = (float(v) for v in np.percentile(kern_times, [50, 25, 75]))
        plain_ms = float(np.median(device_ms(torch, plain)))
        library_ms = float(np.median(device_ms(torch, lib)))
        b_ms, b_by = bound(ops, rows_bytes[key], op_type, peaks)
        kname, src, replaces = meta[key]
        rows.append({"name": f"{key} {kname}", "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[key],
                     "max_abs_err": max_err[key], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms})
        print(f"{key}: kernel {ms:.4f} ms (quartiles {q25:.4f}-{q75:.4f}), plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    # engine predict end to end on the host clock, beside its parts: the
    # input's copy to the card, K6, and the output's copy back
    out_dev = fused_mlp(k6_weights, x_dev, True)
    parts = {"predict": host_ms(torch, lambda: itt.predict("mlp", x_rows)),
             "h2d": host_ms(torch, lambda: torch.as_tensor(x_rows, device=device)),
             "k6": rows[0]["ms"],
             "d2h": host_ms(torch, lambda: out_dev.cpu())}
    print(f"engine predict @ {N_MAIN} rows: {parts['predict']:.3f} ms on the host clock = "
          f"{N_MAIN / parts['predict'] * 1e3:,.0f} rows/s; copy in {parts['h2d']:.3f} ms, "
          f"K6 {parts['k6']:.3f} ms, copy out {parts['d2h']:.3f} ms")

    bench_rows, bench_launches = bench_phase(torch, itt, params, x_rows, x_dev, peaks, device,
                                             parts["predict"])
    # K1 and K3 launch on both paths: the row counts the launches of each
    for row in rows:
        row["launches"] += bench_launches.get(row["name"].split(" ")[0], 0)
    rows += bench_rows
    rows += sql_phase(torch, itt, x_rows, peaks, device)
    rows += tree_phase(torch, itt, x_rows, peaks, device)
    rows += join_phase(torch, itt, peaks, device)
    rows += tail_phase(torch, itt, x_rows, peaks, device)
    device_plan_phase(torch, itt, device)
    rows += profile_phase(torch, itt, x_dev, peaks, device)
    onnx_phase(torch, itt, device)

    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
