#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, builds every kernel of ``infera_tpu_torch/csrc`` with nvcc (sm_90a), and:

1. prints the card, its power limit, the torch and CUDA versions and the
   build time;
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
   (the same catalog with ``INFERA_PALLAS_SQL=0``); it prints each query's
   steady time on the host clock and its phases, holds K2 against its plain
   version on the emitted plans at 1,048,576 and 1,000,003 rows, and times
   K2, its plain version and a PyTorch library chain;
6. prints the ``{"kernels": [...]}`` line, the card's name and power limit,
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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


SQL_A = ("select g, count(*) c, avg(infera_predict('m', f1, f2, f3, f4)) p, sum(f1) s "
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
    conn.execute("create table big as select x % 64 as g, x % 5 as h, "
                 "(x % 100)::float / 10.0 as f1, "
                 "((x + 3) % 50)::float / 5.0 as f2, ((x * 7) % 30)::float / 3.0 as f3, "
                 f"((x * 11) % 90)::float / 9.0 as f4 from range({n}) r(x)")
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
    fs.fused_sql.launches = {"f32": 0, "bf16": 0}
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
    os.environ["INFERA_PALLAS_SQL"] = "0"
    host = {key: conn.execute(q).rows for key, q in queries.items()}
    check(conn._exec_path == "host", "INFERA_PALLAS_SQL=0 did not select the host executor")
    os.environ.pop("INFERA_PALLAS_SQL")
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
    for (key, q), (xc, packed) in zip(queries.items(), plans):
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
    return rows


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
    def host_ms(fn, runs=7):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    out_dev = fused_mlp(k6_weights, x_dev, True)
    parts = {"predict": host_ms(lambda: itt.predict("mlp", x_rows)),
             "h2d": host_ms(lambda: torch.as_tensor(x_rows, device=device)),
             "k6": rows[0]["ms"],
             "d2h": host_ms(lambda: out_dev.cpu())}
    print(f"engine predict @ {N_MAIN} rows: {parts['predict']:.3f} ms on the host clock = "
          f"{N_MAIN / parts['predict'] * 1e3:,.0f} rows/s; copy in {parts['h2d']:.3f} ms, "
          f"K6 {parts['k6']:.3f} ms, copy out {parts['d2h']:.3f} ms")

    rows += sql_phase(torch, itt, x_rows, peaks, device)

    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
