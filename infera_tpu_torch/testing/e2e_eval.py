"""End-to-end evaluation of the port, one subcommand a path.

Counterpart of ``infera_tpu/testing/e2e_eval.py``: the same subcommands, the
same JSON lines under the same ``step`` keys, with the port's path names
(``device_plan_cuda``, ``device_join_plan_cuda``, ``shuffle_join``, ...).
Everything runs on the port's device (the card unless ``INFERA_PLATFORM=cpu``
or ``set_device("cpu")``). Device times come from CUDA events where the
reference forces a read-back (on the CPU, from the host clock); data comes
from numpy's ``default_rng`` or a seeded ``torch.Generator``.

  sql          — 1M-row fused SQL query end to end with its phases (METRICS),
                 then a small tensor's round trip.
  outer_join   — 1M-row LEFT and FULL joins against a 1,000-row dimension,
                 steady-state timing.
  int8         — a 256-wide MLP over 1M rows through the engine: f32, bf16
                 and int8 (static-calibrated), steady state.
  mobilenet    — the MobileNetV3-Small stand-in through the blob path at the
                 reference's 602,112-byte input.
  window       — 1M-row window functions on the host route, and the device
                 route's ``window_device`` alone.
  shuffle_join — config 5: two skewed-key tables joined and aggregated
                 through the pre-aggregated shuffle join, against a numpy
                 per-key oracle.

Usage: python -m infera_tpu_torch.testing.e2e_eval <sql|outer_join|int8|mobilenet|window|shuffle_join>
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def _emit(**kw):
    print(json.dumps(kw), flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _per_call_s(device: torch.device, fn, iters: int) -> float:
    """Seconds a call of ``fn`` over ``iters`` calls queued back to back:
    CUDA events around them on the card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _mk_conn_with_table(n):
    from ..sql import Connection

    conn = Connection()
    t0 = time.perf_counter()
    conn.execute(
        f"create table big as select x % 64 as g, "
        f"(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
        f"((x * 7) % 30)::float / 3.0 as f3, ((x * 11) % 90)::float / 9.0 as f4 "
        f"from range({n}) r(x)")
    _emit(step="create_table", rows=n, s=round(time.perf_counter() - t0, 2))
    return conn


def eval_sql(n=1 << 20):
    import infera_tpu_torch as itt

    from ..device import get_device
    from ..observability import METRICS
    from ..onnx.builder import mlp_model

    device = get_device()
    conn = _mk_conn_with_table(n)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.onnx")
        with open(path, "wb") as f:
            f.write(mlp_model(in_dim=4, hidden=(32,), out_dim=1).serialize())
        itt.load_model("m", path)
    q = ("select g, count(*) c, avg(infera_predict('m', f1, f2, f3, f4)) p, "
         "sum(f1) s from big where f2 > 1.0 group by g order by g")
    for i in range(6):
        t0 = time.perf_counter()
        rows = conn.execute(q).rows
        wall = time.perf_counter() - t0
        m = METRICS.entries[0].as_dict()
        _emit(step="sql_e2e", it=i, wall_ms=round(wall * 1e3, 2),
              path=m["path"], phases=m.get("phases"), groups=len(rows))
    # transfer calibration: a small device tensor's round trip to the host;
    # exec_readback minus this is the device's share
    tiny = torch.arange(64, dtype=torch.float32, device=device) * 2.0
    _sync(device)
    tiny.cpu()
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        (tiny * 2.0).cpu()
        rtts.append(time.perf_counter() - t0)
    _emit(step="rtt_calibration", min_ms=round(min(rtts) * 1e3, 2),
          med_ms=round(sorted(rtts)[2] * 1e3, 2))


def eval_outer_join(n=1 << 20, dim=1000):
    from ..sql import Connection

    conn = Connection()
    conn.execute(f"create table fact as select x % 1100 as k, "
                 f"(x % 40)::float / 4.0 as v from range({n}) r(x)")
    conn.execute(f"create table dim as select x as k, (x * 2)::float as w "
                 f"from range({dim}) r(x)")
    # keys 1000..1099 of fact have no dim row: real outer NULLs; aggregate
    # over the joined relation instead of materializing it
    for kind in ("left", "full"):
        q = (f"select count(*) c, count(w) cw, sum(v) sv, "
             f"sum(coalesce(w, 0.0)) sw from fact {kind} join dim "
             f"on fact.k = dim.k")
        t0 = time.perf_counter()
        out = conn.execute(q)
        wall = time.perf_counter() - t0
        c, cw, sv, sw = out.rows[0]
        # outer semantics: unmatched fact keys keep their rows with NULL
        # dim columns, so count(w) < count(*)
        assert c >= n and cw == (n // 1100) * 1000 + min(n % 1100, 1000), (c, cw)
        _emit(step="outer_join_first", kind=kind,
              wall_ms=round(wall * 1e3, 2), path=conn._exec_path,
              c=int(c), cw=int(cw))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            conn.execute(q)
            times.append(time.perf_counter() - t0)
        best = min(times)
        _emit(step="outer_join", kind=kind, wall_ms=round(best * 1e3, 2),
              rows_per_s=round(n / best), path=conn._exec_path)


def eval_int8(n=1 << 20, width=256):
    from ..device import get_device
    from ..onnx.builder import mlp_model
    from ..onnx.executor import compile_model_bytes

    device = get_device()
    data = mlp_model(in_dim=width, hidden=(width, width), out_dim=16).serialize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((n, width), generator=gen, device=device, dtype=torch.float32)
    _sync(device)
    _emit(step="datagen", s=round(time.perf_counter() - t0, 2))
    results = {}
    for prec in ("f32", "bf16", "int8"):
        model = compile_model_bytes(data, f"m_{prec}", precision=prec, device=device)
        if prec == "int8":
            t0 = time.perf_counter()
            model.calibrate_int8([x[:4096]])
            _emit(step="calibrate", s=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        out = model.run(x)
        float(out[0].sum())  # first call, forced read-back
        _emit(step="first_call", precision=prec, s=round(time.perf_counter() - t0, 2))
        out = model.run(x)
        float(out[0].sum())
        dt = _per_call_s(device, lambda: model.run(x), 30)
        results[prec] = dt
        _emit(step="int8_bench", precision=prec, ms_per_iter=round(dt * 1e3, 3),
              rows_per_s=round(n / dt))
    _emit(step="int8_summary", int8_vs_f32=round(results["f32"] / results["int8"], 3))
    _emit(step="bf16_summary", bf16_vs_f32=round(results["f32"] / results["bf16"], 3))


def eval_mobilenet(iters=20):
    """Latency of the MobileNetV3-Small stand-in through the blob path at
    the reference's pinned input (1x224x224x3 f32 = 602,112 bytes)."""
    import infera_tpu_torch as itt

    from ..onnx.builder import mobilenet_like_model
    from ..registry import MODELS

    data = mobilenet_like_model().serialize()
    _emit(step="model_bytes", n=len(data))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "mnet.onnx")
        with open(path, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        itt.load_model("mnet", path)
        _emit(step="load", s=round(time.perf_counter() - t0, 2))
    blob = np.zeros(1 * 224 * 224 * 3, np.float32).tobytes()
    t0 = time.perf_counter()
    out = itt.predict_from_blob("mnet", blob)
    _emit(step="first_call_compile", s=round(time.perf_counter() - t0, 2),
          n_out=int(out.data.size))
    for _ in range(3):
        itt.predict_from_blob("mnet", blob)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = itt.predict_from_blob("mnet", blob)
    dt = (time.perf_counter() - t0) / iters
    _emit(step="mobilenet_blob_latency", ms_per_call=round(dt * 1e3, 2),
          note="includes blob decode + host readback per call (the "
               "reference's per-row FFI path shape)")
    MODELS.clear()


def eval_window(n=1 << 20):
    """Window functions over n rows: the host route end to end, then the
    device route's ``window_device`` alone (CUDA events; no read-back)."""
    from ..device import get_device
    from ..ops.window import window_device
    from ..sql import Connection

    device = get_device()
    conn = Connection()
    conn.execute(
        f"create table wt as select x % 64 as p, "
        f"(x * 2654435761) % 1000000 as k, (x % 97)::float as v "
        f"from range({n}) r(x)")
    for q, label in [
        ("select sum(v) over (partition by p order by k) s from wt", "running_sum"),
        ("select rank() over (partition by p order by k) r from wt", "rank"),
    ]:
        conn.execute(q)
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            conn.execute(q)
            best = min(best, time.perf_counter() - t0)
        _emit(step="window_host", kind=label, ms=round(best * 1e3, 1),
              rows_per_s=round(n / best), path=conn._exec_path)
    xs = np.arange(n, dtype=np.int64)
    part = torch.from_numpy(xs % 64).to(device)
    key = torch.from_numpy((xs * 2654435761) % 1000000).to(device)
    val = torch.from_numpy((xs % 97).astype(np.float32)).to(device)
    for name in ("sum", "rank"):
        def run(name=name):
            return window_device([part], [key], val, name, "default")

        out = run()
        out[:64].cpu()  # first call, settled
        rtts = []
        for _ in range(5):
            t0 = time.perf_counter()
            out[:64].cpu()
            rtts.append(time.perf_counter() - t0)
        dt = _per_call_s(device, run, 20)
        _emit(step="window_device_compute", kind=name, ms=round(dt * 1e3, 3),
              rtt_ms=round(min(rtts) * 1e3, 2), rows_per_s=round(n / dt))


def eval_shuffle_join(n=1 << 24):
    """BASELINE config 5: an n x n skewed-key fact join-aggregate through
    the pre-aggregated shuffle join, pair counts exact."""
    from ..sql import Connection

    conn = Connection()
    t0 = time.perf_counter()
    # hot key 7 takes a tenth of both sides: a materializing join would
    # build n^2 / 100 pairs for it alone
    conn.execute(
        f"create table fa as select case when x % 10 = 3 then 7 "
        f"else (x * 2654435761) % 1000003 end as k, x % 64 as g, "
        f"(x % 40)::float / 4.0 as v from range({n}) r(x)")
    conn.execute(
        f"create table fb as select case when x % 10 = 6 then 7 "
        f"else (x * 40503) % 1000003 end as k, "
        f"(x % 90)::float / 9.0 as w from range({n}) r(x)")
    _emit(step="create_tables", rows=2 * n, s=round(time.perf_counter() - t0, 1))
    q = "select count(*) c, sum(v) sv, sum(w) sw from fa join fb on fa.k = fb.k"
    t0 = time.perf_counter()
    out = conn.execute(q)
    wall = time.perf_counter() - t0
    c, sv, sw = out.rows[0]
    _emit(step="shuffle_join_first", wall_ms=round(wall * 1e3),
          path=conn._exec_path, phases=getattr(conn, "_last_phases", None),
          pairs=int(c))
    # the exact oracle from per-key counts and sums (no pair expansion)
    x = np.arange(n)
    ka = np.where(x % 10 == 3, 7, (x * 2654435761) % 1000003)
    kb = np.where(x % 10 == 6, 7, (x * 40503) % 1000003)
    v = (x % 40) / 4.0
    w = (x % 90) / 9.0
    cnt_b = np.bincount(kb, minlength=1000004).astype(np.int64)
    sw_b = np.zeros(1000004)
    np.add.at(sw_b, kb, w)
    want_c = int(cnt_b[ka].sum())
    want_sv = float((v * cnt_b[ka]).sum())
    want_sw = float(sw_b[ka].sum())
    _emit(step="shuffle_join_exact", count_exact=bool(c == want_c),
          sv_rel=abs(sv - want_sv) / max(abs(want_sv), 1),
          sw_rel=abs(sw - want_sw) / max(abs(want_sw), 1))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        conn.execute(q)
        times.append(time.perf_counter() - t0)
    best = min(times)
    _emit(step="shuffle_join", wall_ms=round(best * 1e3),
          rows_per_s=round(2 * n / best), path=conn._exec_path, pairs=int(c))


CMDS = {"sql": eval_sql, "outer_join": eval_outer_join, "int8": eval_int8,
        "mobilenet": eval_mobilenet, "window": eval_window,
        "shuffle_join": eval_shuffle_join}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "sql"
    t0 = time.perf_counter()
    CMDS[name]()
    _emit(step=name, done=True, wall_s=round(time.perf_counter() - t0, 1))


if __name__ == "__main__":
    main()
