"""Benchmark of the fused inference query on one CUDA card.

Counterpart of the repo's ``bench.py`` for the port. The workload is the same
query: an MLP classifier (32 -> 128 -> 128 -> 16) over a 1,048,576-row
feature-major table, then argmax, the filter ``score0 > 0`` and a per-class
count and sum. The implementations, in ``bench.py``'s order with ``pallas_``
renamed ``cuda_``:

- ``torch``: the query as a chain of PyTorch ops on the card (the
  counterpart of ``xla``);
- ``cuda_col_bf16_io``: K1 in bf16 over a bf16 table;
- ``cuda_col_int8_shift``: K3 over an int8 table;
- ``cuda_col_f32``: K1 in f32 (the parity kernel).

Device times come from CUDA events over ``--iters`` back-to-back calls. The
baseline is the same query in PyTorch on the host CPU with a pinned thread
count, as in ``bench.py``. There is no CPU fallback: without a CUDA device the
run fails.

Run: ``python -m infera_tpu_torch.bench [--rows N] [--iters N]``. Prints one
JSON line:
  {"metric": ..., "value": N, "unit": "rows/s", "vs_baseline": N, ...}
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .ops.fused_query import (
    fused_mlp_query_columnar,
    fused_mlp_query_columnar_int8_shift,
    params_from_numpy,
    qparams_from_numpy,
    quantize_mlp_shift,
)

IN_DIM, HIDDEN, OUT_DIM = 32, (128, 128), 16
METRIC = "mlp_batched_inference_query_rows_per_s_per_chip"

# Roofline constants for MFU / HBM share: an H100 SXM's dense bf16 tensor-core
# peak and its HBM3 rate (NVIDIA's data sheet); override for other cards.
PEAK_TFLOPS = float(os.environ.get("INFERA_GPU_PEAK_TFLOPS", "989"))
HBM_GBS = float(os.environ.get("INFERA_GPU_HBM_GBS", "3350"))


def build_params(seed=0):
    """The benchmark's MLP weights, [(w [din, dout], b [dout]), ...] numpy."""
    rng = np.random.default_rng(seed)
    dims = [IN_DIM, *HIDDEN, OUT_DIM]
    params = []
    for i in range(len(dims) - 1):
        w = (rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
             * np.float32(1.0 / np.sqrt(dims[i])))
        b = rng.standard_normal(dims[i + 1]).astype(np.float32) * np.float32(0.1)
        params.append((w, b))
    return params


def torch_query(tparams, xc):
    """The query as plain PyTorch ops over a feature-major table [d0, N]."""
    h = xc
    for i, (wt, b) in enumerate(tparams):
        h = torch.addmm(b, wt, h)
        if i < len(tparams) - 1:
            h = torch.relu(h)
    pred = h.argmax(dim=0)
    sel = (h[0] > 0).float()
    counts = torch.zeros(h.shape[0], device=h.device).index_add_(0, pred, sel)
    sums = torch.zeros(h.shape[0], device=h.device).index_add_(0, pred, h[0] * sel)
    return counts, sums


def device_ms(fn, arg, iters: int) -> float:
    """Mean ms per call of ``fn(arg)`` over ``iters`` queued calls, from CUDA
    events, after two warm-up calls."""
    fn(arg)
    fn(arg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(arg)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bench_cuda(params, rows: int, iters: int) -> dict:
    device = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", file=sys.stderr)
    x = np.random.default_rng(1).standard_normal((rows, IN_DIM)).astype(np.float32)
    xc = torch.as_tensor(np.ascontiguousarray(x.T), device=device)
    model_flops = 2 * rows * sum(w.shape[0] * w.shape[1] for w, _ in params)

    tparams = [(torch.as_tensor(np.ascontiguousarray(w.T), device=device),
                torch.as_tensor(b.reshape(-1, 1), device=device)) for w, b in params]
    w_bf16 = params_from_numpy(params, device, torch.bfloat16)
    w_f32 = params_from_numpy(params, device, torch.float32)
    impls = [("torch", lambda a: torch_query(tparams, a), xc),
             ("cuda_col_bf16_io", lambda a: fused_mlp_query_columnar(w_bf16, a),
              xc.to(torch.bfloat16))]
    # the calibration sample is made on the host: the scales only need
    # representative magnitudes
    x_host = np.random.default_rng(7).standard_normal((1 << 14, IN_DIM)).astype(np.float32)
    shift_cal = quantize_mlp_shift(params, x_host, max_flip_rate=0.04)
    if shift_cal is not None:
        qp, s0, flip = shift_cal
        print(f"int8-shift calibration: class-flip rate vs f32 = {flip:.4f} (gate 0.04)",
              file=sys.stderr)
        xq = torch.clamp(torch.round(xc / float(s0)), -127, 127).to(torch.int8)
        w_q = qparams_from_numpy(qp, device)
        impls.append(("cuda_col_int8_shift",
                      lambda a: fused_mlp_query_columnar_int8_shift(w_q, a), xq))
    else:
        print("int8-shift calibration REFUSED (class-flip gate)", file=sys.stderr)
    impls.append(("cuda_col_f32", lambda a: fused_mlp_query_columnar(w_f32, a), xc))

    best = None
    for name, fn, inp in impls:
        ms = device_ms(fn, inp, iters)
        dt = ms / 1e3
        rps = rows / dt
        bytes_in = inp.numel() * inp.element_size()
        mfu = model_flops / dt / (PEAK_TFLOPS * 1e12)
        hbm = bytes_in / dt / (HBM_GBS * 1e9)
        print(f"{name}: {ms:.4f} ms/iter = {rps:,.0f} rows/s "
              f"(MFU {mfu * 100:.2f}%, HBM {hbm * 100:.2f}%)", file=sys.stderr)
        if best is None or rps > best["rows_per_s"]:
            best = {"impl": name, "rows_per_s": rps, "mfu": round(mfu, 4),
                    "hbm_frac": round(hbm, 4)}
    return best


def bench_torch_cpu(params, rows: int, iters: int = 2) -> float:
    """The same query in PyTorch on the host CPU (bench.py's baseline)."""
    torch.set_num_threads(int(os.environ.get("INFERA_BENCH_TORCH_THREADS", "2")))
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((rows, IN_DIM)).astype(np.float32))
    tparams = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in params]

    def query(x):
        h = x
        for i, (w, b) in enumerate(tparams):
            h = h @ w + b
            if i < len(tparams) - 1:
                h = torch.relu(h)
        pred = h.argmax(dim=-1)
        w_sel = (h[:, 0] > 0.0).to(torch.float32)
        counts = torch.zeros(OUT_DIM).index_add_(0, pred, w_sel)
        sums = torch.zeros(OUT_DIM).index_add_(0, pred, h[:, 0] * w_sel)
        return counts, sums

    query(x)  # warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        query(x)
    return rows * iters / (time.perf_counter() - t0)


def _arg(argv, flag: str, default: int) -> int:
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            return int(argv[i + 1])
    return default


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("infera_tpu_torch.bench: no CUDA device", file=sys.stderr)
        return 1
    rows = _arg(argv, "--rows", 1 << 20)
    iters = _arg(argv, "--iters", 200)
    params = build_params()
    result = bench_cuda(params, rows, iters)
    threads = int(os.environ.get("INFERA_BENCH_TORCH_THREADS", "2"))
    cpu_rows_s = bench_torch_cpu(params, rows)
    print(f"torch-cpu baseline ({threads} threads pinned): {cpu_rows_s:,.0f} rows/s",
          file=sys.stderr)
    print(json.dumps({
        "metric": METRIC,
        "value": round(result["rows_per_s"], 1),
        "unit": "rows/s",
        "vs_baseline": round(result["rows_per_s"] / cpu_rows_s, 3),
        "impl": result["impl"],
        "mfu": result["mfu"],
        "hbm_frac": result["hbm_frac"],
        "baseline_rows_per_s": round(cpu_rows_s, 1),
        "baseline_torch_threads": threads,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
