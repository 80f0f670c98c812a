"""Benchmark suite: BASELINE.json configs 1-5 on the port (counterpart of
``infera_tpu/testing/benchmarks.py``).

1. linear.onnx semantics over a 3-column f32 table (a plain product)
2. MLP classifier over a 1,048,576-row table, then argmax, the filter
   ``score0 > 0`` and a per-class count and sum: kernel K1 in bf16
3. multi-output predictions joined back to the source table (argsort join)
4. the 64-tree depth-6 GBT through the ONNX engine

5. config 5's distributed step (``parallel/pipeline.py``) over a dp mesh,
   and the scaling harness over 1, 2, 4 and 8 shards (on one card the
   shards are logical: the harness measures the exchange, not scaling).

Each config reports rows/s from the host clock between two synchronisations of
the device around queued calls; each result keeps the last call's output for
checking. Every entry point runs on the port's device (``infera_tpu_torch.
device``: the card unless the caller asks for the CPU). Run:
``python -m infera_tpu_torch.testing.benchmarks [config1 ...]``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import get_device


@dataclass
class BenchResult:
    name: str
    rows_per_s: float
    rows: int
    seconds: float
    detail: str = ""
    output: object = None  # the last timed call's result


# Published dense peaks of an H100 (NVIDIA data sheets): f32 on the CUDA
# cores, bf16 and int8 on the tensor cores, and the HBM rate, keyed by a word of
# the card's name; the SXM part is the default. The same table as
# chip_smoke.py's.
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


def device_peaks(device: torch.device) -> dict | None:
    """The peaks of the card ``device`` is on; None on the CPU."""
    if device.type != "cuda":
        return None
    return card_peaks(torch.cuda.get_device_name(device))


def roofline(flops: int, bytes_moved: int, seconds: float, f32: bool = True) -> str:
    """Fraction of the card's speed of light achieved: the larger of the
    compute and the memory utilization, against the peaks of the card the
    port runs on (f32 on the CUDA cores, else bf16 on the tensor cores)."""
    if not torch.cuda.is_available():
        return "SOL: not measured (no CUDA card)"
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    peak = peaks["f32"] if f32 else peaks["bf16"]
    compute_frac = (flops / seconds) / peak if seconds > 0 else 0.0
    mem_frac = (bytes_moved / seconds) / peaks["bytes"] if seconds > 0 else 0.0
    bound = "compute" if compute_frac >= mem_frac else "memory"
    return (f"SOL: {max(compute_frac, mem_frac) * 100:.1f}% of {name} ({bound}-bound; "
            f"{flops / seconds / 1e12:.2f} TFLOP/s, {bytes_moved / seconds / 1e9:.1f} GB/s)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device: torch.device, iters: int = 3, warmup: int = 1):
    """(seconds per call, last output) of ``fn`` over ``iters`` queued calls
    between two synchronisations, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters, out


def bench_config1_linear(rows: int = 1_000_000, device=None) -> BenchResult:
    """linear.onnx semantics: y = 2x1 - x2 + 0.5x3 + 0.25 over a float table."""
    device = torch.device(device) if device is not None else get_device()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((rows, 3)).astype(np.float32), device=device)
    w = torch.tensor([[2.0], [-1.0], [0.5]], device=device)
    b = torch.tensor([0.25], device=device)
    dt, out = _time(lambda: torch.matmul(x, w) + b, device)
    return BenchResult("config1_linear_predict", rows / dt, rows, dt, output=out)


def config2_params():
    """Config 2's MLP 32 -> 128 -> 128 -> 16 as ``infera_tpu``'s benchmark
    draws it from ``default_rng(0)`` (its table is the next draw)."""
    rng = np.random.default_rng(0)
    dims = [32, 128, 128, 16]
    params = [((rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
                * np.float32(1 / np.sqrt(dims[i]))),
               rng.standard_normal(dims[i + 1]).astype(np.float32) * np.float32(0.1))
              for i in range(len(dims) - 1)]
    return params, rng


def bench_config2_mlp(rows: int = 1 << 20, use_pallas: bool = True, device=None) -> BenchResult:
    """MLP predict + filter + per-class aggregate over a feature-major table:
    with ``use_pallas``, kernel K1 in bf16 (one launch, the query fused);
    else the same query as a chain of torch ops in f32. Returns (counts,
    sums) as the output."""
    from ..bench import torch_query
    from ..ops.fused_query import fused_mlp_query_columnar, params_from_numpy

    device = torch.device(device) if device is not None else get_device()
    params, rng = config2_params()
    x = rng.standard_normal((rows, 32)).astype(np.float32)
    xc = torch.as_tensor(np.ascontiguousarray(x.T), device=device)
    if use_pallas:
        weights = params_from_numpy(params, device, torch.bfloat16)
        arg = xc.to(torch.bfloat16)

        def q():
            return fused_mlp_query_columnar(weights, arg)
    else:
        tparams = [(torch.as_tensor(np.ascontiguousarray(w.T), device=device),
                    torch.as_tensor(b.reshape(-1, 1), device=device)) for w, b in params]

        def q():
            return torch_query(tparams, xc)

    dt, out = _time(q, device)
    dims = [32, 128, 128, 16]
    flops = 2 * rows * sum(d1 * d2 for d1, d2 in zip(dims[:-1], dims[1:]))
    bytes_moved = rows * 32 * 2 if use_pallas else rows * (32 + 2 * 256 + 16) * 4
    return BenchResult(
        "config2_mlp_filter_agg", rows / dt, rows, dt,
        detail=("cuda-query-fused" if use_pallas else "torch") + " | "
        + roofline(flops, bytes_moved, dt, f32=not use_pallas),
        output=out)


def bench_config3_join(rows: int = 1_000_000, device=None) -> BenchResult:
    """Multi-output predictions joined back to the source table on row keys:
    both sides sorted by key and aligned (1:1 keys), then summed against a
    payload."""
    device = torch.device(device) if device is not None else get_device()
    rng = np.random.default_rng(0)
    keys = torch.as_tensor(rng.permutation(rows).astype(np.int32), device=device)
    x = torch.as_tensor(rng.standard_normal((rows, 8)).astype(np.float32), device=device)
    w = torch.as_tensor(rng.standard_normal((8, 4)).astype(np.float32), device=device)
    payload = torch.as_tensor(rng.standard_normal(rows).astype(np.float32), device=device)

    def q():
        scores = torch.matmul(x, w)
        order_l = torch.argsort(keys)
        order_r = torch.argsort(keys)
        joined = scores[order_r][torch.argsort(order_l)]  # aligned to the left order
        return torch.sum(joined[:, 0] * payload)

    dt, out = _time(q, device)
    return BenchResult("config3_multioutput_join", rows / dt, rows, dt, output=out)


def bench_config4_gbt(rows: int = 262_144, device=None) -> BenchResult:
    """Tree-ensemble (GBT) inference through the ONNX engine, on an input
    already on the device (as mid-pipeline in the query engine)."""
    from ..onnx import builder, compile_model_bytes

    device = torch.device(device) if device is not None else get_device()
    model = compile_model_bytes(
        builder.gbt_regressor_model(n_features=16, n_trees=64, depth=6).serialize(),
        "gbt_bench", device=device)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((rows, 16)).astype(np.float32), device=device)
    dt, out = _time(lambda: model.run(x)[0], device)
    return BenchResult("config4_gbt_predict", rows / dt, rows, dt, output=out)


def bench_config5_distributed(rows_per_dev: int = 65_536, n_devices: int = 8,
                              device=None) -> BenchResult:
    """Config 5's distributed step (``parallel/pipeline.py``): batched
    inference, the filter, the shuffle by group key and the psum'd group
    sums over a dp mesh of ``n_devices`` shards on ``device`` (the port's
    device by default; on one card the shards are logical)."""
    from ..parallel.mesh import make_mesh
    from ..parallel.pipeline import example_inputs, make_distributed_query_step

    mesh = make_mesh(n_devices, device=device)
    ndev = mesh.shape["dp"]
    rows = rows_per_dev * ndev
    step = make_distributed_query_step(mesh, n_groups=64, cap=rows_per_dev)
    params, x, keys = example_inputs(mesh, rows, in_dim=32, out_dim=16, n_groups=64)
    dt, out = _time(lambda: step(params, x, keys), mesh.local_devices[0])
    return BenchResult(f"config5_distributed_{ndev}dev", rows / dt, rows, dt,
                       detail=_mesh_detail(mesh), output=out)


def _mesh_detail(mesh) -> str:
    ndev = mesh.shape["dp"]
    if mesh.n_physical < ndev:
        return (f"{ndev} shards, logical on {mesh.n_physical} device(s) "
                f"({mesh.local_devices[0]}): they run one after another")
    return f"{ndev} device(s)"


def bench_scaling(rows_per_dev: int = 32_768, device_counts=(1, 2, 4, 8), device=None) -> list:
    """The scaling harness: the distributed step at several dp sizes with
    FIXED rows a shard (weak scaling), efficiency = T(1) / T(n). On one card
    the shards are logical and run one after another, so this measures the
    exchange's and the merge's cost, not scaling across chips."""
    from ..parallel.mesh import make_mesh
    from ..parallel.pipeline import example_inputs, make_distributed_query_step

    results = []
    t1 = None
    for ndev in device_counts:
        mesh = make_mesh(ndev, device=device)
        rows = rows_per_dev * ndev
        step = make_distributed_query_step(mesh, n_groups=64, cap=rows_per_dev)
        params, x, keys = example_inputs(mesh, rows, in_dim=32, out_dim=16, n_groups=64)
        dt, out = _time(lambda: step(params, x, keys), mesh.local_devices[0])
        if t1 is None:
            t1 = dt
        results.append(BenchResult(
            f"scaling_dp{ndev}", rows / dt, rows, dt,
            detail=f"weak-scaling efficiency {t1 / dt:.2f}; {_mesh_detail(mesh)}", output=out))
    return results


ALL_BENCHMARKS = {
    "config1": bench_config1_linear,
    "config2": bench_config2_mlp,
    "config3": bench_config3_join,
    "config4": bench_config4_gbt,
    "config5": bench_config5_distributed,
    "scaling": bench_scaling,
}


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    names = [a for a in argv if not a.startswith("-")] or list(ALL_BENCHMARKS)
    for name in names:
        out = ALL_BENCHMARKS[name]()
        for res in out if isinstance(out, list) else [out]:
            print(f"{res.name}: {res.rows_per_s:,.0f} rows/s "
                  f"({res.rows:,} rows, {res.seconds * 1e3:.2f} ms/iter) {res.detail}")


if __name__ == "__main__":
    main()
