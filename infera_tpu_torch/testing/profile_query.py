"""Profiling harness for the row-major fused query (kernel K7a), and the
profiling kernels K8a and K8b (counterpart of
``infera_tpu/testing/profile_query.py``).

It separates the parts of K7a's time on the card:

  * ``iters``    — ms per call against the number of calls queued between two
    synchronisations: what a synchronisation costs, spread over the calls.
  * ``rows``     — time against the row count at fixed iters. Fitting
    t = a + b*rows separates the per-call cost (a) from the per-row cost (b).
  * ``empty``    — kernel K8a: K7a's grid and tile load with only a column sum
    behind it, the floor of the load loop per 64-row tile.
  * ``tiles``    — the TPU kernel's tile sweep. The port's kernels take no tile
    size (64-row tiles are a compile-time constant): one ``error`` line a tile.
  * ``chain``    — ``k`` K7a calls captured in one CUDA graph and replayed:
    device time with no per-launch cost.
  * ``variants`` — a 4096² bf16 matmul against the card's bf16 peak checks the
    timer, then kernel K8b splits K7a bf16 into stages: scan → first layer →
    all layers → a tail without argmax → the full query.
  * ``col``      — K7a (row-major) against K1 (feature-major), both in bf16.

Each experiment prints one JSON line per measurement, with the keys of
``infera_tpu``'s, and returns the lines. Every experiment runs on the port's
device (the card unless the caller asks for the CPU; on the CPU each kernel
wrapper runs its plain version). Usage:
``python -m infera_tpu_torch.testing.profile_query <iters|rows|empty|tiles|chain|variants|col>``

K8a (``empty_grid_scan``) and K8b (``query_stage``) are CUDA C++ in
``csrc/profile_query.cu``; each wrapper keeps a launch count and runs its
plain version for a CPU tensor only. ``trace_device_summary`` and
``top_device_ops`` read a trace of ``observability.trace``.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import get_device
from ..ops import _kernels
from ..ops import fused_query as fq
from ..ops.fused_mlp import SMEM_LIMIT, TILE_ROWS
from .benchmarks import device_peaks

IN_DIM, HIDDEN, OUT_DIM = 32, (128, 128), 16
PROFILE_DIMS = (IN_DIM, *HIDDEN, OUT_DIM)
VARIANTS = ("scan", "mm1", "mm_all", "tail_nomax", "full")
OUT_WIDTH = 128           # K8b's output, the TPU kernel's acc_ref [1, 128]
JAX_TILES = (4096, 8192, 16384, 32768)
TILE_ERROR = ("not a knob of the port: its kernels run 64-row tiles (kTileRows, a "
              "compile-time constant)")
CALIB_N = 4096            # the timer check's bf16 matmul is [CALIB_N, CALIB_N]^2
# bytes of K8a's and K8b's block scratch: acc [128] f64, mx [64] f32
_SCRATCH = OUT_WIDTH * 8 + TILE_ROWS * 4


def _params(seed=0):
    rng = np.random.default_rng(seed)
    dims = [IN_DIM, *HIDDEN, OUT_DIM]
    out = []
    for i in range(len(dims) - 1):
        w = (rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
             * np.float32(1.0 / np.sqrt(dims[i])))
        b = rng.standard_normal(dims[i + 1]).astype(np.float32) * np.float32(0.1)
        out.append((w, b))
    return out


# --------------------------------------------------------------------------- K8a, K8b


@dataclass(frozen=True)
class StageWeights:
    """K8b's weights on one device: ``full``, the bf16 query weights K7a
    takes, and ``first``, layer 1 alone (mm1's blob: the kernels' blob keeps
    every bias after every weight). The stage kernel reads their
    ``mma_blob``."""

    full: fq.QueryWeights
    first: fq.QueryWeights


def stage_weights(params, device) -> StageWeights:
    """Carry ``_params()``-style numpy weights to ``device`` for K8b."""
    return StageWeights(full=fq.params_from_numpy(params, device, torch.bfloat16),
                        first=fq.params_from_numpy(params[:1], device, torch.bfloat16))


def _stage_layers(weights: StageWeights, variant: str):
    return {"scan": None, "mm1": weights.first}.get(variant, weights.full)


def _tile_column_sums(h: torch.Tensor) -> torch.Tensor:
    """h [N, W] f32: the column sums of each 64-row tile in f32, the tiles
    added in f64; f32 [W]."""
    n, w = h.shape
    pad = torch.zeros(((-n) % TILE_ROWS, w), dtype=h.dtype, device=h.device)
    tiles = torch.cat([h, pad]).reshape(-1, TILE_ROWS, w).sum(1)
    return tiles.double().sum(0).float()


def empty_grid_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """K8a's function in plain PyTorch: the f32 column sums of x [N, d0]."""
    return _tile_column_sums(x.float())


def query_stage_plain(weights: StageWeights, x: torch.Tensor, variant: str) -> torch.Tensor:
    """K8b's function in plain PyTorch over the bf16 table x [N, d0]: the
    layers of K7a's plain version (hidden activations rounded to bf16), then
    the stage's sums into out [128] f32."""
    out = torch.zeros(OUT_WIDTH, dtype=torch.float32, device=x.device)
    if variant == "scan":
        out[:x.shape[1]] = empty_grid_scan_plain(x)
        return out
    h = fq.mlp_scores_plain(_stage_layers(weights, variant), x.T)   # [C, N]
    c = h.shape[0]
    if variant in ("mm1", "mm_all"):
        out[:c] = _tile_column_sums(h.T)
    elif variant == "tail_nomax":
        hit = (h == h.amax(0)) & (h[0] > 0)
        out[:c] = hit.sum(1).float()
        out[c:2 * c] = (hit.double() * h[0].double()).sum(1).float()
    else:
        counts, sums = fq.query_tail_plain(h)
        out[:c] = counts.float()
        out[c:2 * c] = sums
    return out


def _check_table(x: torch.Tensor, d0: int | None) -> None:
    _kernels.require_cuda(x, "table")
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[0] < 1 or \
            not 1 <= x.shape[1] <= OUT_WIDTH or d0 not in (None, x.shape[1]):
        want = f"[N >= 1, {d0 or f'd0 <= {OUT_WIDTH}'}]"
        raise ValueError(f"table must be {want} bfloat16, got {x.dtype} {tuple(x.shape)}")


def _k7a_blocks(x: torch.Tensor, dims) -> int:
    """K7a bf16's persistent grid for an MLP of ``dims`` over x: the
    profiling kernels run the same blocks, so they see K7a's occupancy."""
    return fq.bf16_grid(x, dims, row_major=True)[0]


def _stage_smem_bytes(dims) -> int:
    """K7a bf16's shared memory for ``dims`` over a bf16 table (its ring
    included) and the profiling scratch."""
    return fq.rows_query_smem_bytes_bf16(dims, 2, _SCRATCH) + _SCRATCH


def ring_stages(dims) -> int:
    """The ring's buffers of the stage kernel for the stage's ``dims``."""
    return fq.ring_stages_bf16(dims, 2, _SCRATCH)


def stage_resident_blocks(device: torch.device, smem: int) -> int:
    """Blocks of the stage kernel resident on one SM at ``smem`` bytes of
    dynamic shared memory."""
    return _kernels.resident_blocks(device, "profile_query", "infera_profile_stage_occupancy",
                                    smem)


def _launch_stage(x: torch.Tensor, variant: str, dims, blob: torch.Tensor, grid_dims):
    """Launch the stage kernel over a checked table: the stage's layers
    ``dims`` (``(d0,)`` for scan) and ``blob`` (``pack_mma_blob``'s), on
    K7a bf16's grid for an MLP of ``grid_dims``; returns out [128] f32."""
    smem = _stage_smem_bytes(dims)
    if smem > SMEM_LIMIT or len(dims) - 1 > fq.MAX_LAYERS:
        raise ValueError(f"MLP {dims} exceeds the kernel's shared memory or layer count")
    n_blocks = _k7a_blocks(x, grid_dims)
    part = torch.empty((n_blocks, OUT_WIDTH), dtype=torch.float64, device=x.device)
    out = torch.empty(OUT_WIDTH, dtype=torch.float32, device=x.device)
    lib = _kernels.load("profile_query")
    rc = lib.infera_profile_stage(
        VARIANTS.index(variant), x.data_ptr(), x.shape[0], blob.data_ptr(), blob.numel(),
        _kernels.int_array(dims), len(dims) - 1, ring_stages(dims), part.data_ptr(),
        out.data_ptr(), n_blocks, smem, _kernels.stream_handle(x.device))
    _kernels.check(lib, rc, "infera_profile_stage")
    return out


def empty_grid_scan(x: torch.Tensor) -> torch.Tensor:
    """K8a over the bf16 table ``x [N, d0]`` (d0 <= 128): the stage kernel's
    scan on K7a's grid for the profiling MLP; f32 column sums [d0]."""
    if x.device.type == "cpu":
        return empty_grid_scan_plain(x)
    _check_table(x, None)
    d0 = x.shape[1]
    out = _launch_stage(x, "scan", (d0,), torch.empty(0, dtype=torch.int32, device=x.device),
                        (d0, *PROFILE_DIMS[1:]))
    empty_grid_scan.launches += 1
    return out[:d0]


empty_grid_scan.launches = 0


def query_stage(weights: StageWeights, x: torch.Tensor, variant: str) -> torch.Tensor:
    """K8b: stage ``variant`` of K7a bf16 over the bf16 table ``x [N, d0]``,
    on K7a's grid; returns out [128] f32 (see ``csrc/profile_query.cu``)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if x.device.type == "cpu":
        return query_stage_plain(weights, x, variant)
    full_dims = weights.full.dims
    _check_table(x, full_dims[0])
    if weights.full.mma_blob.device != x.device:
        raise ValueError(f"weights on {weights.full.mma_blob.device}, table on {x.device}")
    layers = _stage_layers(weights, variant)
    dims = layers.dims if layers is not None else full_dims[:1]
    if dims[-1] * (2 if variant in ("tail_nomax", "full") else 1) > OUT_WIDTH:
        raise ValueError(f"MLP {full_dims}: stage {variant} does not fit out [{OUT_WIDTH}]")
    blob = layers.mma_blob if layers is not None else weights.full.mma_blob[:0]
    out = _launch_stage(x, variant, dims, blob, full_dims)
    query_stage.launches[variant] += 1
    return out


query_stage.launches = dict.fromkeys(VARIANTS, 0)


# --------------------------------------------------------------------------- traces


_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_device_summary(path) -> dict:
    """Read a Chrome trace of ``observability.trace``: the window (first to
    last event, µs), the union of the device's intervals (kernels, copies,
    sets) within it, the idle share 1 - busy / window (None when the trace
    holds no device activity), and the count of each ``annotate`` span."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    intervals = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                       if e.get("cat") in _DEVICE_CATEGORIES)
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in intervals:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    spans: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    window = end - start
    return {"window_us": window, "device_busy_us": busy, "device_events": len(intervals),
            "idle_share": 1.0 - busy / window if intervals and window > 0 else None,
            "spans": spans}


def top_device_ops(prof, k: int = 5) -> list:
    """The ``k`` operations with the most device time in a profiler's
    ``key_averages()``: [(name, calls, device ms)], self time, so a kernel
    counts once; ``annotate`` spans, which hold operations, are left out."""
    rows = []
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key, e.count, us / 1e3))
    return sorted(rows, key=lambda r: -r[2])[:k]


# --------------------------------------------------------------------------- experiments


def _emit(lines: list, **kw) -> None:
    print(json.dumps(kw), flush=True)
    lines.append(kw)


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else get_device()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _setup(rows: int, device: torch.device, dtype=torch.bfloat16):
    """(bf16 query weights of ``_params()``, a seeded table [rows, 32] made on
    the device)."""
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((rows, IN_DIM), generator=gen, device=device).to(dtype)
    return fq.params_from_numpy(_params(), device, torch.bfloat16), x


def _time_queued(fn, iters: int, device: torch.device) -> float:
    """Seconds per call of ``fn()`` over ``iters`` calls queued back to back,
    on the host clock between two synchronisations, after two warm-up calls."""
    fn()
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def exp_iters(rows=1 << 20, device=None):
    device = _device(device)
    w, x = _setup(rows, device)
    lines = []
    for iters in (1, 5, 10, 50, 200):
        dt = _time_queued(lambda: fq.fused_mlp_query(w, x), iters, device)
        _emit(lines, exp="iters", iters=iters, rows=rows, ms_per_iter=dt * 1e3,
              rows_per_s=rows / dt)
    return lines


def exp_rows(row_counts=(1 << 18, 1 << 20, 1 << 22, 1 << 23), device=None):
    device = _device(device)
    lines = []
    for rows in row_counts:
        w, x = _setup(rows, device)
        dt = _time_queued(lambda: fq.fused_mlp_query(w, x), 50, device)
        _emit(lines, exp="rows", rows=rows, ms=dt * 1e3, rows_per_s=rows / dt)
        del x
    return lines


def exp_empty(rows=1 << 20, device=None):
    """K8a: K7a's grid and tile load, near-zero compute."""
    device = _device(device)
    _, x = _setup(rows, device)
    lines = []
    for iters in (10, 50):
        dt = _time_queued(lambda: empty_grid_scan(x), iters, device)
        _emit(lines, exp="empty", rows=rows, tile_n=TILE_ROWS, iters=iters,
              ms_per_iter=dt * 1e3, us_per_grid_step=dt * 1e6 / -(-rows // TILE_ROWS))
    return lines


def exp_tiles(rows=1 << 20, device=None):
    lines = []
    for tile_n in JAX_TILES:
        _emit(lines, exp="tiles", tile_n=tile_n, rows=rows, error=TILE_ERROR)
    return lines


def exp_chain(rows=1 << 20, k=20, device=None):
    """``k`` K7a calls captured in one CUDA graph, replayed: device time with
    no per-launch cost. On the CPU the calls run one after another
    (``graph`` false)."""
    device = _device(device)
    w, x = _setup(rows, device)
    lines = []
    if device.type != "cuda":
        dt = _time_queued(lambda: fq.fused_mlp_query(w, x), k, device)
        _emit(lines, exp="chain", rows=rows, k=k, ms_per_iter=dt * 1e3, rows_per_s=rows / dt,
              graph=False)
        return lines
    fq.fused_mlp_query(w, x)   # builds and loads the library outside the capture
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(k):
                fq.fused_mlp_query(w, x)
    except RuntimeError as e:
        _emit(lines, exp="chain", rows=rows, k=k, error=f"{type(e).__name__}: {e}"[:200])
        return lines
    graph.replay()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / k
    _emit(lines, exp="chain", rows=rows, k=k, ms_per_iter=dt * 1e3, rows_per_s=rows / dt,
          graph=True)
    return lines


def exp_variants(rows=1 << 20, device=None):
    """The timer check, then K7a bf16's time split by K8b's stages."""
    device = _device(device)
    gen = torch.Generator(device=device).manual_seed(2)
    a = torch.randn((CALIB_N, CALIB_N), generator=gen, device=device).to(torch.bfloat16)
    lines = []
    dt = _time_queued(lambda: torch.matmul(a, a), 50, device)
    peaks = device_peaks(device)
    _emit(lines, exp="variants", variant=f"calib_matmul{CALIB_N}", ms_per_iter=dt * 1e3,
          expected_ms_floor=2 * CALIB_N ** 3 / peaks["bf16"] * 1e3 if peaks else None)
    del a
    _, x = _setup(rows, device)
    weights = stage_weights(_params(), device)
    for variant in VARIANTS:
        dt = _time_queued(lambda: query_stage(weights, x, variant), 100, device)
        _emit(lines, exp="variants", variant=variant, rows=rows, ms_per_iter=dt * 1e3,
              rows_per_s=rows / dt)
    return lines


def exp_col(rows=1 << 20, device=None):
    """K7a over a row-major bf16 table against K1 over its feature-major
    copy, both in bf16."""
    device = _device(device)
    w, x_bf = _setup(rows, device)
    xc = x_bf.T.contiguous()
    lines = []
    for variant, fn in ((f"row_major_{TILE_ROWS}", lambda: fq.fused_mlp_query(w, x_bf)),
                        (f"columnar_{TILE_ROWS}", lambda: fq.fused_mlp_query_columnar(w, xc))):
        dt = _time_queued(fn, 100, device)
        _emit(lines, exp="col", variant=variant, ms_per_iter=dt * 1e3, rows_per_s=rows / dt)
    for tile in JAX_TILES:
        _emit(lines, exp="col", variant=f"columnar_{tile}", error=TILE_ERROR)
    return lines


EXPS = {"iters": exp_iters, "rows": exp_rows, "empty": exp_empty, "tiles": exp_tiles,
        "chain": exp_chain, "variants": exp_variants, "col": exp_col}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "iters"
    t0 = time.perf_counter()
    EXPS[name]()
    _emit([], exp=name, done=True, wall_s=round(time.perf_counter() - t0, 1))


if __name__ == "__main__":
    main()
