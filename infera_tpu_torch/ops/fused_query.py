"""K1, K3, K7a and K7b: the fused inference query as one kernel each.

Counterpart of ``infera_tpu/ops/pallas_query.py``. Over a table of N rows the
query

    scan -> ReLU MLP -> argmax over classes (first index on ties)
    -> keep rows with score0 > 0 -> per class: count and sum of score0

runs in ``csrc/fused_query.cu``:

- K1, ``fused_mlp_query_columnar``: a feature-major table ``x [d0, N]``
  (stacked columns) in f32, or bf16 operands (the input and every ReLU output
  rounded to bf16) with f32 accumulation; biases, ReLU and the tail in f32.
- K7a, ``fused_mlp_query``: K1's function over a row-major table
  ``x [N, d0]``.
- K3, ``fused_mlp_query_columnar_int8_shift``: an int8 table ``[d0, N]``,
  int8 x int8 -> int32 layers; hidden layers requantize with integer shifts,
  ``q = clip(((y << sl) + bias_pre) >> sr, 0, 127)``; the last layer computes
  ``y * comb + bias`` in f32. Its weights come from ``quantize_mlp_shift``.
- K7b, ``fused_mlp_query_columnar_int8``: K3 with the static-calibration
  epilogue ``t = f32(y) * comb + bq`` (two roundings); hidden layers
  requantize as ``q = clip(rint(t), 0, 127)`` (ReLU folded into the clip), the
  last layer keeps ``t``. Its weights come from ``quantize_mlp_static``.

K1 and K7a in bf16 run their layers on the tensor cores (``mma.sync``, with
the weights packed by ``pack_mma_blob``); in f32 on the f32 cores, two
halves of 256 threads a block over one copy of the weights where they fit
(``query_halves``, ``rows_query_layout``). K3 and
K7b run theirs on the tensor cores in int8 (``mma.sync`` m16n8k32, with the
weights packed by ``_int8_blob``) on a grid sized by their occupancy.

All return ``(counts [C] int64, sums [C] f32)``: the counts stay integers,
where the TPU kernel returned them as f32. Each wrapper launches its kernel
for a CUDA tensor and runs its plain version for a CPU tensor; it raises for
anything else. Any N >= 1 is accepted: the kernel masks the ragged last tile.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _kernels
from .fused_mlp import (
    ACT_STRIDE,
    MAX_HALVES,
    MAX_LAYERS,
    SMEM_LIMIT,
    TILE_ROWS,
    grid_for,
    pack_f32_blob,
    pad8,
)

_COMPUTE = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _tail_bytes(n_classes: int) -> int:
    return pad8(n_classes) * 16 + TILE_ROWS * 8


def pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def mma_stride(k: int) -> int:
    """bf16 values of a row of a tensor-core operand (``csrc/mma_tile.cuh``):
    k padded to 16, and 8 more, so that a row is an odd number of 16-byte
    words and ldmatrix's 8 row addresses fall on different banks."""
    return pad16(k) + 8


def pad32(n: int) -> int:
    return (n + 31) // 32 * 32


def imma_astride(k: int) -> int:
    """Bytes of a row of an int8 A tile (``csrc/imma_tile.cuh``): k padded
    to 32 with zeros, and 16 more, so that a row is an odd number of 16-byte
    words and ldmatrix's 8 row addresses fall on different banks."""
    return pad32(k) + 16


def imma_wstride(k: int) -> int:
    """Bytes of a row of an int8 W^T: the odd number of 16-byte words that
    holds k bytes."""
    return 16 * (-(-k // 16) | 1)


# --------------------------------------------------------------------------- weights


@dataclass(frozen=True)
class QueryWeights:
    """K1's weights on one device: ``layers`` = [(Wt [dout, din] in the
    compute dtype, b [dout, 1] f32), ...], as the TPU kernel takes them;
    ``blob``, the same numbers in the f32 kernels' shared-memory layout (in
    bf16 mode they hold bf16-rounded values); and in bf16 mode ``mma_blob``,
    the tensor-core kernels' layout (``pack_mma_blob``)."""

    compute_dtype: torch.dtype
    dims: tuple
    layers: list
    blob: torch.Tensor
    mma_blob: torch.Tensor | None = None


def pack_mma_blob(wts, biases) -> np.ndarray:
    """The bf16 kernels' weight blob (``csrc/mma_tile.cuh``) from each
    layer's bf16 Wt [dout, din] and f32 b [dout] (torch tensors): per layer
    Wt as bf16 [pad8(dout)][mma_stride(din)], then per layer b as f32
    [pad8(dout)], all zero-padded; int32 words."""
    parts = []
    for wt in wts:
        dout, din = wt.shape
        block = np.zeros((pad8(dout), mma_stride(din)), np.uint16)
        block[:dout, :din] = wt.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16)
        parts.append(block.reshape(-1))
    for b in biases:
        row = np.zeros(pad8(b.numel()), np.float32)
        row[:b.numel()] = b.detach().cpu().float().reshape(-1).numpy()
        parts.append(row.view(np.uint16))
    return np.concatenate(parts).view(np.int32)


def params_from_numpy(params, device, compute_dtype=torch.float32) -> QueryWeights:
    """Carry the JAX package's parameter list ``[(w [din, dout], b [dout])]``
    (numpy, as ``bench._build_params`` makes it) to ``device``."""
    if compute_dtype not in _COMPUTE:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    layers = []
    for w, b in params:
        wt = torch.as_tensor(np.ascontiguousarray(np.asarray(w, np.float32).T), device=device)
        b2 = torch.as_tensor(np.asarray(b, np.float32).reshape(-1, 1), device=device)
        layers.append((wt.to(compute_dtype), b2))
    dims = (layers[0][0].shape[1],) + tuple(wt.shape[0] for wt, _ in layers)
    blob = pack_f32_blob([wt.float().T for wt, _ in layers], [b for _, b in layers])
    mma_blob = None
    if compute_dtype == torch.bfloat16:
        mma_blob = torch.as_tensor(pack_mma_blob(*zip(*layers)), device=device)
    return QueryWeights(compute_dtype=compute_dtype, dims=dims, layers=layers, blob=blob,
                        mma_blob=mma_blob)


@dataclass(frozen=True)
class ShiftWeights:
    """K3's weights on one device: ``layers`` holds ``quantize_mlp_shift``'s
    qparams as tensors (hidden: wq int8 [dout, din], sl, sr, bias_pre int32
    [dout, 1]; last: wq, comb f32, zeros int32, bias f32), ``blob`` the int32
    words of the kernel's layout, and ``need_sl`` whether each hidden layer
    has a left shift (the TPU kernel's static ``need_sl``)."""

    dims: tuple
    layers: list
    blob: torch.Tensor
    need_sl: tuple


def _int8_blob(wqs, epilogue_rows, device) -> tuple:
    """(dims, blob) of an int8 kernel (``csrc/imma_tile.cuh``) from each
    layer's weights wq int8 [dout, din] and three epilogue rows: per layer
    wq as int8 [pad8(dout)][imma_wstride(din)], zero-padded, then per layer
    its epilogue rows as int32 [3][pad8(dout)]; int32 words."""
    parts = []
    for wq in wqs:
        dout, din = wq.shape
        block = np.zeros((pad8(dout), imma_wstride(din)), np.int8)
        block[:dout, :din] = wq
        parts.append(block.reshape(-1).view(np.int32))
    for wq, rows in zip(wqs, epilogue_rows):
        epi = np.zeros((3, pad8(wq.shape[0])), np.int32)
        for r, row in enumerate(rows):
            epi[r, :wq.shape[0]] = row
        parts.append(epi.reshape(-1))
    dims = (wqs[0].shape[1],) + tuple(wq.shape[0] for wq in wqs)
    return dims, torch.as_tensor(np.concatenate(parts), device=device)


def qparams_from_numpy(qparams, device) -> ShiftWeights:
    """Carry ``quantize_mlp_shift``'s qparams to ``device``."""
    n_layers = len(qparams)
    layers = []
    rows = []
    for li, (wq, a1, a2, a3) in enumerate(qparams):
        last = li == n_layers - 1
        wq = np.asarray(wq, np.int8)
        a1 = np.asarray(a1, np.float32 if last else np.int32).reshape(-1, 1)
        a2 = np.asarray(a2, np.int32).reshape(-1, 1)
        a3 = np.asarray(a3, np.float32 if last else np.int32).reshape(-1, 1)
        layers.append(tuple(torch.as_tensor(a, device=device) for a in (wq, a1, a2, a3)))
        rows.append((a1.reshape(-1).view(np.int32),      # sl, or comb's float bits
                     0 if last else a2.reshape(-1),      # sr
                     a3.reshape(-1).view(np.int32)))     # bias_pre, or bias's float bits
    dims, blob = _int8_blob([np.asarray(qp[0], np.int8) for qp in qparams], rows, device)
    need_sl = tuple(bool(np.asarray(qp[1]).max() > 0) for qp in qparams[:-1]) + (False,)
    return ShiftWeights(dims=dims, layers=layers, blob=blob, need_sl=need_sl)


@dataclass(frozen=True)
class StaticInt8Weights:
    """K7b's weights on one device: ``layers`` holds ``quantize_mlp_static``'s
    qparams as tensors, [(wqT int8 [dout, din], comb f32 [dout, 1], bq f32
    [dout, 1]), ...], and ``blob`` the int32 words of the kernel's layout
    (K3's, with the epilogue rows (comb, 0, bq) as float bits)."""

    dims: tuple
    layers: list
    blob: torch.Tensor


def qparams_static_from_numpy(qparams, device) -> StaticInt8Weights:
    """Carry ``quantize_mlp_static``'s qparams to ``device``."""
    layers = []
    rows = []
    for wq, comb, bq in qparams:
        arrs = (np.asarray(wq, np.int8), np.asarray(comb, np.float32).reshape(-1, 1),
                np.asarray(bq, np.float32).reshape(-1, 1))
        layers.append(tuple(torch.as_tensor(a, device=device) for a in arrs))
        rows.append((arrs[1].reshape(-1).view(np.int32), 0, arrs[2].reshape(-1).view(np.int32)))
    dims, blob = _int8_blob([np.asarray(qp[0], np.int8) for qp in qparams], rows, device)
    return StaticInt8Weights(dims=dims, layers=layers, blob=blob)


# --------------------------------------------------------------------------- plain versions


def query_tail_plain(h: torch.Tensor):
    """argmax / filter / per-class count and sum over scores h [C, N] f32."""
    n_classes = h.shape[0]
    pred = torch.argmax(h, dim=0)
    score0 = h[0]
    sel = score0 > 0
    cls = pred[sel]
    counts = torch.bincount(cls, minlength=n_classes)
    sums = torch.zeros(n_classes, dtype=torch.float64, device=h.device)
    sums.index_add_(0, cls, score0[sel].double())
    return counts, sums.float()


def mlp_scores_plain(weights: QueryWeights, xc: torch.Tensor) -> torch.Tensor:
    """The layer stack of K1 in plain PyTorch over ``xc [d0, N]``: the scores
    [C, N] f32. bf16 mode multiplies bf16-rounded operands in f32, which is
    exact, and accumulates in f32."""
    bf16 = weights.compute_dtype == torch.bfloat16
    h = xc.to(weights.compute_dtype).float()
    last = len(weights.layers) - 1
    for i, (wt, b) in enumerate(weights.layers):
        h = wt.float() @ h + b
        if i < last:
            h = torch.relu(h)
            if bf16:
                h = h.to(torch.bfloat16).float()
    return h


def fused_mlp_query_columnar_plain(weights: QueryWeights, xc: torch.Tensor):
    """K1's function in plain PyTorch."""
    return query_tail_plain(mlp_scores_plain(weights, xc))


def fused_mlp_query_columnar_int8_shift_plain(weights: ShiftWeights, xq: torch.Tensor):
    """K3's function in plain PyTorch. The int8 products are summed in f64,
    which is exact at these sizes (|y| <= 127 * 127 * din < 2**53), then
    handled as int32 like the kernel's accumulator."""
    q = xq
    last = len(weights.layers) - 1
    h = None
    for i, (wq, a1, a2, a3) in enumerate(weights.layers):
        y = (wq.double() @ q.double()).to(torch.int32)
        if i < last:
            if weights.need_sl[i]:
                y = torch.bitwise_left_shift(y, a1)
            y = y + a3
            q = torch.clamp(torch.bitwise_right_shift(y, a2.clamp(max=31)), 0, 127)
        else:
            h = y.float() * a1 + a3
    return query_tail_plain(h)


def fused_mlp_query_plain(weights: QueryWeights, x: torch.Tensor):
    """K7a's function in plain PyTorch: K1's over the transposed table."""
    return fused_mlp_query_columnar_plain(weights, x.T)


def fused_mlp_query_columnar_int8_plain(weights: StaticInt8Weights, xq: torch.Tensor):
    """K7b's function in plain PyTorch. The int8 products are summed in f64,
    exact, and are exact in f32 too (|y| <= 127 * 127 * din < 2**24); the
    epilogue is a separate f32 multiply and add, then ``torch.round``, which
    rounds half to even as ``jnp.rint`` does."""
    q = xq
    last = len(weights.layers) - 1
    h = None
    for i, (wq, comb, bq) in enumerate(weights.layers):
        t = (wq.double() @ q.double()).float() * comb + bq
        if i < last:
            q = torch.clamp(torch.round(t), 0, 127)
        else:
            h = t
    return query_tail_plain(h)


# --------------------------------------------------------------------------- kernels


def _partials(n_blocks: int, n_classes: int, device):
    return (torch.empty((n_blocks, n_classes), dtype=torch.int64, device=device),
            torch.empty((n_blocks, n_classes), dtype=torch.float64, device=device),
            torch.empty(n_classes, dtype=torch.int64, device=device),
            torch.empty(n_classes, dtype=torch.float32, device=device))


def _check_table(x: torch.Tensor, dtypes, d0: int, blob: torch.Tensor, dims,
                 row_major: bool = False) -> None:
    _kernels.require_cuda(x, "table")
    want = f"[N >= 1, {d0}]" if row_major else f"[{d0}, N >= 1]"
    feat, rows = (1, 0) if row_major else (0, 1)
    if x.dtype not in dtypes or x.dim() != 2 or x.shape[feat] != d0 or x.shape[rows] < 1:
        raise ValueError(f"table must be {want} of {dtypes}, got {x.dtype} {tuple(x.shape)}")
    if blob.device != x.device:
        raise ValueError(f"weights on {blob.device}, table on {x.device}")
    if not 1 <= len(dims) - 1 <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1 to {MAX_LAYERS} layers, got {len(dims) - 1}")


def query_smem_bytes(dims, halves: int = 1) -> int:
    """Shared memory of K1 in f32 at ``halves`` tile groups a block:
    weights and biases at f32 once, and each half's tail scratch and two
    64-row activation tiles at the widest width."""
    widest = max(pad8(d) for d in dims)
    blob = sum(dims[i] * pad8(dims[i + 1]) + pad8(dims[i + 1]) for i in range(len(dims) - 1))
    return 4 * blob + halves * (_tail_bytes(dims[-1]) + 8 * widest * ACT_STRIDE)


def query_halves(dims) -> int:
    """Tile groups a block of K1 in f32 runs for an MLP of ``dims``: two
    where two halves fit one block's 227 KB (232,000 bytes at the bench
    MLP), else one."""
    return MAX_HALVES if query_smem_bytes(dims, MAX_HALVES) <= SMEM_LIMIT else 1


def mma_blob_bytes(dims) -> int:
    """Bytes of ``pack_mma_blob``'s blob for an MLP of ``dims``."""
    return sum(2 * pad8(dims[i + 1]) * mma_stride(dims[i]) + 4 * pad8(dims[i + 1])
               for i in range(len(dims) - 1))


def mma_tile_bytes(dims) -> tuple:
    """(act0, act1) bytes of the bf16 kernels: an A tile [64][mma_stride]
    at the widest layer input (``dims[0]`` for a stage with no layer), and
    the larger of that and the scores [pad8(C)][68] f32, which lie over it."""
    a = 2 * TILE_ROWS * mma_stride(max(dims[:max(1, len(dims) - 1)]))
    return a, max(a, 4 * pad8(dims[-1]) * ACT_STRIDE)


def query_smem_bytes_bf16(dims) -> int:
    """Shared memory of K1 in bf16 (``csrc/mma_tile.cuh``): bf16 weights
    and f32 biases, the tail's scratch, act0 and act1."""
    return mma_blob_bytes(dims) + _tail_bytes(dims[-1]) + sum(mma_tile_bytes(dims))


# K7a's ring of row-major tiles (csrc/query_tile.cuh). f32 mode at one half
# a block (an MLP whose two halves do not fit, ``rows_query_layout``): enough
# buffers that about 20 KB of the table is in flight on each SM, at most 8.
# bf16 mode: two buffers, which hide the load at two blocks an SM (the ring
# sweep of PERF.md), within half an SM's shared memory where they fit there.
RING_IN_FLIGHT = 20 * 1024
MAX_RING_STAGES = 8
BF16_RING_STAGES = 2
# one block's share of an SM's 228 KB when two blocks share it (1 KB of
# each block's is reserved)
TWO_BLOCK_SMEM = 233472 // 2 - 1024


def ring_stride(d0: int, itemsize: int) -> int:
    """Bytes of a ring buffer's row: d0 values padded to an odd number of
    16-byte words (so the transposition has no bank conflicts)."""
    return 16 * ((-(-d0 * itemsize // 16)) | 1)


def _fit_stages(stages: int, base: int, stage: int, limit: int) -> int:
    while stages > 0 and base + stages * stage > limit:
        stages -= 1
    return stages


def ring_stages(dims, itemsize: int, extra: int = 0) -> int:
    """Buffers of K7a's ring in f32 mode for an MLP of ``dims`` over a table
    of ``itemsize``-byte values, beside ``extra`` bytes of other scratch: 1 +
    the tiles that keep ``RING_IN_FLIGHT`` bytes in flight, fewer where
    the block's 227 KB would not hold them, 0 (the scalar load) where a row
    is not a whole number of 16-byte words or no buffer fits."""
    if dims[0] * itemsize % 16:
        return 0
    stage = TILE_ROWS * ring_stride(dims[0], itemsize)
    stages = min(MAX_RING_STAGES, 1 + -(-RING_IN_FLIGHT // (TILE_ROWS * dims[0] * itemsize)))
    return _fit_stages(stages, query_smem_bytes(dims) + extra, stage, SMEM_LIMIT)


def ring_stages_bf16(dims, itemsize: int, extra: int = 0) -> int:
    """Buffers of K7a's ring in bf16 mode: ``BF16_RING_STAGES``, fewer
    where they would push the block past ``TWO_BLOCK_SMEM``; where not one
    fits there, as many of them as the block's 227 KB holds. 0 where a row
    is not a whole number of 16-byte words."""
    if dims[0] * itemsize % 16:
        return 0
    stage = TILE_ROWS * ring_stride(dims[0], itemsize)
    base = query_smem_bytes_bf16(dims) + extra
    return (_fit_stages(BF16_RING_STAGES, base, stage, TWO_BLOCK_SMEM)
            or _fit_stages(BF16_RING_STAGES, base, stage, SMEM_LIMIT))


def rows_query_smem_bytes(dims, itemsize: int = 4, extra: int = 0) -> int:
    """Shared memory of K7a in f32 over a table of ``itemsize``-byte values:
    K1's and the ring's buffers (``ring_stages``), each [64][ring_stride]
    bytes, beside ``extra`` bytes of other scratch (not counted)."""
    stages = ring_stages(dims, itemsize, extra)
    return query_smem_bytes(dims) + stages * TILE_ROWS * ring_stride(dims[0], itemsize)


def rows_query_layout(dims, itemsize: int = 4, halves: int | None = None) -> tuple:
    """(halves, ring buffers, shared-memory bytes) of K7a in f32 over a
    table of ``itemsize``-byte values: K1's two halves without the ring
    where they fit (the scalar load), else one half with its ring;
    ``halves`` asks for a launch shape."""
    if (halves or query_halves(dims)) == 2:
        return 2, 0, query_smem_bytes(dims, 2)
    return 1, ring_stages(dims, itemsize), rows_query_smem_bytes(dims, itemsize)


def rows_query_smem_bytes_bf16(dims, itemsize: int = 2, extra: int = 0) -> int:
    """Shared memory of K7a in bf16: K1's in bf16 and the ring's buffers
    (``ring_stages_bf16``), beside ``extra`` bytes (not counted)."""
    stages = ring_stages_bf16(dims, itemsize, extra)
    return query_smem_bytes_bf16(dims) + stages * TILE_ROWS * ring_stride(dims[0], itemsize)


def int8_act_bytes(dims) -> tuple:
    """(act0, act1) bytes of K3 and K7b: layer l reads act0 when the layer
    count less l is odd and act1 otherwise, each an A tile [64][imma_astride];
    the last layer writes the scores [pad8(C)][68] f32 into act1."""
    n_layers = len(dims) - 1
    act = [0, 4 * pad8(dims[-1]) * ACT_STRIDE]
    for l in range(n_layers):
        odd = (n_layers - l) % 2
        act[1 - odd] = max(act[1 - odd], TILE_ROWS * imma_astride(dims[l]))
    return act[0], act[1]


def _int8_core_bytes(dims) -> int:
    """K3's and K7b's shared memory without the load's ring: the int8
    weights and epilogue rows, the tail's scratch, act0 and act1."""
    blob = sum(pad8(dims[i + 1]) * (imma_wstride(dims[i]) + 12) for i in range(len(dims) - 1))
    return blob + _tail_bytes(dims[-1]) + sum(int8_act_bytes(dims))


# K3's and K7b's load (csrc/imma_tile.cuh): staging buffers of 17 words a
# feature, two of them (one tile copied ahead), fewer where they would push
# the block past its 227 KB
INT8_RING_STAGES = 2
STAGE_WORDS = 17


def int8_stage_bytes(d0: int) -> int:
    """Bytes of a staging buffer: 17 words a feature, whole 16-byte words."""
    return 16 * -(-4 * STAGE_WORDS * d0 // 16)


def int8_ring_stages(dims) -> int:
    """Staging buffers of K3's and K7b's load: ``INT8_RING_STAGES``, fewer
    where the block's 227 KB would not hold them (0: every tile takes the
    byte path)."""
    return _fit_stages(INT8_RING_STAGES, _int8_core_bytes(dims), int8_stage_bytes(dims[0]),
                       SMEM_LIMIT)


def int8_smem_bytes(dims) -> int:
    """Shared memory of K3 and of K7b (whose blob has K3's layout): the int8
    weights and epilogue rows, the tail's scratch, act0, act1 and the load's
    staging buffers."""
    return _int8_core_bytes(dims) + int8_ring_stages(dims) * int8_stage_bytes(dims[0])


def f32_grid(x: torch.Tensor, dims, row_major: bool, halves: int | None = None) -> tuple:
    """(blocks, halves, ring buffers, shared-memory bytes) of K1 or K7a in
    f32 over the table ``x``: ``query_halves`` (K1) or ``rows_query_layout``
    (K7a) tile groups a block, or ``halves`` (1 or 2) where given, on the
    blocks resident on the card at that shape, at most one half a tile."""
    if halves not in (None, 1, 2):
        raise ValueError(f"halves must be 1 or 2, got {halves}")
    if row_major:
        halves, stages, smem = rows_query_layout(dims, x.element_size(), halves)
    else:
        halves, stages = halves or query_halves(dims), 0
        smem = query_smem_bytes(dims, halves)
    if smem > SMEM_LIMIT:
        raise ValueError(f"MLP {dims} exceeds the kernel's shared-memory budget")
    per_sm = _kernels.resident_blocks(x.device, "fused_query", "infera_fused_query_f32_occupancy",
                                      int(x.dtype == torch.bfloat16), int(row_major), halves, smem)
    n = x.shape[0] if row_major else x.shape[1]
    return grid_for(x.device, n, halves, smem, per_sm), halves, stages, smem


def _launch_f32(weights: QueryWeights, x: torch.Tensor, row_major: bool,
                halves: int | None = None):
    """Launch K1 or K7a (``row_major``, with its ring's buffers) in f32
    over a checked table at ``f32_grid``'s shape (``halves`` asks for one;
    the tests and ``testing/ab_kernels.py`` compare the two); returns
    (counts, sums). The partials have a row a half."""
    dims = weights.dims
    n_blocks, halves, stages, smem = f32_grid(x, dims, row_major, halves)
    n = x.shape[0] if row_major else x.shape[1]
    part_cnt, part_sum, counts, sums = _partials(n_blocks * halves, dims[-1], x.device)
    entry, ring = (("infera_fused_query_rows", (stages,)) if row_major
                   else ("infera_fused_query_f32", ()))
    lib = _kernels.load("fused_query")
    rc = getattr(lib, entry)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), n, weights.blob.data_ptr(),
        weights.blob.numel(), _kernels.int_array(dims), len(dims) - 1,
        max(pad8(d) for d in dims), *ring, part_cnt.data_ptr(), part_sum.data_ptr(),
        counts.data_ptr(), sums.data_ptr(), n_blocks, halves, smem,
        _kernels.stream_handle(x.device))
    _kernels.check(lib, rc, entry)
    return counts, sums


def resident_blocks(device: torch.device, x_bf16: bool, row_major: bool, smem: int) -> int:
    """Blocks of the bf16 kernel (K1 or K7a over an f32 or bf16 table)
    resident on one SM at ``smem`` bytes of dynamic shared memory."""
    return _kernels.resident_blocks(device, "fused_query", "infera_fused_query_bf16_occupancy",
                                    int(x_bf16), int(row_major), smem)


def bf16_grid(x: torch.Tensor, dims, row_major: bool) -> tuple:
    """(blocks, shared-memory bytes) of K1 or K7a in bf16 over the table
    ``x``: the persistent grid is the blocks resident on the card, at most
    one a tile. The profiling kernels run K7a's."""
    x_bf16 = x.dtype == torch.bfloat16
    smem = (rows_query_smem_bytes_bf16(dims, x.element_size()) if row_major
            else query_smem_bytes_bf16(dims))
    if smem > SMEM_LIMIT:
        raise ValueError(f"MLP {dims} exceeds the kernel's shared-memory budget")
    n = x.shape[0] if row_major else x.shape[1]
    per_sm = resident_blocks(x.device, x_bf16, row_major, smem)
    return _kernels.grid_blocks(x.device, -(-n // TILE_ROWS), smem, per_sm), smem


def _launch_bf16(weights: QueryWeights, x: torch.Tensor, row_major: bool):
    """Launch K1 or K7a in bf16 (the tensor-core kernel) over a checked
    table; returns (counts, sums)."""
    dims = weights.dims
    n_blocks, smem = bf16_grid(x, dims, row_major)
    n = x.shape[0] if row_major else x.shape[1]
    stages = ring_stages_bf16(dims, x.element_size()) if row_major else 0
    part_cnt, part_sum, counts, sums = _partials(n_blocks, dims[-1], x.device)
    lib = _kernels.load("fused_query")
    rc = lib.infera_fused_query_bf16(
        x.data_ptr(), int(x.dtype == torch.bfloat16), int(row_major), n,
        weights.mma_blob.data_ptr(), weights.mma_blob.numel(), _kernels.int_array(dims),
        len(dims) - 1, stages, part_cnt.data_ptr(), part_sum.data_ptr(), counts.data_ptr(),
        sums.data_ptr(), n_blocks, smem, _kernels.stream_handle(x.device))
    _kernels.check(lib, rc, "infera_fused_query_bf16")
    return counts, sums


def fused_mlp_query_columnar(weights: QueryWeights, xc: torch.Tensor):
    """K1 over the table ``xc [d0, N]`` (f32 or bf16); ``weights`` from
    ``params_from_numpy`` fix the compute dtype. Returns (counts, sums)."""
    if xc.device.type == "cpu":
        return fused_mlp_query_columnar_plain(weights, xc)
    dims = weights.dims
    _check_table(xc, (torch.float32, torch.bfloat16), dims[0], weights.blob, dims)
    compute = _COMPUTE[weights.compute_dtype]
    if compute == "bf16":
        out = _launch_bf16(weights, xc, row_major=False)
    else:
        out = _launch_f32(weights, xc, False)
    fused_mlp_query_columnar.launches[compute] += 1
    return out


fused_mlp_query_columnar.launches = {"f32": 0, "bf16": 0}


def fused_mlp_query(weights: QueryWeights, x: torch.Tensor):
    """K7a over the row-major table ``x [N, d0]`` (f32 or bf16); ``weights``
    from ``params_from_numpy`` fix the compute dtype. Returns (counts, sums)."""
    if x.device.type == "cpu":
        return fused_mlp_query_plain(weights, x)
    dims = weights.dims
    _check_table(x, (torch.float32, torch.bfloat16), dims[0], weights.blob, dims, row_major=True)
    compute = _COMPUTE[weights.compute_dtype]
    if compute == "bf16":
        out = _launch_bf16(weights, x, row_major=True)
    else:
        out = _launch_f32(weights, x, True)
    fused_mlp_query.launches[compute] += 1
    return out


fused_mlp_query.launches = {"f32": 0, "bf16": 0}


def int8_resident_blocks(device: torch.device, static: bool, smem: int) -> int:
    """Blocks of K3 (``static`` False) or K7b resident on one SM at ``smem``
    bytes of dynamic shared memory."""
    return _kernels.resident_blocks(device, "fused_query", "infera_fused_query_int8_occupancy",
                                    int(static), smem)


def int8_grid(xq: torch.Tensor, dims, static: bool) -> tuple:
    """(blocks, shared-memory bytes) of K3 or K7b over the table ``xq``:
    the persistent grid is the blocks resident on the card, at most one a
    tile."""
    smem = int8_smem_bytes(dims)
    if smem > SMEM_LIMIT:
        raise ValueError(f"MLP {dims} exceeds the kernel's shared-memory budget")
    per_sm = int8_resident_blocks(xq.device, static, smem)
    return _kernels.grid_blocks(xq.device, -(-xq.shape[1] // TILE_ROWS), smem, per_sm), smem


def _launch_int8(weights, xq: torch.Tensor, static: bool, *extra):
    """Launch K3 (with its ``extra`` arguments) or K7b (``static``) over a
    checked int8 table; returns (counts, sums)."""
    dims = weights.dims
    n_blocks, smem = int8_grid(xq, dims, static)
    part_cnt, part_sum, counts, sums = _partials(n_blocks, dims[-1], xq.device)
    entry = "infera_fused_query_int8_static" if static else "infera_fused_query_int8_shift"
    lib = _kernels.load("fused_query")
    rc = getattr(lib, entry)(
        xq.data_ptr(), xq.shape[1], weights.blob.data_ptr(), weights.blob.numel(),
        _kernels.int_array(dims), len(dims) - 1, *extra, int8_ring_stages(dims),
        part_cnt.data_ptr(), part_sum.data_ptr(), counts.data_ptr(), sums.data_ptr(), n_blocks,
        smem, _kernels.stream_handle(xq.device))
    _kernels.check(lib, rc, entry)
    return counts, sums


def fused_mlp_query_columnar_int8_shift(weights: ShiftWeights, xq: torch.Tensor):
    """K3 over the int8 table ``xq [d0, N]``; ``weights`` from
    ``qparams_from_numpy``. Returns (counts, sums)."""
    if xq.device.type == "cpu":
        return fused_mlp_query_columnar_int8_shift_plain(weights, xq)
    _check_table(xq, (torch.int8,), weights.dims[0], weights.blob, weights.dims)
    need_sl_mask = sum(1 << i for i, flag in enumerate(weights.need_sl) if flag)
    out = _launch_int8(weights, xq, False, need_sl_mask)
    fused_mlp_query_columnar_int8_shift.launches += 1
    return out


fused_mlp_query_columnar_int8_shift.launches = 0

# K7b converts each layer's int32 sum to f32; that is exact while
# 127 * 127 * din < 2**24
MAX_STATIC_DIN = 1040


def fused_mlp_query_columnar_int8(weights: StaticInt8Weights, xq: torch.Tensor):
    """K7b over the int8 table ``xq [d0, N]``; ``weights`` from
    ``qparams_static_from_numpy``. Returns (counts, sums)."""
    if xq.device.type == "cpu":
        return fused_mlp_query_columnar_int8_plain(weights, xq)
    dims = weights.dims
    _check_table(xq, (torch.int8,), dims[0], weights.blob, dims)
    if max(dims[:-1]) > MAX_STATIC_DIN:
        raise ValueError(f"MLP {dims}: a layer input wider than {MAX_STATIC_DIN} would not "
                         f"convert its int32 sums to f32 exactly")
    out = _launch_int8(weights, xq, True)
    fused_mlp_query_columnar_int8.launches += 1
    return out


fused_mlp_query_columnar_int8.launches = 0


# --------------------------------------------------------------------------- calibration


def quantize_mlp_static(params, x_sample):
    """Static int8 calibration for K7b, copied from
    ``infera_tpu.ops.pallas_query.quantize_mlp_static`` (numpy):
    per-output-channel weight scales, per-layer activation scales from one
    f32 forward over the sample. Returns (qparams, s0) where qparams =
    [(wqT int8 [dout, din], comb [dout, 1], bq [dout, 1]), ...] with the
    requantization folded into each layer's epilogue, and s0 is the input
    scale (the table quantizes as rint(x / s0))."""
    acts = [np.abs(x_sample).max() / 127.0]
    h = x_sample
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < len(params) - 1:
            h = np.maximum(h, 0.0)
            acts.append(np.abs(h).max() / 127.0)
    qparams = []
    for i, (w, b) in enumerate(params):
        w_scale = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0
        wq = np.clip(np.rint(w / w_scale), -127, 127).astype(np.int8)
        last = i == len(params) - 1
        if last:
            comb = (w_scale * acts[i]).astype(np.float32)
            bq = b.astype(np.float32)
        else:
            comb = (w_scale * acts[i] / acts[i + 1]).astype(np.float32)
            bq = (b / acts[i + 1]).astype(np.float32)
        qparams.append((np.ascontiguousarray(wq.T),
                        comb.reshape(-1, 1), bq.reshape(-1, 1)))
    return qparams, np.float32(acts[0])



def quantize_mlp_shift(params, x_sample, max_flip_rate=0.05):
    """Power-of-two-product static int8 calibration with an accuracy gate,
    copied from ``infera_tpu.ops.pallas_query.quantize_mlp_shift`` (numpy).

    Activation scales are exact f32 maxima; per hidden channel the requant
    multiplier w_scale * act_i / act_{i+1} rounds up to 2^e, so the kernel's
    hidden epilogues are integer shifts, and the weight scale is derived
    back from it. The integer pipeline is emulated in numpy; the gate
    refuses (returns None) when the class-flip rate against the f32 forward
    exceeds ``max_flip_rate``.

    Returns (qparams, s0, flip_rate) or None.
    qparams = [(wqT int8 [dout, din], sl int32 [dout,1], sr int32
    [dout,1], bias_pre int32 [dout,1]), ..., last layer: (wqT, comb f32
    [dout,1], zeros, bias f32 [dout,1])]."""
    # f32 reference forward (for the activation scales AND the gate)
    h = x_sample.astype(np.float32)
    acts = [float(np.abs(h).max() / 127.0)]
    ref = h
    for i, (w, b) in enumerate(params):
        ref = ref @ w + b
        if i < len(params) - 1:
            ref = np.maximum(ref, 0.0)
            acts.append(float(np.abs(ref).max() / 127.0))
    ref_cls = np.argmax(ref, axis=-1)

    qparams = []
    exps = []
    for i, (w, b) in enumerate(params):
        ws0 = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0
        last = i == len(params) - 1
        if last:
            wq = np.clip(np.rint(w / ws0), -127, 127).astype(np.int8)
            comb = (ws0 * acts[i]).astype(np.float32)
            qparams.append((np.ascontiguousarray(wq.T),
                            comb.reshape(-1, 1),
                            np.zeros((w.shape[1], 1), np.int32),
                            b.astype(np.float32).reshape(-1, 1)))
            exps.append(None)
        else:
            e = np.ceil(np.log2(ws0 * acts[i] / acts[i + 1])).astype(
                np.int64)
            ws = np.exp2(e.astype(np.float64)) * acts[i + 1] / acts[i]
            wq = np.clip(np.rint(w / ws), -127, 127).astype(np.int8)
            sl = np.maximum(e, 0).astype(np.int32)
            sr = np.maximum(-e, 0).astype(np.int32)
            bias_pre = np.rint(
                b / acts[i + 1] * np.exp2(sr.astype(np.float64))
            ).astype(np.int32)
            half = np.where(sr > 0, 1 << np.maximum(sr - 1, 0),
                            0).astype(np.int32)
            bconst = (bias_pre.astype(np.int64)
                      + half.astype(np.int64))
            # int32 headroom guard: the epilogue computes (y << sl) + bconst
            # in int32, so bound the whole expression for any input
            # (|y| <= 127*127*din), and bconst itself must fit int32
            ymax = 127 * 127 * w.shape[0]
            worst = (ymax << sl.astype(np.int64).reshape(-1)) \
                + np.abs(bconst.reshape(-1))
            if int(worst.max()) >= (1 << 31) or \
                    int(np.abs(bconst).max()) >= (1 << 31):
                return None
            qparams.append((np.ascontiguousarray(wq.T),
                            sl.reshape(-1, 1), sr.reshape(-1, 1),
                            bconst.astype(np.int32).reshape(-1, 1)))
            exps.append((sl, sr))

    # exact numpy emulation of the kernel's integer pipeline
    s0 = np.float32(acts[0])
    q = np.clip(np.rint(x_sample / s0), -127, 127).astype(np.int64)
    for i, (w, b) in enumerate(params):
        wq = qparams[i][0].astype(np.int64).T  # [din, dout]
        y = q @ wq
        if i == len(params) - 1:
            h_int = y.astype(np.float64) * qparams[i][1].reshape(-1) \
                + qparams[i][3].reshape(-1)
        else:
            sl, sr = exps[i]
            y2 = (y << sl) + qparams[i][3].reshape(-1)  # bias+half folded
            q = np.clip(y2 >> sr, 0, 127)
    int_cls = np.argmax(h_int, axis=-1)
    flip_rate = float((int_cls != ref_cls).mean())
    if flip_rate > max_flip_rate:
        return None
    return qparams, s0, flip_rate
