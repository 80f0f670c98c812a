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
from .fused_mlp import ACT_STRIDE, MAX_LAYERS, SMEM_LIMIT, TILE_ROWS, pack_f32_blob, pad8

_COMPUTE = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _tail_bytes(n_classes: int) -> int:
    return pad8(n_classes) * 16 + TILE_ROWS * 8


def _div4(n: int) -> int:
    return (n + 3) // 4


# --------------------------------------------------------------------------- weights


@dataclass(frozen=True)
class QueryWeights:
    """K1's weights on one device: ``layers`` = [(Wt [dout, din] in the
    compute dtype, b [dout, 1] f32), ...], as the TPU kernel takes them, and
    ``blob``, the same numbers in the kernel's shared-memory layout (f32; in
    bf16 mode they hold bf16-rounded values)."""

    compute_dtype: torch.dtype
    dims: tuple
    layers: list
    blob: torch.Tensor


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
    return QueryWeights(compute_dtype=compute_dtype, dims=dims, layers=layers, blob=blob)


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


def _pack_int8_words(wq: np.ndarray) -> np.ndarray:
    """wq [dout, din] int8 -> int32 [ceil(din/4)][pad8(dout)]: each word holds
    the weights of 4 consecutive inputs of one output column."""
    dout, din = wq.shape
    b = np.zeros((pad8(dout), _div4(din) * 4), np.int8)
    b[:dout, :din] = wq
    words = b.view(np.uint8).reshape(pad8(dout), _div4(din), 4).astype(np.uint32)
    words = words[..., 0] | words[..., 1] << 8 | words[..., 2] << 16 | words[..., 3] << 24
    return np.ascontiguousarray(words.T).view(np.int32)


def _int8_blob(wqs, epilogue_rows, device) -> tuple:
    """(dims, blob) of an int8 kernel from each layer's weights wq int8
    [dout, din] and three epilogue rows: the packed weights of every layer,
    then per layer its epilogue rows as int32 words [3][pad8(dout)]."""
    weight_words = [_pack_int8_words(wq).reshape(-1) for wq in wqs]
    epilogues = []
    for wq, rows in zip(wqs, epilogue_rows):
        epi = np.zeros((3, pad8(wq.shape[0])), np.int32)
        for r, row in enumerate(rows):
            epi[r, :wq.shape[0]] = row
        epilogues.append(epi.reshape(-1))
    dims = (wqs[0].shape[1],) + tuple(wq.shape[0] for wq in wqs)
    return dims, torch.as_tensor(np.concatenate(weight_words + epilogues), device=device)


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


def query_smem_bytes(dims) -> int:
    """Shared memory of K1: weights and biases at f32, the tail's scratch and
    two 64-row activation tiles at the widest width."""
    widest = max(pad8(d) for d in dims)
    blob = sum(dims[i] * pad8(dims[i + 1]) + pad8(dims[i + 1]) for i in range(len(dims) - 1))
    return 4 * blob + _tail_bytes(dims[-1]) + 8 * widest * ACT_STRIDE


# K7a's ring of row-major tiles (csrc/query_tile.cuh): enough buffers that
# about 20 KB of the table is in flight on each SM (one block an SM at the
# bench MLP), at most 8
RING_IN_FLIGHT = 20 * 1024
MAX_RING_STAGES = 8


def ring_stride(d0: int, itemsize: int) -> int:
    """Bytes of a ring buffer's row: d0 values padded to an odd number of
    16-byte words (so the transposition has no bank conflicts)."""
    return 16 * ((-(-d0 * itemsize // 16)) | 1)


def ring_stages(dims, itemsize: int, extra: int = 0) -> int:
    """Buffers of K7a's ring for an MLP of ``dims`` over a table of
    ``itemsize``-byte values, beside ``extra`` bytes of other scratch: 1 +
    the tiles that keep ``RING_IN_FLIGHT`` bytes in flight, fewer where
    the block's 227 KB would not hold them, 0 (the scalar load) where a row
    is not a whole number of 16-byte words or no buffer fits."""
    if dims[0] * itemsize % 16:
        return 0
    stage = TILE_ROWS * ring_stride(dims[0], itemsize)
    stages = min(MAX_RING_STAGES, 1 + -(-RING_IN_FLIGHT // (TILE_ROWS * dims[0] * itemsize)))
    base = query_smem_bytes(dims) + extra
    while stages > 0 and base + stages * stage > SMEM_LIMIT:
        stages -= 1
    return stages


def rows_query_smem_bytes(dims, itemsize: int = 4, extra: int = 0) -> int:
    """Shared memory of K7a over a table of ``itemsize``-byte values: K1's
    and the ring's buffers (``ring_stages``), each [64][ring_stride]
    bytes, beside ``extra`` bytes of other scratch (not counted)."""
    stages = ring_stages(dims, itemsize, extra)
    return query_smem_bytes(dims) + stages * TILE_ROWS * ring_stride(dims[0], itemsize)


def _int8_widest4(dims) -> int:
    return max([_div4(dims[0])] + [pad8(d) // 4 for d in dims[1:-1]])


def int8_smem_bytes(dims) -> int:
    """Shared memory of K3 and of K7b (whose blob has K3's layout): packed
    weights and epilogue constants, the tail's scratch, two packed
    activation tiles and the f32 scores of the tile."""
    blob = sum(_div4(dims[i]) * pad8(dims[i + 1]) + 3 * pad8(dims[i + 1])
               for i in range(len(dims) - 1))
    return (4 * blob + _tail_bytes(dims[-1]) + 8 * _int8_widest4(dims) * ACT_STRIDE
            + 4 * pad8(dims[-1]) * ACT_STRIDE)


def _launch_f32(entry: str, weights: QueryWeights, x: torch.Tensor, n: int, smem: int,
                *stages):
    """Launch K1 or K7a (C entry ``entry``; K7a with its ring's ``stages``)
    over a checked table of ``n`` rows; returns (counts, sums) and the
    compute dtype's name."""
    dims = weights.dims
    if smem > SMEM_LIMIT:
        raise ValueError(f"MLP {dims} exceeds the kernel's shared-memory budget")
    n_blocks = _kernels.grid_blocks(x.device, -(-n // TILE_ROWS), smem)
    part_cnt, part_sum, counts, sums = _partials(n_blocks, dims[-1], x.device)
    compute = _COMPUTE[weights.compute_dtype]
    lib = _kernels.load("fused_query")
    rc = getattr(lib, entry)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), int(compute == "bf16"), n,
        weights.blob.data_ptr(), weights.blob.numel(), _kernels.int_array(dims),
        len(dims) - 1, max(pad8(d) for d in dims), *stages, part_cnt.data_ptr(),
        part_sum.data_ptr(), counts.data_ptr(), sums.data_ptr(), n_blocks, smem,
        _kernels.stream_handle(x.device))
    _kernels.check(lib, rc, entry)
    return (counts, sums), compute


def fused_mlp_query_columnar(weights: QueryWeights, xc: torch.Tensor):
    """K1 over the table ``xc [d0, N]`` (f32 or bf16); ``weights`` from
    ``params_from_numpy`` fix the compute dtype. Returns (counts, sums)."""
    if xc.device.type == "cpu":
        return fused_mlp_query_columnar_plain(weights, xc)
    dims = weights.dims
    _check_table(xc, (torch.float32, torch.bfloat16), dims[0], weights.blob, dims)
    out, compute = _launch_f32("infera_fused_query_f32", weights, xc, xc.shape[1],
                               query_smem_bytes(dims))
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
    item = x.element_size()
    out, compute = _launch_f32("infera_fused_query_rows", weights, x, x.shape[0],
                               rows_query_smem_bytes(dims, item), ring_stages(dims, item))
    fused_mlp_query.launches[compute] += 1
    return out


fused_mlp_query.launches = {"f32": 0, "bf16": 0}


def _launch_int8(entry: str, weights, xq: torch.Tensor, *extra):
    """Launch K3 or K7b (C entry ``entry``, with K3's ``extra`` arguments)
    over a checked int8 table; returns (counts, sums)."""
    dims = weights.dims
    smem = int8_smem_bytes(dims)
    if smem > SMEM_LIMIT:
        raise ValueError(f"MLP {dims} exceeds the kernel's shared-memory budget")
    n = xq.shape[1]
    n_blocks = _kernels.grid_blocks(xq.device, -(-n // TILE_ROWS), smem)
    part_cnt, part_sum, counts, sums = _partials(n_blocks, dims[-1], xq.device)
    lib = _kernels.load("fused_query")
    rc = getattr(lib, entry)(
        xq.data_ptr(), n, weights.blob.data_ptr(), weights.blob.numel(),
        _kernels.int_array(dims), len(dims) - 1, _int8_widest4(dims), *extra,
        part_cnt.data_ptr(), part_sum.data_ptr(), counts.data_ptr(), sums.data_ptr(),
        n_blocks, smem, _kernels.stream_handle(xq.device))
    _kernels.check(lib, rc, entry)
    return counts, sums


def fused_mlp_query_columnar_int8_shift(weights: ShiftWeights, xq: torch.Tensor):
    """K3 over the int8 table ``xq [d0, N]``; ``weights`` from
    ``qparams_from_numpy``. Returns (counts, sums)."""
    if xq.device.type == "cpu":
        return fused_mlp_query_columnar_int8_shift_plain(weights, xq)
    _check_table(xq, (torch.int8,), weights.dims[0], weights.blob, weights.dims)
    need_sl_mask = sum(1 << i for i, flag in enumerate(weights.need_sl) if flag)
    out = _launch_int8("infera_fused_query_int8_shift", weights, xq, need_sl_mask)
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
    out = _launch_int8("infera_fused_query_int8_static", weights, xq)
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
