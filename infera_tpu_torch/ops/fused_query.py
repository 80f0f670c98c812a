"""K1 and K3: the fused inference query as one kernel each.

Counterpart of ``infera_tpu/ops/pallas_query.py``. Over a feature-major table
``x [d0, N]`` (stacked columns) the query

    scan -> ReLU MLP -> argmax over classes (first index on ties)
    -> keep rows with score0 > 0 -> per class: count and sum of score0

runs in ``csrc/fused_query.cu``:

- K1, ``fused_mlp_query_columnar``: f32, or bf16 operands (the input and every
  ReLU output rounded to bf16) with f32 accumulation; biases, ReLU and the
  tail in f32.
- K3, ``fused_mlp_query_columnar_int8_shift``: int8 x int8 -> int32 layers;
  hidden layers requantize with integer shifts,
  ``q = clip(((y << sl) + bias_pre) >> sr, 0, 127)``; the last layer computes
  ``y * comb + bias`` in f32. Its weights come from ``quantize_mlp_shift``.

Both return ``(counts [C] int64, sums [C] f32)``: the counts stay integers,
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


def qparams_from_numpy(qparams, device) -> ShiftWeights:
    """Carry ``quantize_mlp_shift``'s qparams to ``device``."""
    n_layers = len(qparams)
    layers = []
    weight_words = []
    epilogues = []
    for li, (wq, a1, a2, a3) in enumerate(qparams):
        last = li == n_layers - 1
        wq = np.asarray(wq, np.int8)
        dout = wq.shape[0]
        a1 = np.asarray(a1, np.float32 if last else np.int32).reshape(-1, 1)
        a2 = np.asarray(a2, np.int32).reshape(-1, 1)
        a3 = np.asarray(a3, np.float32 if last else np.int32).reshape(-1, 1)
        layers.append(tuple(torch.as_tensor(a, device=device) for a in (wq, a1, a2, a3)))
        weight_words.append(_pack_int8_words(wq).reshape(-1))
        epi = np.zeros((3, pad8(dout)), np.int32)
        epi[0, :dout] = a1.reshape(-1).view(np.int32)   # sl, or comb's float bits
        epi[1, :dout] = 0 if last else a2.reshape(-1)   # sr
        epi[2, :dout] = a3.reshape(-1).view(np.int32)   # bias_pre, or bias's float bits
        epilogues.append(epi.reshape(-1))
    dims = (layers[0][0].shape[1],) + tuple(layer[0].shape[0] for layer in layers)
    blob = torch.as_tensor(np.concatenate(weight_words + epilogues), device=device)
    need_sl = tuple(bool(np.asarray(qp[1]).max() > 0) for qp in qparams[:-1]) + (False,)
    return ShiftWeights(dims=dims, layers=layers, blob=blob, need_sl=need_sl)


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


def fused_mlp_query_columnar_plain(weights: QueryWeights, xc: torch.Tensor):
    """K1's function in plain PyTorch. bf16 mode multiplies bf16-rounded
    operands in f32, which is exact, and accumulates in f32."""
    bf16 = weights.compute_dtype == torch.bfloat16
    h = xc.to(weights.compute_dtype).float()
    last = len(weights.layers) - 1
    for i, (wt, b) in enumerate(weights.layers):
        h = wt.float() @ h + b
        if i < last:
            h = torch.relu(h)
            if bf16:
                h = h.to(torch.bfloat16).float()
    return query_tail_plain(h)


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


# --------------------------------------------------------------------------- kernels


def _partials(n_blocks: int, n_classes: int, device):
    return (torch.empty((n_blocks, n_classes), dtype=torch.int64, device=device),
            torch.empty((n_blocks, n_classes), dtype=torch.float64, device=device),
            torch.empty(n_classes, dtype=torch.int64, device=device),
            torch.empty(n_classes, dtype=torch.float32, device=device))


def _check_table(x: torch.Tensor, dtypes, d0: int, blob: torch.Tensor, dims) -> None:
    _kernels.require_cuda(x, "table")
    if x.dtype not in dtypes or x.dim() != 2 or x.shape[0] != d0 or x.shape[1] < 1:
        raise ValueError(f"table must be [{d0}, N >= 1] of {dtypes}, "
                         f"got {x.dtype} {tuple(x.shape)}")
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


def _int8_widest4(dims) -> int:
    return max([_div4(dims[0])] + [pad8(d) // 4 for d in dims[1:-1]])


def int8_smem_bytes(dims) -> int:
    """Shared memory of K3: packed weights and epilogue constants, the tail's
    scratch, two packed activation tiles and the f32 scores of the tile."""
    blob = sum(_div4(dims[i]) * pad8(dims[i + 1]) + 3 * pad8(dims[i + 1])
               for i in range(len(dims) - 1))
    return (4 * blob + _tail_bytes(dims[-1]) + 8 * _int8_widest4(dims) * ACT_STRIDE
            + 4 * pad8(dims[-1]) * ACT_STRIDE)


def fused_mlp_query_columnar(weights: QueryWeights, xc: torch.Tensor):
    """K1 over the table ``xc [d0, N]`` (f32 or bf16); ``weights`` from
    ``params_from_numpy`` fix the compute dtype. Returns (counts, sums)."""
    if xc.device.type == "cpu":
        return fused_mlp_query_columnar_plain(weights, xc)
    dims = weights.dims
    _check_table(xc, (torch.float32, torch.bfloat16), dims[0], weights.blob, dims)
    smem = query_smem_bytes(dims)
    if smem > SMEM_LIMIT:
        raise ValueError(f"MLP {dims} exceeds the kernel's shared-memory budget")
    n = xc.shape[1]
    n_blocks = _kernels.grid_blocks(xc.device, -(-n // TILE_ROWS), smem)
    part_cnt, part_sum, counts, sums = _partials(n_blocks, dims[-1], xc.device)
    compute = _COMPUTE[weights.compute_dtype]
    lib = _kernels.load("fused_query")
    rc = lib.infera_fused_query_f32(
        xc.data_ptr(), int(xc.dtype == torch.bfloat16), int(compute == "bf16"), n,
        weights.blob.data_ptr(), weights.blob.numel(), _kernels.int_array(dims),
        len(dims) - 1, max(pad8(d) for d in dims), part_cnt.data_ptr(), part_sum.data_ptr(),
        counts.data_ptr(), sums.data_ptr(), n_blocks, smem, _kernels.stream_handle(xc.device))
    _kernels.check(lib, rc, "fused_mlp_query_columnar")
    fused_mlp_query_columnar.launches[compute] += 1
    return counts, sums


fused_mlp_query_columnar.launches = {"f32": 0, "bf16": 0}


def fused_mlp_query_columnar_int8_shift(weights: ShiftWeights, xq: torch.Tensor):
    """K3 over the int8 table ``xq [d0, N]``; ``weights`` from
    ``qparams_from_numpy``. Returns (counts, sums)."""
    if xq.device.type == "cpu":
        return fused_mlp_query_columnar_int8_shift_plain(weights, xq)
    dims = weights.dims
    _check_table(xq, (torch.int8,), dims[0], weights.blob, dims)
    smem = int8_smem_bytes(dims)
    if smem > SMEM_LIMIT:
        raise ValueError(f"MLP {dims} exceeds the kernel's shared-memory budget")
    n = xq.shape[1]
    n_blocks = _kernels.grid_blocks(xq.device, -(-n // TILE_ROWS), smem)
    part_cnt, part_sum, counts, sums = _partials(n_blocks, dims[-1], xq.device)
    need_sl_mask = sum(1 << i for i, flag in enumerate(weights.need_sl) if flag)
    lib = _kernels.load("fused_query")
    rc = lib.infera_fused_query_int8_shift(
        xq.data_ptr(), n, weights.blob.data_ptr(), weights.blob.numel(),
        _kernels.int_array(dims), len(dims) - 1, _int8_widest4(dims), need_sl_mask,
        part_cnt.data_ptr(), part_sum.data_ptr(), counts.data_ptr(), sums.data_ptr(),
        n_blocks, smem, _kernels.stream_handle(xq.device))
    _kernels.check(lib, rc, "fused_mlp_query_columnar_int8_shift")
    fused_mlp_query_columnar_int8_shift.launches += 1
    return counts, sums


fused_mlp_query_columnar_int8_shift.launches = 0


# --------------------------------------------------------------------------- calibration


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
