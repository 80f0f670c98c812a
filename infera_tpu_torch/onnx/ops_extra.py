"""Extended ONNX ops (beyond ``onnx/ops.py``'s core set).

Counterpart of ``infera_tpu/onnx/ops_extra.py``, all 51 registrations: the
unary long tail (registered through ops.py's ``_unary``), activations,
reductions, padding and data-movement ops, TopK and the scatters, Einsum,
Resize and the normalisations, the quantized-model family
(QuantizeLinear, DequantizeLinear, DynamicQuantizeLinear, MatMulInteger,
QLinearMatMul), ConvTranspose, and the host folds NonMaxSuppression and
Unique beside TfIdfVectorizer. ``infera_tpu`` computes every one in XLA
outside any Pallas kernel, so they are eager torch ops here.

Semantics are ``infera_tpu``'s where ONNX, torch and XLA differ:

- Pad reflects, repeats and wraps on any axis (index gathers, as
  ``jnp.pad``), trimming where a pad is negative; a runtime pad value pads
  with 0.
- TopK orders floats by IEEE total order (NaN above +inf, +0 above -0, a
  negative NaN below -inf) and the lower index first among ties, as
  ``lax.top_k``; ``largest=0`` takes the reverse order, as ``lax.top_k``
  of the negated input does.
- GatherND wraps a negative index once and clamps the rest; the scatters
  wrap a negative index once (ScatterElements' axis index twice: once by
  hand, once by ``.at``) and drop the updates that still fall outside.
- Resize is ``jax.image.resize``'s: it reads only ``mode`` and the sizes or
  scales (half-pixel centres, Keys cubic with a = -0.5, an antialiasing
  kernel when it downsamples in ``linear`` and ``cubic``), as per-axis
  weight matrices built in numpy and contracted one axis at a time.
- The quantized ops cast 8-bit operands to int32 before subtracting zero
  points, round half to even, and take the output's signedness from the
  static dtype of its zero point. MatMulInteger's exact products run in f32
  while 255^2 * K < 2^24, else in f64 (no integer matmul on the card). A
  division by a static value multiplies by its f32 reciprocal, as XLA
  rewrites it (DynamicQuantizeLinear's 1/255, a static QuantizeLinear or
  QLinearMatMul scale), so the rounded integers agree.
- ConvTranspose dilates the input by the strides and runs a convolution of
  the flipped kernel (``F.conv*d``, TF32 off), cropping where a pad passes
  (k - 1) * d; so it takes what ``F.conv_transpose*d`` refuses.
- NonMaxSuppression and Unique fold on the host from static inputs and
  refuse runtime ones; TfIdfVectorizer counts integer tokens only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import OnnxError
from .ops import (
    _CONV,
    _fill_value,
    _float,
    _node_const,
    _saturating_cast,
    _static_ints,
    _unary,
    register,
)

register("Tan")(_unary(torch.tan))
register("Asin")(_unary(torch.asin))
register("Acos")(_unary(torch.acos))
register("Atan")(_unary(torch.atan))
register("Sinh")(_unary(torch.sinh))
register("Cosh")(_unary(torch.cosh))
register("Asinh")(_unary(torch.asinh))
register("Acosh")(_unary(torch.acosh))
register("Atanh")(_unary(torch.atanh))
# jnp.sign: NaN stays NaN and a zero keeps its sign (torch.sign gives 0, +0)
register("Sign")(_unary(lambda x: torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))))
register("IsNaN")(_unary(torch.isnan))
register("HardSwish")(_unary(lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)))
register("Mish")(_unary(lambda x: x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))))

_NP_INT = {torch.int8: np.int8, torch.uint8: np.uint8, torch.int16: np.int16,
           torch.int32: np.int32, torch.int64: np.int64}


def _recip(value) -> np.ndarray:
    """The f32 reciprocal XLA multiplies by where it divides by a constant."""
    return np.float32(1.0) / np.asarray(value, np.float32)


def _str_attr(node, name, default):
    v = node.attr(name, default)
    return v.decode() if isinstance(v, bytes) else v


# ---------------------------------------------------------------------------
# Activations and normalisations
# ---------------------------------------------------------------------------

@register("IsInf")
def _isinf(node, inputs, ctx):
    x = inputs[0]
    out = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if node.attr("detect_positive", 1):
        out = out | (x == float("inf"))
    if node.attr("detect_negative", 1):
        out = out | (x == float("-inf"))
    return [out]


@register("Selu")
def _selu(node, inputs, ctx):
    alpha = node.attr("alpha", 1.67326319217681884765625)
    gamma = node.attr("gamma", 1.05070102214813232421875)
    x = inputs[0]
    return [gamma * torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))]


@register("Celu")
def _celu(node, inputs, ctx):
    alpha = node.attr("alpha", 1.0)
    x = _float(inputs[0])
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    e = alpha * (torch.exp(x * float(_recip(alpha))) - 1.0)
    return [torch.maximum(x, zero) + torch.minimum(zero, e)]


@register("ThresholdedRelu")
def _thresholded_relu(node, inputs, ctx):
    x = inputs[0]
    return [torch.where(x > node.attr("alpha", 1.0), x, 0.0)]


@register("Shrink")
def _shrink(node, inputs, ctx):
    lambd = node.attr("lambd", 0.5)
    bias = node.attr("bias", 0.0)
    x = inputs[0]
    return [torch.where(x < -lambd, x + bias, torch.where(x > lambd, x - bias, 0.0))]


@register("Hardmax")
def _hardmax(node, inputs, ctx):
    x = inputs[0]
    axis = node.attr("axis", -1) % x.dim()
    idx = torch.argmax(x, dim=axis, keepdim=True)  # the first on ties, as jnp
    pos = torch.arange(x.shape[axis], device=x.device).reshape(
        (-1,) + (1,) * (x.dim() - axis - 1))
    return [(pos == idx).to(x.dtype)]


@register("LpNormalization")
def _lp_normalization(node, inputs, ctx):
    axis = node.attr("axis", -1)
    x = _float(inputs[0])
    if node.attr("p", 2) == 1:
        d = torch.sum(torch.abs(x), dim=axis, keepdim=True)
    else:
        d = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    return [x / torch.where(d == 0, 1.0, d)]


def _moments(x, dims):
    mean = torch.mean(x, dim=dims, keepdim=True)
    d = x - mean
    return d, torch.mean(d * d, dim=dims, keepdim=True)


@register("MeanVarianceNormalization")
def _mvn(node, inputs, ctx):
    d, var = _moments(_float(inputs[0]), tuple(node.attr("axes", [0, 2, 3])))
    return [d / torch.sqrt(var + 1e-9)]


def _affine_shape(x):
    return (1, -1) + (1,) * (x.dim() - 2)


@register("InstanceNormalization")
def _instance_norm(node, inputs, ctx):
    eps = node.attr("epsilon", 1e-5)
    x, scale, bias = (_float(t) for t in inputs[:3])
    d, var = _moments(x, tuple(range(2, x.dim())))
    shape = _affine_shape(x)
    return [d / torch.sqrt(var + eps) * scale.reshape(shape) + bias.reshape(shape)]


@register("GroupNormalization")
def _group_norm(node, inputs, ctx):
    eps = node.attr("epsilon", 1e-5)
    groups = int(node.attr("num_groups"))
    x, scale, bias = (_float(t) for t in inputs[:3])
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    d, var = _moments(xg, tuple(range(2, xg.dim())))
    y = (d / torch.sqrt(var + eps)).reshape(x.shape)
    if scale.numel() == groups:  # per-group affine (opset 18)
        scale = torch.repeat_interleave(scale, c // groups)
        bias = torch.repeat_interleave(bias, c // groups)
    shape = _affine_shape(x)
    return [y * scale.reshape(shape) + bias.reshape(shape)]


# ---------------------------------------------------------------------------
# Reductions missing from the core set: an empty or absent axis list reduces
# every axis (noop_with_empty_axes: none), unlike the core set's
# ---------------------------------------------------------------------------

def _reduce(fn):
    def impl(node, inputs, ctx):
        x = inputs[0]
        if len(node.inputs) > 1 and node.inputs[1]:
            axes = _static_ints(ctx, node, node.inputs[1], "axes")
        else:
            axes = node.attr("axes")
        keepdim = bool(node.attr("keepdims", 1))
        if not axes and node.attr("noop_with_empty_axes", 0):
            return [x]
        dims = tuple(axes) if axes else tuple(range(x.dim()))
        return [fn(x, dims, keepdim)]

    return impl


register("ReduceL1", static=(1,))(_reduce(
    lambda x, d, k: torch.sum(torch.abs(x), dim=d, keepdim=k)))
register("ReduceSumSquare", static=(1,))(_reduce(
    lambda x, d, k: torch.sum(x * x, dim=d, keepdim=k)))
register("ReduceLogSum", static=(1,))(_reduce(
    lambda x, d, k: torch.log(torch.sum(x, dim=d, keepdim=k))))


# ---------------------------------------------------------------------------
# Shape / data movement
# ---------------------------------------------------------------------------

@register("Pad", static=(1, 2, 3))
def _pad(node, inputs, ctx):
    x = inputs[0]
    if len(node.inputs) > 1 and node.inputs[1]:
        pads = _static_ints(ctx, node, node.inputs[1], "pads")
    else:
        pads = node.attr("pads")
    if pads is None:
        raise OnnxError(f"Pad '{node.name}': missing pads")
    mode = _str_attr(node, "mode", "constant")
    value = 0.0  # a pad value known only at run time pads with 0, as infera_tpu
    if len(node.inputs) > 2 and node.inputs[2]:
        cv = ctx.as_static(inputs[2])
        if cv is not None:
            value = float(np.asarray(cv).reshape(-1)[0])
    rank = x.dim()
    axes = list(range(rank))
    if len(node.inputs) > 3 and node.inputs[3]:
        axes = [a % rank for a in _static_ints(ctx, node, node.inputs[3], "axes")]
    width = [(0, 0)] * rank
    half = len(pads) // 2
    for i, a in enumerate(axes[:half]):
        width[a] = (pads[i], pads[i + half])
    for d, (b, e) in enumerate(width):  # negative pads trim
        if b < 0 or e < 0:
            start = -b if b < 0 else 0
            stop = x.shape[d] + e if e < 0 else x.shape[d]
            x = x.narrow(d, start, max(stop - start, 0))
    width = [(max(b, 0), max(e, 0)) for b, e in width]
    if mode not in ("constant", "reflect", "edge", "wrap"):
        raise OnnxError(f"Pad mode {mode} not supported")
    if mode == "constant":
        if not x.is_floating_point():
            value = int(value) if x.dtype != torch.bool else bool(value)
        out = torch.full([n + b + e for n, (b, e) in zip(x.shape, width)], value,
                         dtype=x.dtype, device=x.device)
        out[tuple(slice(b, b + n) for n, (b, _) in zip(x.shape, width))] = x
        return [out]
    for d, (b, e) in enumerate(width):
        if b or e:  # jnp.pad's index map along the axis, from numpy
            n = x.shape[d]
            idx = _node_const(node, ctx, (mode, d, n, b, e),
                              lambda: np.pad(np.arange(n), (b, e), mode=mode))
            x = torch.index_select(x, d, idx)
    return [x]


@register("DepthToSpace")
def _depth_to_space(node, inputs, ctx):
    b = int(node.attr("blocksize"))
    x = inputs[0]
    n, c, h, w = x.shape
    if _str_attr(node, "mode", "DCR") == "DCR":
        y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        y = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return [y.reshape(n, c // (b * b), h * b, w * b)]


@register("SpaceToDepth")
def _space_to_depth(node, inputs, ctx):
    b = int(node.attr("blocksize"))
    x = inputs[0]
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return [y.reshape(n, c * b * b, h // b, w // b)]


@register("Trilu", static=(1,))
def _trilu(node, inputs, ctx):
    k = 0
    if len(node.inputs) > 1 and node.inputs[1]:
        k = _static_ints(ctx, node, node.inputs[1], "k")[0]
    x = inputs[0]
    return [torch.triu(x, k) if node.attr("upper", 1) else torch.tril(x, k)]


@register("CumSum", static=(1,))
def _cumsum(node, inputs, ctx):
    axis = _static_ints(ctx, node, node.inputs[1], "axis")[0]
    x = inputs[0]
    reverse = bool(node.attr("reverse", 0))
    if reverse:
        x = torch.flip(x, (axis,))
    y = torch.cumsum(x, dim=axis)
    if node.attr("exclusive", 0):
        y = y - x  # as infera_tpu: the inclusive sum less the element
    if reverse:
        y = torch.flip(y, (axis,))
    return [y]


@register("OneHot", static=(1, 2))
def _onehot(node, inputs, ctx):
    axis = node.attr("axis", -1)
    depth = _static_ints(ctx, node, node.inputs[1], "depth")[0]
    values = ctx.as_static(inputs[2])
    if values is None:
        raise OnnxError("OneHot: values must be static")
    off, on = [float(v) for v in np.asarray(values).reshape(-1)]
    idx = _saturating_cast(inputs[0], np.int32) if inputs[0].is_floating_point() else inputs[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + depth, idx)
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)).float()
    oh = torch.movedim(oh, -1, axis % oh.dim())
    return [oh * (on - off) + off]


@register("EyeLike")
def _eyelike(node, inputs, ctx):
    x = inputs[0]
    k = int(node.attr("k", 0))
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    return [(cols - rows == k).to(x.dtype)]


def _cast_to(x, dtype):
    if x.is_floating_point() and dtype in _NP_INT:
        return _saturating_cast(x, _NP_INT[dtype])
    return x.to(dtype)


@register("CastLike")
def _castlike(node, inputs, ctx):
    return [_cast_to(inputs[0], inputs[1].dtype)]


def _total_order_key(x):
    """An integer key whose order is IEEE total order (-NaN < -inf < ... <
    -0 < +0 < ... < inf < NaN), the order ``lax.top_k`` compares floats by."""
    if x.dtype == torch.float32:
        i = x.contiguous().view(torch.int32).long()
    elif x.is_floating_point():
        i = x.double().contiguous().view(torch.int64)
        return torch.where(i < 0, i ^ 0x7FFFFFFFFFFFFFFF, i)
    else:
        return x
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


@register("TopK", static=(1,))
def _topk(node, inputs, ctx):
    k = _static_ints(ctx, node, node.inputs[1], "k")[0]
    axis = node.attr("axis", -1)
    x = torch.movedim(inputs[0], axis, -1)
    if k > x.shape[-1]:
        raise OnnxError(f"TopK '{node.name}': k={k} is larger than the axis ({x.shape[-1]})")
    # a stable sort keeps the lower index first among ties; largest=0 is
    # lax.top_k of -x, whose total order is x's reversed (no negation: the
    # card does not keep a NaN's sign through it)
    idx = torch.sort(_total_order_key(x), dim=-1, descending=bool(node.attr("largest", 1)),
                     stable=True).indices[..., :k]
    vals = torch.gather(x, -1, idx)
    return [torch.movedim(vals, -1, axis), torch.movedim(idx.to(torch.int32), -1, axis)]


def _int_indices(t):
    return (_saturating_cast(t, np.int32) if t.is_floating_point() else t).long()


@register("GatherND")
def _gather_nd(node, inputs, ctx):
    if int(node.attr("batch_dims", 0)) != 0:
        raise OnnxError("GatherND batch_dims != 0 not supported")
    data, indices = inputs[0], _int_indices(inputs[1])
    last = indices.shape[-1]
    flat = indices.reshape(-1, last)
    # jnp indexing: a negative index wraps once, then every index clamps
    cols = []
    for i in range(last):
        n = data.shape[i]
        j = flat[:, i]
        cols.append(torch.clamp(torch.where(j < 0, j + n, j), 0, max(n - 1, 0)))
    out = data[tuple(cols)]
    return [out.reshape(tuple(indices.shape[:-1]) + tuple(data.shape[last:]))]


def _scatter_flat(data, lin, ok, updates, reduction, what):
    """Scatter ``updates`` into ``data`` at the flat positions ``lin``;
    updates where ``ok`` is false are dropped (sent to a spare slot)."""
    if reduction not in ("none", None, "add", "mul"):
        raise OnnxError(f"{what} reduction {reduction} not supported")
    spare = data.numel()
    lin = torch.where(ok, lin, spare).reshape(-1)
    upd = updates.reshape(-1).to(data.dtype)
    flat = torch.cat([data.reshape(-1), data.new_zeros(1)])
    if reduction == "add":
        flat = flat.index_add(0, lin, upd)
    elif reduction == "mul":
        flat = flat.scatter_reduce(0, lin, upd, "prod", include_self=True)
    else:
        flat = flat.index_put((lin,), upd)
    return flat[:spare].reshape(data.shape)


def _linear_index(cols, shape):
    """(the row-major flat index of the index tuple ``cols`` into ``shape``,
    whether every index lies inside it)."""
    lin = torch.zeros_like(cols[0])
    ok = torch.ones(cols[0].shape, dtype=torch.bool, device=cols[0].device)
    for j, n in zip(cols, shape):
        j = torch.where(j < 0, j + n, j)  # .at wraps a negative index once
        ok = ok & (j >= 0) & (j < n)
        lin = lin * n + j
    return lin, ok


@register("ScatterElements")
def _scatter_elements(node, inputs, ctx):
    axis = node.attr("axis", 0)
    reduction = _str_attr(node, "reduction", "none")
    data, indices, updates = inputs[0], _int_indices(inputs[1]), inputs[2]
    axis = axis % data.dim()
    cols = [torch.arange(s, device=data.device).reshape(
        (-1,) + (1,) * (indices.dim() - d - 1)).expand(indices.shape)
        for d, s in enumerate(indices.shape)]
    n = data.shape[axis]
    cols[axis] = torch.where(indices < 0, indices + n, indices)
    lin, ok = _linear_index(cols, data.shape)
    return [_scatter_flat(data, lin, ok, updates, reduction, "ScatterElements")]


@register("ScatterND")
def _scatter_nd(node, inputs, ctx):
    reduction = _str_attr(node, "reduction", "none")
    data, indices, updates = inputs[0], _int_indices(inputs[1]), inputs[2]
    last = indices.shape[-1]
    flat = indices.reshape(-1, last)
    lin, ok = _linear_index([flat[:, i] for i in range(last)], data.shape[:last])
    inner = int(np.prod(data.shape[last:], dtype=np.int64))
    lin = lin[:, None] * inner + torch.arange(inner, device=data.device)
    ok = ok[:, None].expand(lin.shape)
    return [_scatter_flat(data, lin, ok, updates, reduction, "ScatterND")]


@register("Compress", static=(1,))
def _compress(node, inputs, ctx):
    cond = ctx.as_static(inputs[1])
    if cond is None:
        raise OnnxError("Compress: condition must be static (dynamic output shape)")
    keep = np.nonzero(np.asarray(cond, bool))[0]
    axis = node.attr("axis")
    x = inputs[0]
    if axis is None:  # jnp indexing of the flattened input: past the end clamps
        x = x.reshape(-1)
        return [x[ctx.tensor(node, "keep", np.minimum(keep, x.shape[0] - 1))]]
    # jnp.take along the axis: past the end fills
    axis = int(axis) % x.dim()
    n = x.shape[axis]
    out = torch.index_select(x, axis, ctx.tensor(node, "keep", np.minimum(keep, n - 1)))
    bad = keep >= n
    if bad.any():
        mask = ctx.tensor(node, "past", bad).reshape((-1,) + (1,) * (x.dim() - axis - 1))
        out = torch.where(mask, _fill_value(out.dtype), out)
    return [out]


@register("ReverseSequence")
def _reverse_sequence(node, inputs, ctx):
    batch_axis = int(node.attr("batch_axis", 1))
    time_axis = int(node.attr("time_axis", 0))
    x = torch.movedim(inputs[0], (batch_axis, time_axis), (0, 1))
    lens = _int_indices(inputs[1])
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    idx = torch.where(pos < lens[:, None], lens[:, None] - 1 - pos, pos)  # [B, T]
    # a length past T reads past the end: jnp.take fills there
    bad = idx >= t
    idx = idx.clamp(0, t - 1).reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    out = torch.gather(x, 1, idx)
    out = torch.where(bad.reshape(bad.shape + (1,) * (x.dim() - 2)), _fill_value(out.dtype), out)
    return [torch.movedim(out, (0, 1), (batch_axis, time_axis))]


@register("Einsum")
def _einsum(node, inputs, ctx):
    eq = _str_attr(node, "equation", None)
    dtype = inputs[0].dtype
    for t in inputs[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    if dtype.is_floating_point:
        return [torch.einsum(eq, *[t.to(dtype) for t in inputs])]
    # integer operands: exact products in f64 (the card has no integer bmm)
    return [torch.einsum(eq, *[t.double() for t in inputs]).to(dtype)]


# ---------------------------------------------------------------------------
# Resize: jax.image.resize's weight matrices, built in numpy from the shapes
# ---------------------------------------------------------------------------

def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                   + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def _triangle(x):
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)


def _resize_weights(m: int, n: int, kernel) -> np.ndarray:
    """[m, n] f32 weights of ``jax.image``'s ``compute_weight_mat`` for an
    axis resized from m to n (translation 0, antialias on)."""
    scale = 1.0 if n == 0 else n / m
    inv = np.float32(1.0 / scale)
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x.astype(np.float32))
    total = np.sum(w, axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def _nearest_offsets(m: int, n: int) -> np.ndarray:
    return np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m)
                    / np.float32(n)).astype(np.int64)


@register("Resize", static=(1, 2, 3))
def _resize(node, inputs, ctx):
    mode = _str_attr(node, "mode", "nearest")
    x = inputs[0]
    out_shape = None
    if len(node.inputs) > 3 and node.inputs[3]:
        out_shape = _static_ints(ctx, node, node.inputs[3], "sizes")
    elif len(node.inputs) > 2 and node.inputs[2]:
        scales = ctx.as_static(inputs[2])
        if scales is None:
            raise OnnxError("Resize: scales must be static")
        scales = np.asarray(scales, np.float64).reshape(-1)
        if len(scales):
            out_shape = [int(np.floor(s * d)) for s, d in zip(scales, x.shape)]
    if out_shape is None:
        raise OnnxError("Resize: needs static sizes or scales")
    kernel = {"linear": _triangle, "cubic": _keys_cubic, "nearest": None}.get(mode, False)
    if kernel is False:
        raise OnnxError(f"Resize mode {mode} not supported")
    if len(out_shape) != x.dim():
        raise OnnxError(f"shape must have length equal to the number of dimensions of x; "
                        f" {tuple(out_shape)} vs {tuple(x.shape)}")
    if kernel is not None:
        x = _float(x)
    for d, (m, n) in enumerate(zip(x.shape, out_shape)):
        if m == n:
            continue
        if kernel is None:
            idx = _node_const(node, ctx, ("nearest", m, n), lambda: _nearest_offsets(m, n))
            x = torch.index_select(x, d, idx)
        else:
            w = _node_const(node, ctx, (mode, m, n), lambda: _resize_weights(m, n, kernel))
            x = torch.movedim(torch.tensordot(x, w.to(x.dtype), dims=([d], [0])), -1, d)
    return [x]


# ---------------------------------------------------------------------------
# Quantized-model ops
# ---------------------------------------------------------------------------

def _qparams(inputs, i_scale, i_zp):
    scale = inputs[i_scale].float()
    zp = inputs[i_zp].to(torch.int32) if len(inputs) > i_zp and inputs[i_zp] is not None else 0
    return scale, zp


def _per_axis(x, scale, zp, axis):
    if scale.dim() == 1 and scale.numel() > 1:
        shape = [1] * x.dim()
        shape[axis] = -1
        scale = scale.reshape(shape)
        if isinstance(zp, torch.Tensor) and zp.dim():
            zp = zp.reshape(shape)
    return scale, zp


def _signed(ctx, node, pos) -> bool:
    """Whether the zero point at input ``pos`` is statically int8 (the
    output saturates to [-128, 127]); otherwise [0, 255]."""
    zp = ctx.as_static(node.inputs[pos]) if len(node.inputs) > pos and node.inputs[pos] else None
    return zp is not None and zp.dtype == np.int8


def _div_scale(ctx, node, pos, x, scale):
    """``x / scale``; a static scale multiplies by its f32 reciprocal."""
    static = ctx.as_static(node.inputs[pos])
    if static is None:
        return x / scale
    return x * ctx.tensor(node, ("recip", pos), _recip(static)).reshape(scale.shape)


def _saturate(q, signed):
    lo, hi = (-128, 127) if signed else (0, 255)
    return _saturating_cast(torch.clamp(q, lo, hi), np.int32)


@register("QuantizeLinear")
def _quantize_linear(node, inputs, ctx):
    axis = node.attr("axis", 1)
    x = inputs[0].float()
    scale, zp = _per_axis(x, *_qparams(inputs, 1, 2), axis)
    q = torch.round(_div_scale(ctx, node, 1, x, scale)) + zp
    return [_saturate(q, _signed(ctx, node, 2))]


@register("DequantizeLinear")
def _dequantize_linear(node, inputs, ctx):
    axis = node.attr("axis", 1)
    x = inputs[0].float()
    scale, zp = _per_axis(x, *_qparams(inputs, 1, 2), axis)
    zp = zp.float() if isinstance(zp, torch.Tensor) else float(zp)
    return [(x - zp) * scale]


_INV_255 = float(_recip(255.0))


@register("DynamicQuantizeLinear")
def _dynamic_quantize_linear(node, inputs, ctx):
    x = inputs[0].float()
    zero = torch.zeros((), device=x.device)
    lo = torch.minimum(torch.min(x), zero)
    hi = torch.maximum(torch.max(x), zero)
    scale = (hi - lo) * _INV_255
    scale = torch.where(scale == 0, 1.0, scale)
    zp = torch.clamp(torch.round(-lo / scale), 0, 255)
    q = _saturating_cast(torch.clamp(torch.round(x / scale) + zp, 0, 255), np.int32)
    return [q, scale, _saturating_cast(zp, np.int32)]


def _exact_int_matmul(a, b):
    """The int32 product of operands that hold at most 9 bits each: exact
    in f32 while 255^2 * K < 2^24, else in f64 (no integer matmul on the
    card)."""
    k = a.shape[-1]
    dt = torch.float32 if 255 * 255 * k < (1 << 24) else torch.float64
    return torch.matmul(a.to(dt), b.to(dt)).to(torch.int32)


@register("MatMulInteger")
def _matmul_integer(node, inputs, ctx):
    a = inputs[0].to(torch.int32)
    b = inputs[1].to(torch.int32)
    if len(inputs) > 2 and inputs[2] is not None:
        a = a - inputs[2].to(torch.int32)
    if len(inputs) > 3 and inputs[3] is not None:
        b = b - inputs[3].to(torch.int32)
    return [_exact_int_matmul(a, b)]


@register("QLinearMatMul")
def _qlinear_matmul(node, inputs, ctx):
    a = inputs[0].to(torch.int32) - inputs[2].to(torch.int32)
    b = inputs[3].to(torch.int32) - inputs[5].to(torch.int32)
    y_scale = inputs[6].float()
    y = _exact_int_matmul(a, b).float() * (inputs[1].float() * inputs[4].float())
    y = _div_scale(ctx, node, 6, y, y_scale)
    return [_saturate(torch.round(y) + inputs[7].to(torch.int32), _signed(ctx, node, 7))]


# ---------------------------------------------------------------------------
# ConvTranspose
# ---------------------------------------------------------------------------

@register("ConvTranspose")
def _conv_transpose(node, inputs, ctx):
    """A convolution of the flipped, IO-swapped kernel over the input
    dilated by the strides, as ``infera_tpu``'s ``conv_general_dilated``
    with ``lhs_dilation``: full f32, TF32 off."""
    x, w = inputs[0], inputs[1]
    spatial = x.dim() - 2
    group = int(node.attr("group", 1))
    strides = tuple(node.attr("strides") or (1,) * spatial)
    dilations = tuple(node.attr("dilations") or (1,) * spatial)
    out_pad = tuple(node.attr("output_padding") or (0,) * spatial)
    pads = node.attr("pads")
    auto_pad = _str_attr(node, "auto_pad", "NOTSET")
    k = tuple(w.shape[2:])
    out_shape_attr = node.attr("output_shape")
    if out_shape_attr:
        # the total padding per the ONNX spec, split SAME_UPPER style
        pads_begin, pads_end = [], []
        for i in range(spatial):
            total = (strides[i] * (x.shape[2 + i] - 1) + out_pad[i]
                     + ((k[i] - 1) * dilations[i] + 1) - int(out_shape_attr[i]))
            total = max(total, 0)
            if auto_pad == "SAME_UPPER":
                pads_begin.append(total // 2)
                pads_end.append(total - total // 2)
            else:
                pads_begin.append(total - total // 2)
                pads_end.append(total // 2)
        pads = pads_begin + pads_end
    elif not pads:
        if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            total = [max((k[i] - 1) * dilations[i] + 1 - strides[i], 0) for i in range(spatial)]
            if auto_pad == "SAME_UPPER":
                pads = [p // 2 for p in total] + [p - p // 2 for p in total]
            else:
                pads = [p - p // 2 for p in total] + [p // 2 for p in total]
        else:
            pads = [0] * (2 * spatial)

    # the ONNX kernel is [C_in, C_out/group, *k]; the convolution takes
    # [C_out, C_in/group, *k] with the spatial dims flipped
    cin = w.shape[0]
    cout = w.shape[1] * group
    wk = w.reshape((group, cin // group, w.shape[1]) + k).transpose(1, 2)
    wk = torch.flip(wk.reshape((cout, cin // group) + k), tuple(range(2, 2 + spatial)))

    if any(s > 1 for s in strides):  # lhs dilation: s - 1 zeros between inputs
        shape = tuple(x.shape[:2]) + tuple((n - 1) * s + 1 for n, s in zip(x.shape[2:], strides))
        xd = x.new_zeros(shape)
        xd[(slice(None), slice(None)) + tuple(slice(None, None, s) for s in strides)] = x
        x = xd
    lo_hi = [(dilations[i] * (k[i] - 1) - pads[i],
              dilations[i] * (k[i] - 1) - pads[spatial + i] + out_pad[i]) for i in range(spatial)]
    for i, (lo, hi) in enumerate(lo_hi):  # negative padding crops
        d = 2 + i
        if lo < 0 or hi < 0:
            start = -lo if lo < 0 else 0
            stop = x.shape[d] + hi if hi < 0 else x.shape[d]
            x = x.narrow(d, start, max(stop - start, 0))
    pad_arg = []
    for lo, hi in reversed(lo_hi):
        pad_arg += [max(lo, 0), max(hi, 0)]
    if any(pad_arg):
        x = F.pad(x, pad_arg)
    out_sizes = [x.shape[2 + i] - (k[i] - 1) * dilations[i] for i in range(spatial)]
    if min(out_sizes) <= 0:  # the pads leave no output
        y = x.new_zeros((x.shape[0], cout) + tuple(max(n, 0) for n in out_sizes))
    else:
        y = _CONV[spatial](x, wk, None, stride=1, dilation=dilations, groups=group)
    if len(inputs) > 2 and inputs[2] is not None:
        y = y + inputs[2].reshape((1, -1) + (1,) * spatial)
    return [y]


# ---------------------------------------------------------------------------
# Host folds of data-dependent output shapes, and TfIdfVectorizer
# ---------------------------------------------------------------------------

def _require_static(ctx, node, value, what):
    arr = ctx.as_static(value)
    if arr is None:
        raise OnnxError(
            f"{node.op_type} '{node.name}': {what} must be statically known "
            f"(the op's output shape depends on the values)")
    return np.asarray(arr)


@register("NonMaxSuppression", host=True)
def _non_max_suppression(node, inputs, ctx):
    """Exact ONNX NMS of static inputs, folded on the host (numpy, as
    ``infera_tpu``); the output [num_selected, 3] depends on the values."""
    boxes = _require_static(ctx, node, node.inputs[0], "boxes")
    scores = _require_static(ctx, node, node.inputs[1], "scores")
    max_out = int(_require_static(ctx, node, node.inputs[2],
                                  "max_output_boxes_per_class").reshape(()).item()) \
        if len(node.inputs) > 2 and node.inputs[2] else 0
    iou_thr = float(np.asarray(ctx.as_static(node.inputs[3])).reshape(()).item()) \
        if len(node.inputs) > 3 and node.inputs[3] else 0.0
    score_thr = float(np.asarray(ctx.as_static(node.inputs[4])).reshape(()).item()) \
        if len(node.inputs) > 4 and node.inputs[4] else -np.inf
    center = bool(node.attr("center_point_box", 0))

    def to_corners(b):
        if not center:
            y1, x1, y2, x2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
            return (np.minimum(y1, y2), np.minimum(x1, x2),
                    np.maximum(y1, y2), np.maximum(x1, x2))
        xc, yc, w_, h_ = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        return (yc - h_ / 2, xc - w_ / 2, yc + h_ / 2, xc + w_ / 2)

    selected = []
    for bi in range(scores.shape[0]):
        y1, x1, y2, x2 = to_corners(boxes[bi])
        area = (y2 - y1) * (x2 - x1)
        for ci in range(scores.shape[1]):
            s = scores[bi, ci]
            order = np.argsort(-s, kind="stable")
            order = order[s[order] > score_thr]
            kept = []
            for idx in order:
                if max_out and len(kept) >= max_out:
                    break
                ok = True
                for j in kept:
                    yy1 = max(y1[idx], y1[j])
                    xx1 = max(x1[idx], x1[j])
                    yy2 = min(y2[idx], y2[j])
                    xx2 = min(x2[idx], x2[j])
                    inter = max(yy2 - yy1, 0.0) * max(xx2 - xx1, 0.0)
                    union = area[idx] + area[j] - inter
                    if union > 0 and inter / union > iou_thr:
                        ok = False
                        break
                if ok:
                    kept.append(int(idx))
            selected.extend((bi, ci, k) for k in kept)
    return [np.asarray(selected, np.int64).reshape(-1, 3)]


@register("Unique", host=True)
def _unique(node, inputs, ctx):
    """Exact ONNX Unique of a static input, folded on the host: Y, indices,
    inverse_indices, counts."""
    x = _require_static(ctx, node, node.inputs[0], "input")
    axis = node.attr("axis")
    flat = x.reshape(-1) if axis is None else x
    uniq, first_idx, inverse, counts = np.unique(
        flat, return_index=True, return_inverse=True, return_counts=True,
        axis=None if axis is None else int(axis))
    if not node.attr("sorted", 1):  # first-occurrence order
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        uniq = uniq[order] if axis is None else np.take(uniq, order, axis=int(axis))
        first_idx = first_idx[order]
        counts = counts[order]
        inverse = rank[inverse]
    return [uniq, first_idx.astype(np.int64),
            inverse.reshape(-1).astype(np.int64), counts.astype(np.int64)]


@register("TfIdfVectorizer")
def _tfidf_vectorizer(node, inputs, ctx):
    """N-gram counts over integer tokens: every n-gram of the pool is an
    attribute, so matching is equality of strided windows against the pool,
    summed over positions."""
    x = inputs[0]
    if x.is_floating_point() or x.is_complex() or x.dtype == torch.bool:
        raise OnnxError("TfIdfVectorizer: only integer token input is "
                        "supported (string tensors have no device analog)")
    x = x.long()
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    if x.dim() != 2:
        raise OnnxError("TfIdfVectorizer: input must be 1-D or 2-D")
    n_rows, n_cols = x.shape
    mode = node.attr("mode", "TF")
    min_g = int(node.attr("min_gram_length", 1))
    max_g = int(node.attr("max_gram_length", 1))
    max_skip = int(node.attr("max_skip_count", 0))
    ngram_counts = [int(v) for v in node.attr("ngram_counts", [])]
    ngram_indexes = [int(v) for v in node.attr("ngram_indexes", [])]
    pool = [int(v) for v in node.attr("pool_int64s", [])]
    weights = node.attr("weights")
    n_out = max(ngram_indexes) + 1 if ngram_indexes else 0
    out = torch.zeros((n_rows, n_out), dtype=torch.float32, device=x.device)
    if n_out == 0:
        return [out[0] if squeeze else out]
    w_arr = (np.ones(len(ngram_indexes), np.float32) if weights is None
             else np.asarray([float(v) for v in weights], np.float32))
    # section i of the pool holds the n-grams of length i + 1, from offset
    # ngram_counts[i]
    ngram_id = 0
    for sec, start in enumerate(ngram_counts):
        length = sec + 1
        end = ngram_counts[sec + 1] if sec + 1 < len(ngram_counts) else len(pool)
        m = (end - start) // length
        if m == 0:
            continue
        grams = ctx.tensor(node, ("grams", sec),
                           np.asarray(pool[start:end], np.int64).reshape(m, length))
        ids = ctx.tensor(node, ("ids", sec), np.asarray(ngram_indexes[ngram_id:ngram_id + m]))
        ngram_id += m
        if not (min_g <= length <= max_g):
            continue
        counts = torch.zeros((n_rows, m), dtype=torch.float32, device=x.device)
        for s in (range(max_skip + 1) if length > 1 else range(1)):
            span = (length - 1) * (s + 1)
            positions = n_cols - span
            if positions <= 0:
                continue
            idx = np.arange(positions)[:, None] + np.arange(length)[None, :] * (s + 1)
            win = x[:, ctx.tensor(node, ("win", length, s), idx)]   # [N, P, L]
            eq = (win[:, :, None, :] == grams[None, None]).all(dim=-1)  # [N, P, m]
            counts = counts + eq.sum(dim=1).float()
        wv = ctx.tensor(node, ("w", sec), w_arr[ngram_id - m:ngram_id])
        if mode == "TF":
            vals = counts
        elif mode == "IDF":
            vals = (counts > 0).float() * wv[None, :]
        elif mode == "TFIDF":
            vals = counts * wv[None, :]
        else:
            raise OnnxError(f"TfIdfVectorizer: unknown mode '{mode}'")
        out = out.index_add(1, ids, vals)
    return [out[0] if squeeze else out]
