"""ONNX operator implementations in PyTorch.

Counterpart of ``infera_tpu/onnx/ops.py``, all of it: elementwise, binary
and variadic ops, the matmul family under the model's precision policy,
shape ops, reductions and network layers, as eager torch ops on the model's
device. ``infera_tpu`` computes every one in XLA outside any Pallas kernel,
so none of them is a kernel here either; Conv and the pooling ops are torch's
(cuDNN on the card). Semantics are ``infera_tpu``'s where ONNX or torch
differ: Mod is floor-mod, integer Div divides true, Round is half to even,
Softmax uses its axis as given, Gather wraps negative indices and fills out
of range ones, SAME padding is lax's (the extra cell at the end, for
SAME_LOWER too), AveragePool divides by the cells inside the input.

Each impl has signature ``fn(node, inputs, ctx) -> list``. ``inputs`` are
the node's resolved input values: tensors on the model's device, or, for an
op registered with ``host=True`` (one that keeps numpy static values numpy,
as ``infera_tpu``'s does), the values as they are. Shape-carrying inputs
(the ``static`` positions) are read from host numpy through ``ctx``
(``_static_ints``), never from a device tensor. Matmul-class ops and Conv
run in full f32 by default (TF32 is off, see the package's ``__init__``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import OnnxError
from .proto import Node, np_dtype_for

OP_IMPLS: dict = {}


def register(op_type: str, domain: str = "", host: bool = False, static=()):
    """Register ``fn`` for ``op_type``. ``host``: the impl takes numpy
    inputs as they are; ``static``: input positions the impl reads
    statically (by name, from host numpy), which stay unconverted."""
    def deco(fn):
        fn.host = host
        fn.static = frozenset(static)
        OP_IMPLS[(domain, op_type)] = fn
        return fn

    return deco


def get_impl(domain: str, op_type: str):
    impl = OP_IMPLS.get((domain, op_type))
    if impl is None and domain in ("ai.onnx", "onnx.ai"):
        impl = OP_IMPLS.get(("", op_type))
    if impl is None:
        raise OnnxError(f"unsupported ONNX op {domain + '.' if domain else ''}{op_type}")
    return impl


def _static_ints(ctx, node: Node, value, what: str) -> list:
    """Resolve a value that must be statically known (e.g. Reshape target)."""
    arr = ctx.as_static(value)
    if arr is None:
        raise OnnxError(
            f"{node.op_type} '{node.name}': {what} must be statically known"
        )
    return [int(v) for v in np.asarray(arr).reshape(-1)]


def _node_const(node: Node, ctx, key, make) -> torch.Tensor:
    """A constant the op builds on the host from its static shapes and
    attributes (``make()``, numpy), moved to the model's device once and
    kept on the node under ``key``."""
    cache = node.__dict__.setdefault("_infera_const", {})
    full = (key, str(ctx.device))
    t = cache.get(full)
    if t is None:
        t = cache[full] = torch.as_tensor(np.ascontiguousarray(make()), device=ctx.device)
    return t


def _is_host(value) -> bool:
    return isinstance(value, np.ndarray) or np.isscalar(value)


# infera_tpu holds no f64 and no 64-bit unsigned values (JAX's x64 is off):
# on the device f64 becomes f32 (an f64 initializer must not promote an f32
# activation chain), and the unsigned widths torch has few ops for become a
# signed type that holds them. int64 stays int64.
_DEVICE_DTYPES = {np.dtype(np.float64): np.dtype(np.float32),
                  np.dtype(np.uint16): np.dtype(np.int32),
                  np.dtype(np.uint32): np.dtype(np.int64),
                  np.dtype(np.uint64): np.dtype(np.int64)}
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
                 np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
                 np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}


def device_dtype(np_dtype) -> np.dtype:
    """The numpy dtype a value of ``np_dtype`` takes on the device."""
    np_dtype = np.dtype(np_dtype)
    return _DEVICE_DTYPES.get(np_dtype, np_dtype)


def torch_dtype(np_dtype) -> torch.dtype:
    return _TORCH_DTYPES[device_dtype(np_dtype)]


# ---------------------------------------------------------------------------
# Elementwise / unary
# ---------------------------------------------------------------------------

def _unary(fn):
    return lambda node, inputs, ctx: [fn(inputs[0])]


register("Identity", host=True)(_unary(lambda x: x))
register("Relu")(_unary(torch.relu))
register("Sigmoid")(_unary(torch.sigmoid))
register("Tanh")(_unary(torch.tanh))
register("Exp")(_unary(torch.exp))
register("Log")(_unary(torch.log))
register("Sqrt")(_unary(torch.sqrt))
register("Abs")(_unary(torch.abs))
register("Neg")(_unary(torch.neg))
register("Floor")(_unary(torch.floor))
register("Ceil")(_unary(torch.ceil))
register("Round")(_unary(torch.round))  # half to even, as jnp.round
register("Erf")(_unary(torch.erf))
register("Softplus")(_unary(lambda x: torch.logaddexp(x, torch.zeros_like(x))))
register("Softsign")(_unary(lambda x: x / (torch.abs(x) + 1)))
register("Not")(_unary(torch.logical_not))
# numpy stays numpy (a static value), as ``1.0 / x`` does in infera_tpu
register("Reciprocal", host=True)(_unary(lambda x: 1.0 / x))
register("Sin")(_unary(torch.sin))
register("Cos")(_unary(torch.cos))


@register("LeakyRelu")
def _leaky_relu(node, inputs, ctx):
    alpha = node.attr("alpha", 0.01)
    return [torch.where(inputs[0] >= 0, inputs[0], alpha * inputs[0])]


@register("Elu")
def _elu(node, inputs, ctx):
    alpha = node.attr("alpha", 1.0)
    x = inputs[0]
    return [torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))]


@register("HardSigmoid")
def _hard_sigmoid(node, inputs, ctx):
    alpha = node.attr("alpha", 0.2)
    beta = node.attr("beta", 0.5)
    return [torch.clamp(alpha * inputs[0] + beta, 0.0, 1.0)]


@register("Clip")
def _clip(node, inputs, ctx):
    x = inputs[0]
    lo = node.attr("min")
    hi = node.attr("max")
    if lo is None and len(inputs) > 1 and inputs[1] is not None:
        lo = inputs[1]
    if hi is None and len(inputs) > 2 and inputs[2] is not None:
        hi = inputs[2]
    if isinstance(lo, float) or isinstance(hi, float):
        x = x.float() if not x.is_floating_point() else x
    if lo is not None:
        x = torch.clamp(x, min=lo) if isinstance(lo, float) else torch.maximum(x, lo)
    if hi is not None:
        x = torch.clamp(x, max=hi) if isinstance(hi, float) else torch.minimum(x, hi)
    return [x]


@register("Softmax")
def _softmax(node, inputs, ctx):
    axis = node.attr("axis", -1)
    return [torch.softmax(inputs[0], dim=axis)]


@register("LogSoftmax")
def _log_softmax(node, inputs, ctx):
    axis = node.attr("axis", -1)
    return [torch.log_softmax(inputs[0], dim=axis)]


@register("Cast", host=True)
def _cast(node, inputs, ctx):
    dtype = np_dtype_for(node.attr("to", 1))
    x = inputs[0]
    if _is_host(x):
        return [np.asarray(x).astype(dtype)]
    if x.is_floating_point() and np.dtype(dtype).kind in "iu":
        return [_saturating_cast(x, dtype)]
    return [x.to(torch_dtype(dtype))]


def _saturating_cast(x: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """A float tensor to the integer type ``dtype`` as XLA's convert does
    it: NaN to 0, the rest truncated toward zero and clamped to the range
    of ``dtype`` itself (uint16's, not the int32 it is carried in)."""
    info = np.iinfo(np.dtype(dtype))
    hi = min(int(info.max), int(np.iinfo(device_dtype(dtype)).max))  # uint64 is int64 here
    y = torch.trunc(x)
    out = torch.where(torch.isnan(y), 0.0, y).to(torch_dtype(dtype))
    out = torch.where(y >= float(hi + 1), hi, out)
    return torch.where(y < float(info.min), int(info.min), out)


# ---------------------------------------------------------------------------
# Binary / variadic (broadcasting as numpy's == ONNX's for opset >= 7)
# ---------------------------------------------------------------------------

def _binary(fn):
    return lambda node, inputs, ctx: [fn(inputs[0], inputs[1])]


register("Add")(_binary(torch.add))
register("Sub")(_binary(torch.sub))
register("Mul")(_binary(torch.mul))
register("Div")(_binary(torch.div))  # true division, integers too
register("Pow")(_binary(torch.pow))


@register("Mod")
def _mod(node, inputs, ctx):
    """Floor-mod as ``jnp.mod`` (the fmod attribute is ignored, as there):
    an integer divided by zero gives 0, a float NaN."""
    a, b = inputs
    if a.is_floating_point() or b.is_floating_point():
        return [torch.remainder(a, b)]
    zero = b == 0
    return [torch.where(zero, 0, torch.remainder(a, torch.where(zero, 1, b)))]


register("Equal")(_binary(torch.eq))
register("Greater")(_binary(torch.gt))
register("GreaterOrEqual")(_binary(torch.ge))
register("Less")(_binary(torch.lt))
register("LessOrEqual")(_binary(torch.le))
register("And")(_binary(torch.logical_and))
register("Or")(_binary(torch.logical_or))
register("Xor")(_binary(torch.logical_xor))
register("PRelu")(_binary(lambda x, s: torch.where(x >= 0, x, s * x)))


@register("Min")
def _min(node, inputs, ctx):
    out = inputs[0]
    for x in inputs[1:]:
        out = torch.minimum(out, x)
    return [out]


@register("Max")
def _max(node, inputs, ctx):
    out = inputs[0]
    for x in inputs[1:]:
        out = torch.maximum(out, x)
    return [out]


def _operands(node, inputs, ctx) -> list:
    """All numpy (the sum stays numpy, a static value) or all tensors."""
    if all(_is_host(x) for x in inputs):
        return inputs
    return [ctx.tensor(node, k, x) for k, x in enumerate(inputs)]


@register("Sum", host=True)
def _sum(node, inputs, ctx):
    xs = _operands(node, inputs, ctx)
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return [out]


@register("Mean", host=True)
def _mean(node, inputs, ctx):
    xs = _operands(node, inputs, ctx)
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return [out / len(xs)]


@register("Where")
def _where(node, inputs, ctx):
    cond = inputs[0] if inputs[0].dtype == torch.bool else inputs[0] != 0
    return [torch.where(cond, inputs[1], inputs[2])]


# ---------------------------------------------------------------------------
# Matmul family
# ---------------------------------------------------------------------------

def _quantize_weight_int8(node, w_np):
    """Per-output-channel symmetric int8 quantization of a static weight
    (round to nearest, channel axis last), cached on the Node; copied from
    ``infera_tpu/onnx/ops.py`` (numpy). Returns (q int8, scale f32)."""
    entry = getattr(node, "_infera_int8", None)
    if entry is None:
        w = np.asarray(w_np, np.float32)
        scale = np.max(np.abs(w), axis=tuple(range(w.ndim - 1))) / 127.0
        scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
        q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
        entry = (q, scale, {})
        node._infera_int8 = entry
    return entry


def int8_weight_tensors(node, w_np, device) -> tuple:
    """(q [K, N], scale) of ``_quantize_weight_int8`` as tensors on
    ``device``, moved there once. q is a column-major view (its transpose is
    contiguous): cuBLASLt's int8 product takes its second operand so."""
    q, scale, on_device = _quantize_weight_int8(node, w_np)
    key = str(device)
    if key not in on_device:
        q_t = torch.as_tensor(np.ascontiguousarray(q.T), device=device)
        on_device[key] = (q_t.T, torch.as_tensor(scale, device=device))
    return on_device[key]


def int8_matmul(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The int8 x int8 -> int32 product of a_q [M, K] (row-major) and w_q
    [K, N] (column-major), converted to f32 (one rounding, as XLA's convert).
    Exact by shape: on the card ``torch._int_mm`` (cuBLASLt's int8 product,
    in its "TN" layout) where its shape rules hold (more than 16 rows, K and
    N multiples of 8); elsewhere an f32 product of the integer values, exact
    while 127 * 127 * K < 2**24 (TF32 is off), or an f64 product beyond
    that."""
    m, k = a_q.shape
    if a_q.is_cuda and m > 16 and k % 8 == 0 and w_q.shape[1] % 8 == 0:
        return torch._int_mm(a_q, w_q).float()
    dt = torch.float32 if 127 * 127 * k < (1 << 24) else torch.float64
    return (a_q.to(dt) @ w_q.to(dt)).float()


def _int8_dot(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    lead = a_q.shape[:-1]
    y = int8_matmul(a_q.reshape(-1, a_q.shape[-1]), w_q)
    return y.reshape(*lead, w_q.shape[1])


def _policy_dot(node, a, b, ctx, w_np=None):
    """Matmul under the model's precision policy (executor.py ctx):

    - ``f32`` (default): full f32, the parity path.
    - ``bf16``: both operands rounded to bf16, products and sums in f32 (a
      bf16 x bf16 product is exact in f32), f32 out, as the TPU's bf16
      operands with f32 accumulation.
    - ``int8``: static per-channel weight quantization and per-tensor
      activation scales from a calibrating pass (the static path), or
      per-row activation scales before one (the dynamic path); exact int8
      products, dequantized by the scales. ``w_np`` is the weight as a
      static initializer (numpy, after any transpose); a weight that is not
      one, or not 2-D, takes the bf16 path, as in ``infera_tpu``.
    """
    prec = ctx.matmul_precision
    if prec == "f32":
        return torch.matmul(a, b)
    if prec == "int8" and w_np is not None and w_np.ndim == 2:
        a = a.float()
        if ctx.calibrating:
            # record the per-tensor activation range of this matmul input,
            # compute in f32
            amax = float(torch.max(torch.abs(a)))
            prev = getattr(node, "_infera_act_scale", 0.0) or 0.0
            node._infera_act_scale = max(prev, amax / 127.0)
            return torch.matmul(a, b.float())
        w_q, w_scale = int8_weight_tensors(node, w_np, a.device)
        act_scale = getattr(node, "_infera_act_scale", None)
        if act_scale:
            # static path: quantize by one multiply; the dequant folds the
            # activation scale into the per-channel weight scales
            inv = float(np.float32(1.0 / act_scale))
            a_q = torch.clamp(torch.round(a * inv), -127, 127).to(torch.int8)
            # an f32 product of f32 values, as infera_tpu's numpy one
            return _int8_dot(a_q, w_q) * (w_scale * float(np.float32(act_scale)))
        # dynamic path (no calibration yet): per-row abs-max scales; the
        # divisions are tensor by tensor, so no reciprocal multiply stands in
        amax = torch.amax(torch.abs(a), dim=-1, keepdim=True)
        a_scale = amax / torch.full_like(amax, 127.0)
        a_scale = torch.where(a_scale == 0, torch.ones_like(a_scale), a_scale)
        a_q = torch.clamp(torch.round(a / a_scale), -127, 127).to(torch.int8)
        return _int8_dot(a_q, w_q) * a_scale * w_scale
    return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


@register("MatMul")
def _matmul(node, inputs, ctx):
    a, b = inputs
    return [_policy_dot(node, a, b, ctx, ctx.as_static(node.inputs[1]))]


@register("Gemm")
def _gemm(node, inputs, ctx):
    a = inputs[0]
    b = inputs[1]
    alpha = node.attr("alpha", 1.0)
    beta = node.attr("beta", 1.0)
    w_np = ctx.as_static(node.inputs[1])
    if node.attr("transA", 0):
        a = a.T
    if node.attr("transB", 0):
        b = b.T
        w_np = None if w_np is None else w_np.T
    y = _policy_dot(node, a, b, ctx, w_np)
    if alpha != 1.0:
        y = alpha * y
    if len(inputs) > 2 and inputs[2] is not None:
        c = inputs[2]
        y = y + (beta * c if beta != 1.0 else c)
    return [y]


# ---------------------------------------------------------------------------
# Shape manipulation
# ---------------------------------------------------------------------------

@register("Reshape", static=(1,))
def _reshape(node, inputs, ctx):
    x = inputs[0]
    target = (_static_ints(ctx, node, node.inputs[1], "shape input")
              if len(node.inputs) > 1 else node.attr("shape"))
    if target is None:
        raise OnnxError(f"Reshape '{node.name}': missing shape")
    shape = []
    for i, d in enumerate(target):
        if d == 0 and not node.attr("allowzero", 0):
            shape.append(x.shape[i])
        else:
            shape.append(d)
    # Fixed-batch generalization: a model exported with a hard-coded batch
    # dim runs a bigger batch with dim 0 freed, so the row count flows
    # through (as infera_tpu does)
    if (
        shape
        and shape[0] not in (-1, x.shape[0])
        and -1 not in shape
        and int(np.prod(shape)) != int(np.prod(x.shape))
    ):
        shape[0] = -1
    return [torch.reshape(x, shape)]


@register("Flatten")
def _flatten(node, inputs, ctx):
    axis = node.attr("axis", 1)
    x = inputs[0]
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return [torch.reshape(x, (lead, -1))]


@register("Transpose")
def _transpose(node, inputs, ctx):
    perm = node.attr("perm")
    x = inputs[0]
    if perm is None:
        perm = list(reversed(range(x.dim())))
    return [x.permute(perm)]


@register("Concat")
def _concat(node, inputs, ctx):
    return [torch.cat(inputs, dim=node.attr("axis", 0))]


@register("Split", static=(1,))
def _split(node, inputs, ctx):
    x = inputs[0]
    axis = node.attr("axis", 0)
    if len(node.inputs) > 1:
        sizes = _static_ints(ctx, node, node.inputs[1], "split sizes")
    else:
        sizes = node.attr("split")
    if sizes is None:
        n = len(node.outputs)
        sizes = [x.shape[axis] // n] * n
    offsets = np.cumsum([0] + list(sizes))
    return [x.narrow(axis, int(offsets[i]), int(sizes[i])) for i in range(len(sizes))]


@register("Squeeze", static=(1,))
def _squeeze(node, inputs, ctx):
    x = inputs[0]
    if len(node.inputs) > 1:
        axes = _static_ints(ctx, node, node.inputs[1], "axes")
    else:
        axes = node.attr("axes")
    if axes is None:
        return [torch.squeeze(x)]
    axes = tuple(a % x.dim() for a in axes)
    if any(x.shape[a] != 1 for a in axes):  # torch would keep such a dim
        raise ValueError(f"cannot squeeze axes {axes} of shape {tuple(x.shape)}: "
                         "size not equal to one")
    return [torch.squeeze(x, dim=axes)]


@register("Unsqueeze", static=(1,))
def _unsqueeze(node, inputs, ctx):
    x = inputs[0]
    if len(node.inputs) > 1:
        axes = _static_ints(ctx, node, node.inputs[1], "axes")
    else:
        axes = node.attr("axes")
    out_rank = x.dim() + len(axes)
    for a in sorted(a % out_rank for a in axes):
        x = torch.unsqueeze(x, a)
    return [x]


def _slice_axis(x: torch.Tensor, ax: int, st: int, en: int, sp: int) -> torch.Tensor:
    """``x[..., st:en:sp, ...]`` on axis ``ax`` with Python's (numpy's)
    slice semantics; torch's basic indexing refuses negative steps, so a
    negative step takes the ascending slice and flips it."""
    r = range(*slice(st, en, sp).indices(x.shape[ax]))
    idx = [slice(None)] * x.dim()
    if sp > 0 or len(r) == 0:
        idx[ax] = slice(r.start, r.stop, sp) if len(r) else slice(0, 0)
        return x[tuple(idx)]
    idx[ax] = slice(r[-1], r[0] + 1, -sp)
    return torch.flip(x[tuple(idx)], (ax,))


@register("Slice", host=True)
def _slice(node, inputs, ctx):
    x = inputs[0]
    if len(node.inputs) > 1:
        starts = _static_ints(ctx, node, node.inputs[1], "starts")
        ends = _static_ints(ctx, node, node.inputs[2], "ends")
        axes = (
            _static_ints(ctx, node, node.inputs[3], "axes")
            if len(node.inputs) > 3 and node.inputs[3]
            else list(range(len(starts)))
        )
        steps = (
            _static_ints(ctx, node, node.inputs[4], "steps")
            if len(node.inputs) > 4 and node.inputs[4]
            else [1] * len(starts)
        )
    else:
        starts = node.attr("starts")
        ends = node.attr("ends")
        axes = node.attr("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    ndim = np.ndim(x) if _is_host(x) else x.dim()
    bounds = []
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = ax % ndim
        dim = x.shape[ax]
        if st < 0:
            st += dim
        if en < 0:
            en += dim
        en = min(en, dim)
        st = max(min(st, dim), 0)
        bounds.append((ax, st, en, sp))
    if _is_host(x):  # numpy stays numpy (a static value)
        slices = [slice(None)] * ndim
        for ax, st, en, sp in bounds:
            slices[ax] = slice(st, en, sp)
        return [np.asarray(x)[tuple(slices)]]
    for ax, st, en, sp in bounds:
        x = _slice_axis(x, ax, st, en, sp)
    return [x]


# what jnp.take / take_along_axis return for an index out of range
def _fill_value(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    if dtype == torch.uint8:
        return 255
    # infera_tpu's int64 values are int32
    return -(1 << 31) if dtype in (torch.int32, torch.int64) else -(1 << (torch.iinfo(dtype).bits - 1))


def _wrap_indices(idx: torch.Tensor, n: int):
    """(indices wrapped into [0, n), mask of the ones in [-n, n))."""
    idx = idx.long()
    valid = (idx >= -n) & (idx < n)
    return torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0)), valid


@register("Gather")
def _gather(node, inputs, ctx):
    x, idx = inputs
    axis = node.attr("axis", 0) % x.dim()
    n = x.shape[axis]
    static = ctx.as_static(node.inputs[1])
    if static is not None:
        static = static.astype(np.int64)
    if static is not None and np.all((static >= -n) & (static < n)):
        # indices known on the host and in range: wrap them once, no mask
        j = ctx.tensor(node, "wrapped", np.where(static < 0, static + n, static))
        valid = None
    else:
        j, valid = _wrap_indices(idx, n)
    out = torch.index_select(x, axis, j.reshape(-1))
    out = out.reshape(x.shape[:axis] + j.shape + x.shape[axis + 1:])
    if valid is not None:
        mask = valid.reshape((1,) * axis + valid.shape + (1,) * (x.dim() - axis - 1))
        out = torch.where(mask, out, _fill_value(out.dtype))
    return [out]


@register("GatherElements")
def _gather_elements(node, inputs, ctx):
    x, idx = inputs
    axis = node.attr("axis", 0) % x.dim()
    j, valid = _wrap_indices(idx, x.shape[axis])
    # the other axes broadcast against each other, as in take_along_axis
    shape = list(torch.broadcast_shapes(x.shape[:axis] + (1,) + x.shape[axis + 1:],
                                        j.shape[:axis] + (1,) + j.shape[axis + 1:]))
    shape[axis] = j.shape[axis]
    j, valid = j.expand(shape), valid.expand(shape)
    xshape = list(shape)
    xshape[axis] = x.shape[axis]
    out = torch.gather(x.expand(xshape), axis, j)
    return [torch.where(valid, out, _fill_value(out.dtype))]


@register("Expand", static=(1,))
def _expand(node, inputs, ctx):
    x = inputs[0]
    target = _static_ints(ctx, node, node.inputs[1], "shape")
    # ONNX Expand broadcasts; target dims of 1 keep input size
    shape = list(np.broadcast_shapes(tuple(x.shape), tuple(target)))
    return [torch.broadcast_to(x, shape)]


@register("Tile", static=(1,))
def _tile(node, inputs, ctx):
    reps = _static_ints(ctx, node, node.inputs[1], "repeats")
    return [torch.tile(inputs[0], reps)]


@register("Shape", host=True)
def _shape(node, inputs, ctx):
    start = node.attr("start", 0)
    end = node.attr("end")
    shp = tuple(inputs[0].shape)
    shp = shp[start:end] if end is not None else shp[start:]
    return [np.asarray(shp, dtype=np.int64)]


@register("Size", host=True)
def _size(node, inputs, ctx):
    return [np.asarray(int(np.prod(inputs[0].shape)), dtype=np.int64)]


@register("Constant", host=True)
def _constant(node, inputs, ctx):
    t = node.attr("value")
    if t is not None:
        return [np.asarray(t.array)]
    for key, cast in (
        ("value_float", np.float32),
        ("value_int", np.int64),
    ):
        v = node.attr(key)
        if v is not None:
            return [np.asarray(v, dtype=cast)]
    v = node.attr("value_floats")
    if v is not None:
        return [np.asarray(v, dtype=np.float32)]
    v = node.attr("value_ints")
    if v is not None:
        return [np.asarray(v, dtype=np.int64)]
    raise OnnxError(f"Constant '{node.name}': unsupported payload")


@register("ConstantOfShape", static=(0,))
def _constant_of_shape(node, inputs, ctx):
    shape = _static_ints(ctx, node, node.inputs[0], "shape")
    t = node.attr("value")
    if t is not None:
        fill = np.asarray(t.array).reshape(-1)[0].item()
        dtype = torch_dtype(t.array.dtype)
    else:
        fill, dtype = 0.0, torch.float32
    return [torch.full(shape, fill, dtype=dtype, device=ctx.device)]


@register("Range", host=True)
def _range(node, inputs, ctx):
    start = _static_ints(ctx, node, node.inputs[0], "start")[0]
    limit = _static_ints(ctx, node, node.inputs[1], "limit")[0]
    delta = _static_ints(ctx, node, node.inputs[2], "delta")[0]
    return [np.arange(start, limit, delta, dtype=np.int64)]


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

def _reduce(fn, over_none):
    """``fn(x, dims, keepdim)`` over the axes of the attribute or the
    static input (none: all axes). ``over_none(x)`` is the reduction over an
    empty axis list, which ``infera_tpu`` applies as given (no axis reduced)."""
    def impl(node, inputs, ctx):
        x = inputs[0]
        if len(node.inputs) > 1 and node.inputs[1]:
            axes = _static_ints(ctx, node, node.inputs[1], "axes")
        else:
            axes = node.attr("axes")
        keepdim = bool(node.attr("keepdims", 1))
        dims = (tuple(a % x.dim() for a in axes) if axes is not None
                else tuple(range(x.dim())))
        return [fn(x, dims, keepdim) if dims else over_none(x)]

    return impl


def _float(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.float()


def _prod(x, dims, keepdim):
    if len(set(dims)) != len(dims):
        raise ValueError(f"repeated axis in {dims}")
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _sum_over_none(x):
    return x.long() if x.dtype == torch.bool else x


register("ReduceSum", static=(1,))(_reduce(
    lambda x, d, k: torch.sum(x, dim=d, keepdim=k), _sum_over_none))
register("ReduceMean", static=(1,))(_reduce(
    lambda x, d, k: torch.mean(_float(x), dim=d, keepdim=k), _float))
register("ReduceMax", static=(1,))(_reduce(
    lambda x, d, k: torch.amax(x, dim=d, keepdim=k), lambda x: x))
register("ReduceMin", static=(1,))(_reduce(
    lambda x, d, k: torch.amin(x, dim=d, keepdim=k), lambda x: x))
register("ReduceProd", static=(1,))(_reduce(_prod, _sum_over_none))
register("ReduceL2", static=(1,))(_reduce(
    lambda x, d, k: torch.sqrt(torch.sum(x * x, dim=d, keepdim=k)), lambda x: torch.sqrt(x * x)))
register("ReduceLogSumExp", static=(1,))(_reduce(
    lambda x, d, k: torch.logsumexp(_float(x), dim=d, keepdim=k), _float))


@register("ArgMax")
def _argmax(node, inputs, ctx):
    return [torch.argmax(inputs[0], dim=node.attr("axis", 0),
                         keepdim=bool(node.attr("keepdims", 1)))]


@register("ArgMin")
def _argmin(node, inputs, ctx):
    return [torch.argmin(inputs[0], dim=node.attr("axis", 0),
                         keepdim=bool(node.attr("keepdims", 1)))]


# ---------------------------------------------------------------------------
# NN layers
# ---------------------------------------------------------------------------

def _same_pads(in_sizes, window, strides) -> list:
    """lax's "SAME" padding, which ``infera_tpu`` uses for SAME_UPPER and
    SAME_LOWER alike: out = ceil(in / stride), the odd cell at the end."""
    pads = []
    for n, w, s in zip(in_sizes, window, strides):
        total = max((-(-n // s) - 1) * s + w - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_arg(pads) -> list:
    """[(lo, hi)] per spatial dim to F.pad's order (last dim first)."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _explicit_pads(node, spatial, window, strides, in_sizes) -> list:
    pads = node.attr("pads")
    if node.attr("auto_pad", "NOTSET") in ("SAME_UPPER", "SAME_LOWER"):
        return _same_pads(in_sizes, window, strides)
    if pads:
        return [(pads[i], pads[i + spatial]) for i in range(spatial)]
    return [(0, 0)] * spatial


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Conv")
def _conv(node, inputs, ctx):
    """Full f32 at every precision policy (``infera_tpu`` runs Conv at
    HIGHEST, not under the matmul policy); TF32 stays off."""
    x, w = inputs[0], inputs[1]
    b = inputs[2] if len(inputs) > 2 else None
    spatial = x.dim() - 2
    strides = tuple(node.attr("strides") or (1,) * spatial)
    dilations = tuple(node.attr("dilations") or (1,) * spatial)
    window = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilations)]
    pads = _explicit_pads(node, spatial, window, strides, x.shape[2:])
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        x = F.pad(x, _pad_arg(pads))
        padding = 0
    return [_CONV[spatial](x, w, b, stride=strides, padding=padding,
                           dilation=dilations, groups=node.attr("group", 1))]


@register("BatchNormalization")
def _batchnorm(node, inputs, ctx):
    x, scale, bias, mean, var = inputs[:5]
    eps = node.attr("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(var + eps)
    return [(x - mean.reshape(shape)) * (inv * scale).reshape(shape) + bias.reshape(shape)]


@register("GlobalAveragePool")
def _global_avg_pool(node, inputs, ctx):
    x = inputs[0]
    return [torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)]


@register("GlobalMaxPool")
def _global_max_pool(node, inputs, ctx):
    x = inputs[0]
    return [torch.amax(x, dim=tuple(range(2, x.dim())), keepdim=True)]


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_SUM_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_sum(x, kernel, strides):
    """Sum over each window (no padding); 1-D runs as 2-D with a unit dim."""
    if len(kernel) == 1:
        y = F.avg_pool2d(x.unsqueeze(-1), (kernel[0], 1), (strides[0], 1), divisor_override=1)
        return y.squeeze(-1)
    return _SUM_POOL[len(kernel)](x, kernel, strides, divisor_override=1)


def _pool(is_avg):
    def impl(node, inputs, ctx):
        x = inputs[0]
        spatial = x.dim() - 2
        kernel = tuple(node.attr("kernel_shape"))
        strides = tuple(node.attr("strides") or (1,) * spatial)
        pads = _explicit_pads(node, spatial, kernel, strides, x.shape[2:])
        if not is_avg:  # padding cells never win the max
            xp = F.pad(x, _pad_arg(pads), value=float("-inf")) if any(map(any, pads)) else x
            return [_MAX_POOL[spatial](xp, kernel, strides)]
        xp = F.pad(x, _pad_arg(pads)) if any(map(any, pads)) else x
        # the denominator counts only the cells inside the input; it depends
        # on the shapes alone, so it is computed once per shape
        cache = node.__dict__.setdefault("_infera_denom", {})
        key = (tuple(x.shape[2:]), str(x.device), x.dtype)
        denom = cache.get(key)
        if denom is None:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
            denom = _window_sum(F.pad(ones, _pad_arg(pads)), kernel, strides)
            cache[key] = denom
        return [_window_sum(xp, kernel, strides) / denom]

    return impl


register("MaxPool")(_pool(False))
register("AveragePool")(_pool(True))


@register("Dropout", host=True)
def _dropout(node, inputs, ctx):
    # Inference mode: identity (optionally also emits an all-true mask).
    outs = [inputs[0]]
    if len(node.outputs) > 1:
        outs.append(torch.ones(tuple(inputs[0].shape), dtype=torch.bool, device=ctx.device))
    return outs


@register("LayerNormalization")
def _layernorm(node, inputs, ctx):
    """``infera_tpu``'s two passes (mean, then the mean of squared
    deviations), with the mean and inverse std as the extra outputs."""
    x = inputs[0]
    scale = inputs[1]
    bias = inputs[2] if len(inputs) > 2 and inputs[2] is not None else None
    axis = node.attr("axis", -1)
    eps = node.attr("epsilon", 1e-5)
    dims = tuple(range(axis % x.dim(), x.dim()))
    mean = torch.mean(x, dim=dims, keepdim=True)
    d = x - mean
    var = torch.mean(d * d, dim=dims, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = d * inv * scale
    if bias is not None:
        y = y + bias
    outs = [y]
    if len(node.outputs) > 1:
        outs.append(mean)
    if len(node.outputs) > 2:
        outs.append(inv)
    return outs


@register("Gelu")
def _gelu(node, inputs, ctx):
    approx = node.attr("approximate", "none")
    if isinstance(approx, bytes):
        approx = approx.decode()
    x = inputs[0]
    if approx == "tanh":
        return [F.gelu(x, approximate="tanh")]
    # jax.nn.gelu's exact form: +inf gives +inf where F.gelu gives NaN
    return [0.5 * x * torch.erfc(x * -math.sqrt(0.5))]


@register("LRN")
def _lrn(node, inputs, ctx):
    x = inputs[0]
    size = node.attr("size")
    alpha = node.attr("alpha", 1e-4)
    beta = node.attr("beta", 0.75)
    bias = node.attr("bias", 1.0)
    half = size // 2
    padded = F.pad(x * x, [0, 0] * (x.dim() - 2) + [half, size - 1 - half])
    acc = sum(padded.narrow(1, i, x.shape[1]) for i in range(size))
    return [x / torch.pow(bias + (alpha / size) * acc, beta)]
