"""ONNX operator implementations in PyTorch.

Counterpart of ``infera_tpu/onnx/ops.py``. This slice carries the ops that
``onnx.builder``'s ``linear``, ``multi_output`` and ``mlp_model`` graphs use:
MatMul, Gemm, Add, Relu, Softmax and Identity. The rest of the op set comes
in later slices.

Each impl has signature ``fn(node, inputs, ctx) -> list[torch.Tensor]``,
where ``inputs`` are the node's resolved input values (tensors on the
model's device) and ``ctx`` carries the model's matmul precision policy and
its static initializers. Matmul-class ops run in full f32 by default (TF32
is off, see the package's ``__init__``): the parity tests pin results to
1e-5.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import OnnxError

OP_IMPLS: dict = {}


def register(op_type: str, domain: str = ""):
    def deco(fn):
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


def _unary(fn):
    return lambda node, inputs, ctx: [fn(inputs[0])]


register("Identity")(_unary(lambda x: x))
register("Relu")(_unary(torch.relu))


@register("Softmax")
def _softmax(node, inputs, ctx):
    axis = node.attr("axis", -1)
    return [torch.softmax(inputs[0], dim=axis)]


@register("Add")
def _add(node, inputs, ctx):
    return [torch.add(inputs[0], inputs[1])]


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
    return [_policy_dot(node, a, b, ctx, ctx.static(node.inputs[1]))]


@register("Gemm")
def _gemm(node, inputs, ctx):
    a = inputs[0]
    b = inputs[1]
    alpha = node.attr("alpha", 1.0)
    beta = node.attr("beta", 1.0)
    w_np = ctx.static(node.inputs[1])
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
