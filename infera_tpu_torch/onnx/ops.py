"""ONNX operator implementations in PyTorch.

Counterpart of ``infera_tpu/onnx/ops.py``. This slice carries the ops that
``onnx.builder``'s ``linear``, ``multi_output`` and ``mlp_model`` graphs use:
MatMul, Gemm, Add, Relu, Softmax and Identity. The rest of the op set comes
in later slices.

Each impl has signature ``fn(node, inputs, ctx) -> list[torch.Tensor]``,
where ``inputs`` are the node's resolved input values (tensors on the
model's device) and ``ctx`` carries the model's matmul precision policy.
Matmul-class ops run in full f32 (TF32 is off, see the package's
``__init__``): the parity tests pin results to 1e-5.
"""

from __future__ import annotations

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


def _policy_dot(node, a, b, ctx):
    """Matmul under the model's precision policy (executor.py ctx):

    - ``f32`` (default): full f32, the parity path.
    - ``bf16``: both operands rounded to bf16, products and sums in f32 (a
      bf16 x bf16 product is exact in f32), f32 out, as the TPU's bf16
      operands with f32 accumulation.

    ``int8`` is refused at load in this slice (executor.py)."""
    if ctx.matmul_precision == "f32":
        return torch.matmul(a, b)
    return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


@register("MatMul")
def _matmul(node, inputs, ctx):
    a, b = inputs
    return [_policy_dot(node, a, b, ctx)]


@register("Gemm")
def _gemm(node, inputs, ctx):
    a = inputs[0]
    b = inputs[1]
    alpha = node.attr("alpha", 1.0)
    beta = node.attr("beta", 1.0)
    if node.attr("transA", 0):
        a = a.T
    if node.attr("transB", 0):
        b = b.T
    y = _policy_dot(node, a, b, ctx)
    if alpha != 1.0:
        y = alpha * y
    if len(inputs) > 2 and inputs[2] is not None:
        c = inputs[2]
        y = y + (beta * c if beta != 1.0 else c)
    return [y]
