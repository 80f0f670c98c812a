"""The port's ONNX op set against ``infera_tpu``'s, one small graph a case.

Each case is a graph of one node (or a few, where a static value has to flow
from one op to the next), serialized once and compiled from the same bytes
by both packages; the same inputs, made from a numpy seed, go through
``infera_tpu`` (XLA on the CPU) and the port (torch on the CPU). Every
registration of ``infera_tpu/onnx/ops.py`` and ``control_flow.py`` has a
case, with the attribute and input forms and the traps where ONNX, torch
and ``infera_tpu`` differ (floor-mod, integer Div, negative Slice steps and
out-of-range bounds, Gather's negative and out-of-range indices, lax's SAME
padding, AveragePool's count, the fixed-batch Reshape, static values).

Tolerances (relative to each value, and to the output's largest magnitude
for values near zero): elementwise and shape ops exact; transcendentals
1e-6 relative (XLA's and torch's implementations differ in the last bits),
and so are the chains that XLA on the CPU computes with one rounding fewer
(it contracts ``alpha * x + beta`` into one FMA and turns a division by a
constant into a product with its reciprocal: HardSigmoid, HardSwish, Mean);
MatMul, Conv, pooling, normalisation and reductions 1e-5 (the repo's parity
bound: their sums run in another order). Where ``infera_tpu`` refuses a
graph the port raises ``OnnxError`` with the same message prefix.

The cases import no JAX at module level: ``test_torch_cuda_onnx.py`` runs
them on the card against the port on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import pytest

from infera_tpu_torch.errors import OnnxError
from infera_tpu_torch.onnx.executor import compile_model_bytes as port_compile
from infera_tpu_torch.onnx.proto import (
    Attribute,
    DataType,
    Graph,
    Model,
    Node,
    Tensor,
    ValueInfo,
)
from infera_tpu_torch.onnx.proto import _DT_FROM_NP

EXACT, TRANSCENDENTAL, SUMS = 0.0, 1e-6, 1e-5
ROUNDING = TRANSCENDENTAL  # XLA's FMA contraction and reciprocal products

RNG = np.random.default_rng(20261018)


def f32(*shape, lo=-3.0, hi=3.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def i64(*shape, lo=-9, hi=10):
    return RNG.integers(lo, hi, shape).astype(np.int64)


def bools(*shape):
    return RNG.random(shape) < 0.5


def node(op, ins, outs=("Y",), name=None, **attrs):
    return Node(op_type=op, inputs=list(ins), outputs=list(outs), name=name or op.lower(),
                attributes={k: Attribute.make(k, v) for k, v in attrs.items()})


def vi(name, arr=None, shape=None, dt=DataType.FLOAT):
    if arr is not None:
        return ValueInfo(name=name, elem_type=_DT_FROM_NP[np.asarray(arr).dtype],
                         shape=list(np.shape(arr)))
    return ValueInfo(name=name, elem_type=dt, shape=list(shape))


def graph(nodes, feeds=(), inits=None, outputs=("Y",), name="g", out_vis=None):
    return Graph(
        name=name, nodes=list(nodes),
        initializers={k: Tensor.from_array(k, np.asarray(v)) for k, v in (inits or {}).items()},
        inputs=[vi(k, v) for k, v in feeds],
        outputs=out_vis or [vi(o, shape=[-1]) for o in outputs])


@dataclass
class Case:
    nodes: list
    feeds: dict
    inits: dict = field(default_factory=dict)
    outputs: tuple = ("Y",)
    tol: float = EXACT
    refuse: str | None = None  # the message prefix both packages raise
    signed_zeros: bool = False  # zeros must keep their sign too
    # the port's output where infera_tpu's 64-bit values are int32 (x64 is
    # off there: ROADMAP Queue 3, "64-bit values"), and the positions where
    # infera_tpu's int32 differs from it
    expect: np.ndarray | None = None
    x64: tuple = ()

    def model(self) -> Model:
        return Model(graph=graph(self.nodes, self.feeds.items(), self.inits, self.outputs),
                     opset_imports=[("", 17)])


CASES: dict = {}


def add(cid, nodes, feeds, inits=None, outputs=("Y",), tol=EXACT, refuse=None, **kw):
    assert cid not in CASES, cid
    nodes = nodes if isinstance(nodes, list) else [nodes]
    CASES[cid] = Case(nodes, dict(feeds), dict(inits or {}), tuple(outputs), tol, refuse, **kw)


def unary(op, x, tol=EXACT, **attrs):
    add(op if not attrs else f"{op}-{'-'.join(attrs)}", node(op, ["X"], **attrs), {"X": x}, tol=tol)


# --- elementwise / unary ----------------------------------------------------
X = f32(3, 5)
POS = f32(3, 5, lo=0.1, hi=4.0)
UNIT = f32(3, 5, lo=-0.95, hi=0.95)
HALVES = np.asarray([[-2.5, -1.5, -0.5, 0.5, 1.5], [2.5, 3.5, -3.49, 0.49, 7.0]], np.float32)
for op in ("Identity", "Relu", "Abs", "Neg", "Floor", "Ceil", "Sign", "Softsign", "Reciprocal"):
    unary(op, X)
unary("HardSwish", X, ROUNDING)
unary("Round", HALVES)  # half to even
unary("IsNaN", np.asarray([1.0, np.nan, -np.inf, 0.0], np.float32))
unary("Not", bools(4, 3))
add("Abs-int", node("Abs", ["X"]), {"X": i64(4, 3)})
add("Neg-int", node("Neg", ["X"]), {"X": i64(4, 3)})
for op in ("Sigmoid", "Tanh", "Exp", "Erf", "Softplus", "Sin", "Cos", "Tan", "Atan", "Sinh",
           "Cosh", "Asinh", "Mish"):
    unary(op, X, TRANSCENDENTAL)
for op in ("Log", "Sqrt"):
    unary(op, POS, TRANSCENDENTAL)
for op in ("Asin", "Acos", "Atanh"):
    unary(op, UNIT, TRANSCENDENTAL)
unary("Acosh", f32(3, 5, lo=1.0, hi=4.0), TRANSCENDENTAL)
unary("LeakyRelu", X)
unary("LeakyRelu", X, alpha=0.2)
unary("Elu", X, TRANSCENDENTAL)
unary("Elu", X, TRANSCENDENTAL, alpha=0.5)
unary("HardSigmoid", X, ROUNDING)
unary("HardSigmoid", X, ROUNDING, alpha=0.3, beta=0.4)
unary("Clip", X, min=-1.0, max=2.0)
add("Clip-inputs", node("Clip", ["X", "lo", "hi"]), {"X": X},
    {"lo": np.float32(-0.5), "hi": np.float32(1.25)})
add("Clip-min-input-only", node("Clip", ["X", "lo"]), {"X": X}, {"lo": np.float32(0.0)})
add("Clip-max-input-only", node("Clip", ["X", "", "hi"]), {"X": X}, {"hi": np.float32(0.0)})
add("Clip-none", node("Clip", ["X"]), {"X": X})
X3 = f32(2, 3, 4)
unary("Softmax", X3, TRANSCENDENTAL)
unary("Softmax", X3, TRANSCENDENTAL, axis=1)  # the axis as given, no flattening
unary("LogSoftmax", X3, TRANSCENDENTAL)
unary("LogSoftmax", X3, TRANSCENDENTAL, axis=0)
SMALL = f32(3, 4, lo=0.0, hi=100.0)
for dt in (DataType.FLOAT, DataType.UINT8, DataType.INT8, DataType.UINT16, DataType.INT16,
           DataType.INT32, DataType.INT64, DataType.BOOL, DataType.FLOAT16, DataType.DOUBLE,
           DataType.UINT32, DataType.UINT64):
    add(f"Cast-to-{dt}", node("Cast", ["X"], to=dt), {"X": SMALL})
add("Cast-int-to-float", node("Cast", ["X"], to=DataType.FLOAT), {"X": i64(3, 4)})
add("Cast-bool-to-float", node("Cast", ["X"], to=DataType.FLOAT), {"X": bools(3, 4)})
# edge values: NaN, infinities, signed zeros, out-of-range casts, zero divisors
EDGE = np.asarray([np.nan, np.inf, -np.inf, -1.5, 300, -300, 70000, 3e9, -3e9], np.float32)
add("Sign-edges", node("Sign", ["X"]), {"X": np.asarray([np.nan, -0.0, 0.0, -2.0, np.inf], np.float32)},
    signed_zeros=True)
add("Gelu-edges", node("Gelu", ["X"]), {"X": np.asarray([np.inf, -np.inf, np.nan], np.float32)})
for dt in (DataType.INT8, DataType.UINT8, DataType.INT16, DataType.UINT16, DataType.INT32):
    add(f"Cast-saturates-to-{dt}", node("Cast", ["X"], to=dt), {"X": EDGE})
add("Cast-saturates-to-int64", node("Cast", ["X"], to=DataType.INT64), {"X": EDGE},
    expect=np.asarray([0, 2**63 - 1, -2**63, -1, 300, -300, 70000, 3 * 10**9, -3 * 10**9]),
    x64=(1, 2, 7, 8))
add("Mod-int-by-zero", node("Mod", ["A", "B"]),
    {"A": np.asarray([7, -7, 0, 5, -9, 3], np.int32), "B": np.asarray([0, 0, 0, -2, 4, -1], np.int32)})
add("Mod-int64-by-zero", node("Mod", ["A", "B"]),
    {"A": np.asarray([2**40, -2**40], np.int64), "B": np.asarray([3, 0], np.int64)},
    expect=np.asarray([1, 0]), x64=(0,))
add("Mod-float-by-zero", node("Mod", ["A", "B"]),
    {"A": np.asarray([7.0, -7.0, 0.0], np.float32), "B": np.zeros(3, np.float32)})
# a static Cast (numpy .astype) stays static: it can be a Reshape target
add("Cast-static-reshape-target",
    [node("Cast", ["tf"], ["t"], to=DataType.INT64), node("Reshape", ["X", "t"])],
    {"X": X}, {"tf": np.asarray([5, -1], np.float32)})

# --- binary / variadic --------------------------------------------------------
A, B = f32(2, 3, 4), f32(2, 3, 4)
for op in ("Add", "Sub", "Mul", "Div", "Equal", "Greater", "GreaterOrEqual", "Less",
           "LessOrEqual", "Min", "Max"):
    add(op, node(op, ["A", "B"]), {"A": A, "B": B})
add("Add-broadcast", node("Add", ["A", "b"]), {"A": A}, {"b": f32(4)})
add("Mul-scalar-init", node("Mul", ["A", "s"]), {"A": A}, {"s": np.float32(0.125)})
add("Mul-f64-init-stays-f32", node("Mul", ["A", "s"]), {"A": A},
    {"s": np.asarray([0.1, 0.2, 0.3, 0.4], np.float64)})
add("Sub-int", node("Sub", ["A", "B"]), {"A": i64(3, 4), "B": i64(3, 4)})
IA, IB = i64(4, 5), i64(4, 5, lo=1, hi=6) * np.where(RNG.random((4, 5)) < 0.5, -1, 1)
add("Div-int-true-division", node("Div", ["A", "B"]), {"A": IA, "B": IB})
add("Mod-int-negative", node("Mod", ["A", "B"]), {"A": IA, "B": IB})
add("Mod-float-negative", node("Mod", ["A", "B"]),
    {"A": f32(4, 5, lo=-7, hi=7), "B": np.where(RNG.random((4, 5)) < 0.5, -2.5, 1.5).astype(np.float32)})
add("Mod-fmod-attr-ignored", node("Mod", ["A", "B"], fmod=1), {"A": IA, "B": IB})
add("Pow", node("Pow", ["A", "B"]), {"A": f32(3, 4, lo=0.1, hi=3.0), "B": f32(3, 4)}, tol=TRANSCENDENTAL)
add("Pow-int-exponent", node("Pow", ["A", "e"]), {"A": f32(3, 4)}, {"e": np.int64(3)}, tol=TRANSCENDENTAL)
add("Pow-int", node("Pow", ["A", "B"]), {"A": i64(3, 4), "B": i64(3, 4, lo=0, hi=4)})
add("Equal-int-ties", node("Equal", ["A", "B"]), {"A": i64(6, 5, lo=0, hi=3), "B": i64(6, 5, lo=0, hi=3)})
for op in ("And", "Or", "Xor"):
    add(op, node(op, ["A", "B"]), {"A": bools(3, 4), "B": bools(3, 4)})
add("PRelu", node("PRelu", ["A", "s"]), {"A": A}, {"s": f32(3, 1)})
C3 = f32(3, 4)
for op in ("Min", "Max", "Sum", "Mean"):
    add(f"{op}-variadic", node(op, ["A", "B", "C"]), {"A": f32(2, 3, 4), "B": f32(3, 4)}, {"C": C3},
        tol=ROUNDING if op == "Mean" else EXACT)
add("Sum-one", node("Sum", ["A"]), {"A": A})
add("Mean-int", node("Mean", ["A", "B"]), {"A": i64(3, 4), "B": i64(3, 4)})
# Sum/Mean of static values stay static: a Reshape target
add("Sum-static-reshape-target",
    [node("Sum", ["a", "b"], ["t"]), node("Reshape", ["X", "t"])], {"X": X},
    {"a": np.asarray([2, 0], np.int64), "b": np.asarray([3, -1], np.int64)})
add("Where", node("Where", ["C", "A", "B"]), {"C": bools(2, 3, 4), "A": A, "B": B})
add("Where-broadcast", node("Where", ["C", "A", "b"]), {"C": bools(3, 1), "A": f32(3, 4)},
    {"b": np.float32(-1.0)})

# --- matmul family -------------------------------------------------------------
add("MatMul", node("MatMul", ["A", "W"]), {"A": f32(5, 8)}, {"W": f32(8, 6)}, tol=SUMS)
add("MatMul-batched", node("MatMul", ["A", "B"]), {"A": f32(2, 3, 5, 8), "B": f32(2, 3, 8, 4)}, tol=SUMS)
add("MatMul-3d-by-2d", node("MatMul", ["A", "W"]), {"A": f32(4, 5, 8)}, {"W": f32(8, 6)}, tol=SUMS)
add("Gemm", node("Gemm", ["A", "W", "c"]), {"A": f32(5, 8)}, {"W": f32(8, 6), "c": f32(6)}, tol=SUMS)
add("Gemm-trans-alpha-beta", node("Gemm", ["A", "W", "c"], transA=1, transB=1, alpha=0.5, beta=2.0),
    {"A": f32(8, 5)}, {"W": f32(6, 8), "c": f32(5, 6)}, tol=SUMS)

# --- shape ops -----------------------------------------------------------------
X4 = f32(2, 3, 4, 5)
add("Reshape-zero-and-minus-one", node("Reshape", ["X", "s"]), {"X": X4},
    {"s": np.asarray([0, 3, -1], np.int64)})
add("Reshape-allowzero", node("Reshape", ["X", "s"], allowzero=1), {"X": X4},
    {"s": np.asarray([6, 20], np.int64)})
add("Reshape-attr-form", node("Reshape", ["X"], shape=[4, 30]), {"X": X4})
# a model exported with batch 1 hard-coded runs a batch of 3: dim 0 freed
add("Reshape-fixed-batch", node("Reshape", ["X", "s"]), {"X": f32(3, 4, 5)},
    {"s": np.asarray([1, 20], np.int64)})
add("Reshape-runtime-target-refused", node("Reshape", ["X", "S"]),
    {"X": X4, "S": np.asarray([6, 20], np.int64)},
    refuse="Reshape 'reshape': shape input must be statically known")
# Shape -> Gather -> Concat: infera_tpu's Gather and Concat give traced
# values, so the target is not static and both packages refuse it
add("Reshape-shape-gather-concat-refused",
    [node("Shape", ["X"], ["sh"]), node("Gather", ["sh", "i0"], ["d0"]),
     node("Concat", ["d0", "m1"], ["t"], axis=0), node("Reshape", ["X", "t"])],
    {"X": X4}, {"i0": np.asarray([0], np.int64), "m1": np.asarray([-1], np.int64)},
    refuse="Reshape 'reshape': shape input must be statically known")
# Shape -> Slice keeps numpy: a static target, answered by both
add("Reshape-shape-slice-target",
    [node("Shape", ["X"], ["sh"]), node("Slice", ["sh", "st", "en"], ["t"]),
     node("Reshape", ["Z", "t"])],
    {"X": X4, "Z": f32(24, 5)}, {"st": np.asarray([0], np.int64), "en": np.asarray([3], np.int64)})
for axis in (0, 1, 2, -1):
    add(f"Flatten-axis{axis}", node("Flatten", ["X"], axis=axis), {"X": X4})
add("Flatten-default", node("Flatten", ["X"]), {"X": X4})
add("Transpose-perm", node("Transpose", ["X"], perm=[0, 2, 3, 1]), {"X": X4})
add("Transpose-default", node("Transpose", ["X"]), {"X": X4})
add("Concat", node("Concat", ["A", "B", "c"], axis=1), {"A": f32(2, 3), "B": f32(2, 1)}, {"c": f32(2, 2)})
add("Concat-negative-axis", node("Concat", ["A", "B"], axis=-1), {"A": f32(2, 3), "B": f32(2, 4)})
add("Split-input-sizes", node("Split", ["X", "s"], ["Y", "Z"], axis=1), {"X": f32(2, 7)},
    {"s": np.asarray([3, 4], np.int64)}, outputs=("Y", "Z"))
add("Split-attr", node("Split", ["X"], ["Y", "Z", "W"], axis=0, split=[1, 2, 1]), {"X": f32(4, 3)},
    outputs=("Y", "Z", "W"))
add("Split-equal", node("Split", ["X"], ["Y", "Z"], axis=-1), {"X": f32(3, 6)}, outputs=("Y", "Z"))
add("Squeeze-attr", node("Squeeze", ["X"], axes=[1, 3]), {"X": f32(2, 1, 3, 1)})
add("Squeeze-input", node("Squeeze", ["X", "a"]), {"X": f32(2, 1, 3, 1)}, {"a": np.asarray([-1], np.int64)})
add("Squeeze-all", node("Squeeze", ["X"]), {"X": f32(1, 3, 1, 2)})
add("Unsqueeze-attr", node("Unsqueeze", ["X"], axes=[0, 3]), {"X": f32(2, 3)})
add("Unsqueeze-input-negative", node("Unsqueeze", ["X", "a"]), {"X": f32(2, 3)},
    {"a": np.asarray([-1, 1], np.int64)})
S = f32(6, 7)


def slice_case(cid, starts, ends, axes=None, steps=None, x=S):
    inits = {"st": np.asarray(starts, np.int64), "en": np.asarray(ends, np.int64)}
    ins = ["X", "st", "en"]
    if axes is not None:
        inits["ax"] = np.asarray(axes, np.int64)
        ins.append("ax")
    if steps is not None:
        if axes is None:
            ins.append("")
        inits["sp"] = np.asarray(steps, np.int64)
        ins.append("sp")
    add(cid, node("Slice", ins), {"X": x}, inits)


slice_case("Slice-basic", [1, 2], [4, 6])
slice_case("Slice-axes-steps", [0], [7], [1], [2])
slice_case("Slice-negative-step", [-1], [-(1 << 62)], [1], [-1])  # reverse the axis
slice_case("Slice-negative-step-stride-two", [5, 6], [0, 1], [0, 1], [-2, -3])
slice_case("Slice-out-of-range-bounds", [-100, 2], [100, 1 << 40], [0, 1])
slice_case("Slice-empty", [4], [2], [0])
slice_case("Slice-negative-step-end-minus-dim-minus-one", [-1], [-8], [1], [-1])
slice_case("Slice-steps-without-axes", [0, 0], [6, 7], None, [3, 2])
add("Slice-attr-form", node("Slice", ["X"], starts=[1, -3], ends=[5, 100], axes=[0, 1]), {"X": S})
I6 = np.asarray([[0, -1, 2], [-6, 5, 1]], np.int64)
add("Gather-negative-static", node("Gather", ["X", "i"], axis=0), {"X": f32(6, 4)}, {"i": I6})
add("Gather-axis1", node("Gather", ["X", "i"], axis=1), {"X": f32(3, 6, 2)}, {"i": I6})
add("Gather-scalar-index", node("Gather", ["X", "i"], axis=1), {"X": f32(3, 6)}, {"i": np.int64(-2)})
add("Gather-runtime-indices", node("Gather", ["X", "I"], axis=0), {"X": f32(6, 4), "I": I6})
OOB = np.asarray([[0, -7, 6], [3, 9, -1]], np.int64)
add("Gather-out-of-range-float", node("Gather", ["X", "I"], axis=0), {"X": f32(6, 4), "I": OOB})
add("Gather-out-of-range-int", node("Gather", ["X", "I"], axis=1), {"X": i64(2, 6), "I": OOB})
add("Gather-out-of-range-static", node("Gather", ["X", "i"], axis=0), {"X": f32(6, 4)}, {"i": OOB})
add("GatherElements", node("GatherElements", ["X", "I"], axis=1),
    {"X": f32(3, 5), "I": RNG.integers(-5, 5, (3, 4)).astype(np.int64)})
add("GatherElements-axis0", node("GatherElements", ["X", "I"], axis=0),
    {"X": f32(4, 3), "I": RNG.integers(-4, 4, (2, 3)).astype(np.int64)})
add("Expand", node("Expand", ["X", "s"]), {"X": f32(3, 1)}, {"s": np.asarray([2, 1, 4], np.int64)})
add("Tile", node("Tile", ["X", "r"]), {"X": f32(2, 3)}, {"r": np.asarray([2, 3], np.int64)})
add("Shape", node("Shape", ["X"]), {"X": X4})
add("Shape-start-end", node("Shape", ["X"], start=1, end=-1), {"X": X4})
add("Size", node("Size", ["X"]), {"X": X4})
add("Constant-tensor", [node("Constant", [], ["c"], value=f32(3, 4)), node("Add", ["X", "c"])], {"X": f32(3, 4)})
add("Constant-value-float", [node("Constant", [], ["c"], value_float=2.5), node("Mul", ["X", "c"])], {"X": X})
add("Constant-value-ints-as-target",
    [node("Constant", [], ["c"], value_ints=[5, 3]), node("Reshape", ["X", "c"])], {"X": X})
add("Constant-value-int", [node("Constant", [], ["c"], value_int=7), node("Add", ["X", "c"])], {"X": i64(2, 2)})
add("Constant-value-floats", [node("Constant", [], ["c"], value_floats=[1.0, 2.0, 3.0, 4.0, 5.0]),
                              node("Add", ["X", "c"])], {"X": X})
add("ConstantOfShape", [node("Shape", ["X"], ["s"]), node("ConstantOfShape", ["s"], value=np.asarray([1.5], np.float32))],
    {"X": X})
add("ConstantOfShape-default", [node("Shape", ["X"], ["s"]), node("ConstantOfShape", ["s"])], {"X": X})
add("ConstantOfShape-int", node("ConstantOfShape", ["s"], value=np.asarray([4], np.int64)), {"X": X},
    {"s": np.asarray([2, 3], np.int64)})
add("Range", [node("Range", ["a", "b", "d"], ["r"]), node("Add", ["X", "r"])], {"X": i64(4)},
    {"a": np.int64(2), "b": np.int64(10), "d": np.int64(2)})
add("Range-negative-delta", node("Range", ["a", "b", "d"]), {"X": X},
    {"a": np.int64(5), "b": np.int64(-4), "d": np.int64(-3)})

# --- reductions ------------------------------------------------------------------
R = f32(3, 4, 5)
for op in ("ReduceSum", "ReduceMean", "ReduceMax", "ReduceMin", "ReduceProd", "ReduceL2",
           "ReduceLogSumExp"):
    x = f32(3, 4, 5, lo=0.5, hi=1.5) if op == "ReduceProd" else R
    add(f"{op}-attr", node(op, ["X"], axes=[1]), {"X": x}, tol=SUMS)
    add(f"{op}-attr-two-axes-no-keepdims", node(op, ["X"], axes=[0, -1], keepdims=0), {"X": x}, tol=SUMS)
    add(f"{op}-input-axes", node(op, ["X", "a"]), {"X": x}, {"a": np.asarray([2], np.int64)}, tol=SUMS)
    add(f"{op}-all", node(op, ["X"], keepdims=0), {"X": x}, tol=SUMS)
add("ReduceSum-int", node("ReduceSum", ["X"], axes=[0]), {"X": i64(4, 3)})
add("ReduceMean-int", node("ReduceMean", ["X"], axes=[1]), {"X": i64(4, 3)}, tol=SUMS)
add("ReduceSum-empty-axes-input", node("ReduceSum", ["X", "a"]), {"X": R}, {"a": np.zeros(0, np.int64)})
add("ReduceSum-runtime-axes-refused", node("ReduceSum", ["X", "A"]), {"X": R, "A": np.asarray([1], np.int64)},
    refuse="ReduceSum 'reducesum': axes must be statically known")
T = np.asarray([[1, 3, 3, 0], [2, 2, 1, 2], [0, 5, 5, 5]], np.float32)  # ties: first index
for op in ("ArgMax", "ArgMin"):
    add(op, node(op, ["X"]), {"X": T})
    add(f"{op}-axis1-no-keepdims", node(op, ["X"], axis=1, keepdims=0), {"X": T})
    add(f"{op}-axis-negative", node(op, ["X"], axis=-1), {"X": f32(2, 3, 4)})

# --- network layers -----------------------------------------------------------------


def conv_case(cid, x, w, b=True, **attrs):
    inits = {"W": w}
    ins = ["X", "W"]
    if b:
        inits["B"] = f32(w.shape[0], lo=-0.1, hi=0.1)
        ins.append("B")
    add(cid, node("Conv", ins, **attrs), {"X": x}, inits, tol=SUMS)


XC = f32(2, 4, 9, 10)
conv_case("Conv-pads", XC, f32(6, 4, 3, 3), pads=[1, 1, 1, 1])
conv_case("Conv-no-bias", XC, f32(6, 4, 3, 3), b=False)
conv_case("Conv-stride2", XC, f32(6, 4, 3, 3), strides=[2, 2], pads=[1, 1, 1, 1])
conv_case("Conv-groups", XC, f32(8, 2, 3, 3), group=2, pads=[1, 1, 1, 1])
conv_case("Conv-depthwise", XC, f32(4, 1, 5, 5), group=4, pads=[2, 2, 2, 2], strides=[2, 2])
conv_case("Conv-dilation", XC, f32(6, 4, 3, 3), dilations=[2, 2], pads=[2, 1, 2, 1])
conv_case("Conv-asymmetric-pads", XC, f32(6, 4, 3, 3), pads=[0, 1, 2, 1])
for mode in ("SAME_UPPER", "SAME_LOWER"):
    conv_case(f"Conv-{mode}-stride2", XC, f32(6, 4, 3, 3), auto_pad=mode, strides=[2, 2])
    conv_case(f"Conv-{mode}-even-kernel", XC, f32(6, 4, 2, 4), auto_pad=mode)
    conv_case(f"Conv-{mode}-dilation", XC, f32(6, 4, 3, 3), auto_pad=mode, dilations=[2, 1])
conv_case("Conv-valid", XC, f32(6, 4, 3, 3), auto_pad="VALID")
conv_case("Conv-1d", f32(2, 3, 11), f32(5, 3, 3), pads=[1, 2], strides=[2])
conv_case("Conv-3d", f32(1, 2, 5, 6, 7), f32(3, 2, 3, 3, 3), pads=[1, 1, 1, 1, 1, 1])
add("BatchNormalization", node("BatchNormalization", ["X", "s", "b", "m", "v"], epsilon=1e-3),
    {"X": XC}, {"s": f32(4), "b": f32(4), "m": f32(4), "v": f32(4, lo=0.5, hi=2.0)}, tol=SUMS)
add("GlobalAveragePool", node("GlobalAveragePool", ["X"]), {"X": XC}, tol=SUMS)
add("GlobalMaxPool", node("GlobalMaxPool", ["X"]), {"X": XC})
for op, tol in (("MaxPool", EXACT), ("AveragePool", SUMS)):
    add(f"{op}-2x2", node(op, ["X"], kernel_shape=[2, 2], strides=[2, 2]), {"X": XC}, tol=tol)
    add(f"{op}-padded", node(op, ["X"], kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1]),
        {"X": XC}, tol=tol)
    add(f"{op}-asymmetric-pads", node(op, ["X"], kernel_shape=[3, 2], pads=[0, 1, 2, 0]), {"X": XC}, tol=tol)
    for mode in ("SAME_UPPER", "SAME_LOWER"):
        add(f"{op}-{mode}", node(op, ["X"], kernel_shape=[3, 3], strides=[2, 2], auto_pad=mode),
            {"X": XC}, tol=tol)
    add(f"{op}-1d", node(op, ["X"], kernel_shape=[3], strides=[2], pads=[1, 1]), {"X": f32(2, 3, 11)}, tol=tol)
    add(f"{op}-3d", node(op, ["X"], kernel_shape=[2, 2, 2], pads=[1, 0, 1, 0, 1, 1]),
        {"X": f32(1, 2, 4, 5, 6)}, tol=tol)
add("MaxPool-negative-input-padded", node("MaxPool", ["X"], kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
    {"X": f32(1, 2, 5, 5, lo=-5.0, hi=-1.0)})  # padding cells never win
add("Dropout", node("Dropout", ["X"]), {"X": X})
add("Dropout-mask", node("Dropout", ["X"], ["Y", "M"]), {"X": X}, outputs=("Y", "M"))
LN = f32(2, 3, 8)
add("LayerNormalization-three-outputs",
    node("LayerNormalization", ["X", "s", "b"], ["Y", "M", "I"], epsilon=1e-5),
    {"X": LN}, {"s": f32(8), "b": f32(8)}, outputs=("Y", "M", "I"), tol=SUMS)
add("LayerNormalization-axis1-no-bias", node("LayerNormalization", ["X", "s"], ["Y", "M", "I"], axis=1),
    {"X": LN}, {"s": f32(3, 8)}, outputs=("Y", "M", "I"), tol=SUMS)
unary("Gelu", X, TRANSCENDENTAL)
unary("Gelu", X, TRANSCENDENTAL, approximate="tanh")
add("LRN", node("LRN", ["X"], size=3, alpha=1e-3, beta=0.75, bias=1.0), {"X": XC}, tol=SUMS)
add("LRN-even-size", node("LRN", ["X"], size=4), {"X": XC}, tol=SUMS)

# --- control flow ---------------------------------------------------------------------


def branch(name, nodes, out, shape=(-1, 4)):
    return Graph(name=name, nodes=nodes, outputs=[vi(out, shape=list(shape))])


THEN = branch("then", [node("Mul", ["X", "two"], ["then_out"])], "then_out")
ELSE = branch("else", [node("Neg", ["X"], ["else_out"])], "else_out")
XI = f32(2, 4)
add("If-static-true", node("If", ["c"], then_branch=THEN, else_branch=ELSE), {"X": XI},
    {"c": np.asarray(True), "two": np.float32(2.0)})
add("If-static-false", node("If", ["c"], then_branch=THEN, else_branch=ELSE), {"X": XI},
    {"c": np.asarray(False), "two": np.float32(2.0)})
for sign in ("pos", "neg"):
    add(f"If-runtime-{sign}", [node("ReduceSum", ["X"], ["m"], keepdims=0),
                               node("Greater", ["m", "zero"], ["c"]),
                               node("If", ["c"], then_branch=THEN, else_branch=ELSE)],
        {"X": np.abs(XI) * (1 if sign == "pos" else -1)}, {"two": np.float32(2.0), "zero": np.float32(0.0)})
WIDE = branch("else", [node("Concat", ["X", "X"], ["else_out"], axis=1)], "else_out", (-1, 8))
add("If-runtime-branches-differ-refused",
    [node("ReduceSum", ["X"], ["m"], keepdims=0), node("Greater", ["m", "zero"], ["c"]),
     node("If", ["c"], then_branch=THEN, else_branch=WIDE)],
    {"X": XI}, {"two": np.float32(2.0), "zero": np.float32(0.0)},
    refuse="If 'if': branches must produce matching shapes/dtypes under a traced condition")
add("If-static-branches-differ-folds", node("If", ["c"], then_branch=THEN, else_branch=WIDE),
    {"X": XI}, {"c": np.asarray(False), "two": np.float32(2.0)})


def loop_body(extra_nodes=(), c_out="c_in", scan=False, v_shape=(-1, 4), body_nodes=None):
    nodes = list(body_nodes if body_nodes is not None else [node("Add", ["v_in", "X"], ["v_out"])])
    nodes += list(extra_nodes)
    outputs = [vi("c_out", shape=[], dt=DataType.BOOL), vi("v_out", shape=list(v_shape))]
    nodes.append(node("Identity", [c_out], ["c_out"]))
    if scan:
        nodes.append(node("ReduceSum", ["v_out"], ["s_out"], keepdims=0))
        outputs.append(vi("s_out", shape=[]))
    return Graph(name="body", nodes=nodes,
                 inputs=[vi("i", shape=[], dt=DataType.INT64), vi("c_in", shape=[], dt=DataType.BOOL),
                         vi("v_in", shape=list(v_shape))],
                 outputs=outputs)


EARLY = [node("Less", ["i", "two"], ["lt"])]
XL = f32(3, 4)
LOOP_INITS = {"M": np.int64(6), "go": np.asarray(True), "two": np.int64(2)}
add("Loop-while", node("Loop", ["M", "go", "X"], body=loop_body()), {"X": XL}, LOOP_INITS)
add("Loop-while-early-exit", node("Loop", ["M", "go", "X"], body=loop_body(EARLY, "lt")),
    {"X": XL}, LOOP_INITS)
add("Loop-no-trip-count", node("Loop", ["", "go", "X"], body=loop_body(EARLY, "lt")),
    {"X": XL}, LOOP_INITS)
add("Loop-no-cond", node("Loop", ["M", "", "X"], body=loop_body()), {"X": XL}, LOOP_INITS)
add("Loop-runtime-trip-count", [node("ReduceSum", ["N"], ["n"], keepdims=0),
                                node("Loop", ["n", "go", "X"], body=loop_body())],
    {"X": XL, "N": np.asarray([1, 2], np.int64)}, LOOP_INITS)
add("Loop-cond-false-at-start", node("Loop", ["M", "stop", "X"], body=loop_body()), {"X": XL},
    {**LOOP_INITS, "stop": np.asarray(False)})
add("Loop-scan-outputs", node("Loop", ["M", "go", "X"], ["Y", "S"], body=loop_body(scan=True)),
    {"X": XL}, LOOP_INITS, outputs=("Y", "S"), tol=SUMS)
# the body exits after i = 2, but all M rows come out: later ones from the
# frozen state with the carried cond false
add("Loop-scan-outputs-early-exit",
    node("Loop", ["M", "go", "X"], ["Y", "S"], body=loop_body(EARLY, "lt", scan=True)),
    {"X": XL}, LOOP_INITS, outputs=("Y", "S"), tol=SUMS)
add("Loop-scan-outputs-runtime-trip-count-refused",
    [node("ReduceSum", ["N"], ["n"], keepdims=0),
     node("Loop", ["n", "go", "X"], ["Y", "S"], body=loop_body(scan=True))],
    {"X": XL, "N": np.asarray([1, 2], np.int64)}, LOOP_INITS, outputs=("Y", "S"),
    refuse="Loop 'loop': scan outputs require a statically known trip count")
GROW = [node("Concat", ["v_in", "X"], ["v_out"], axis=0)]
add("Loop-while-carried-shape-changes-refused",
    node("Loop", ["M", "go", "X"], body=loop_body(body_nodes=GROW)), {"X": XL}, LOOP_INITS,
    refuse="Loop 'loop': body must preserve the shapes/dtypes of loop-carried values")
# a carried [1, 4] that the body broadcasts to [3, 4] (infera_tpu's freeze,
# jnp.where, broadcasts it too, and lax.scan then refuses the carry)
add("Loop-scan-carried-shape-changes-refused",
    node("Loop", ["M", "go", "V"], ["Y", "S"], body=loop_body(scan=True)),
    {"X": XL}, {**LOOP_INITS, "V": f32(1, 4)}, outputs=("Y", "S"),
    refuse="Loop 'loop': body must preserve the shapes/dtypes of loop-carried values")
RETYPE = [node("Add", ["v_in", "X"], ["v_f"]), node("Cast", ["v_f"], ["v_out"], to=DataType.INT32)]
add("Loop-carried-dtype-changes-refused",
    node("Loop", ["M", "go", "X"], body=loop_body(body_nodes=RETYPE)), {"X": XL}, LOOP_INITS,
    refuse="Loop 'loop': body must preserve the shapes/dtypes of loop-carried values")


def scan_body(n_in=1):
    nodes = [node("Add", ["s_in", "x0"], ["s_out"])]
    inputs = [vi("s_in", shape=[4]), vi("x0", shape=[4])]
    if n_in == 2:
        nodes = [node("Add", ["s_in", "x0"], ["t"]), node("Mul", ["t", "x1"], ["s_out"])]
        inputs.append(vi("x1", shape=[4]))
    nodes.append(node("Mul", ["s_out", "W"], ["y_t"]))  # W from the outer scope
    return Graph(name="scan_body", nodes=nodes, inputs=inputs,
                 outputs=[vi("s_out", shape=[4]), vi("y_t", shape=[4])])


SCAN_INITS = {"S0": np.zeros(4, np.float32), "W": f32(4)}
add("Scan", node("Scan", ["S0", "X"], ["SF", "Y"], body=scan_body(), num_scan_inputs=1),
    {"X": f32(6, 4)}, SCAN_INITS, outputs=("SF", "Y"), tol=SUMS)
add("Scan-axes-and-directions",
    node("Scan", ["S0", "X", "Z"], ["SF", "Y"], body=scan_body(2), num_scan_inputs=2,
         scan_input_axes=[1, 0], scan_input_directions=[1, 0],
         scan_output_axes=[1], scan_output_directions=[1]),
    {"X": f32(4, 5), "Z": f32(5, 4, lo=0.5, hi=1.0)}, SCAN_INITS, outputs=("SF", "Y"), tol=SUMS)
add("Scan-unequal-lengths-refused",
    node("Scan", ["S0", "X", "Z"], ["SF", "Y"], body=scan_body(2), num_scan_inputs=2),
    {"X": f32(3, 4), "Z": f32(5, 4)}, SCAN_INITS, outputs=("SF", "Y"),
    refuse="scan got values with different leading axis sizes")


def run_case(compile_fn, errors, data, feeds, **kw):
    """The outputs as numpy, or the error ``errors`` names."""
    try:
        model = compile_fn(data, "t", **kw)
        return [o.cpu().numpy() if hasattr(o, "cpu") else np.asarray(o)
                for o in model.run(*feeds.values())]
    except errors as e:
        return e


def check_case(case, got, want, errors=(OnnxError, OnnxError)):
    """``got`` against ``want``: both refused with the case's prefix, or
    every output within the case's tolerance."""
    if case.refuse is not None:
        prefix = "ONNX error: " + case.refuse
        for out, err in zip((want, got), errors):
            assert isinstance(out, err), out
            assert str(out).startswith(prefix), str(out)
        return
    assert not isinstance(want, Exception), want
    assert not isinstance(got, Exception), got
    assert len(got) == len(want) == len(case.outputs)
    for name, g, w in zip(case.outputs, got, want):
        assert_same(g, w, case.tol, name)
        if case.signed_zeros:
            zero = np.asarray(w) == 0
            np.testing.assert_array_equal(np.signbit(g)[zero], np.signbit(w)[zero], err_msg=name)


def assert_same(got, want, tol, what=""):
    """``got`` (the port) against ``want`` (infera_tpu): shape, kind and the
    values within ``tol`` (0: exact; NaN equals NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    family = {"u": "i", "i": "i"}
    assert family.get(got.dtype.kind, got.dtype.kind) == family.get(want.dtype.kind, want.dtype.kind), \
        (what, got.dtype, want.dtype)
    if want.dtype.kind == "f":
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if tol == EXACT:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        scale = float(np.nanmax(np.abs(want))) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("cid", list(CASES))
def test_op_matches_infera_tpu(cid):
    from infera_tpu.errors import OnnxError as RefOnnxError
    from infera_tpu.onnx.executor import compile_model_bytes as ref_compile

    case = CASES[cid]
    data = case.model().serialize()
    want = run_case(ref_compile, RefOnnxError, data, case.feeds)
    got = run_case(port_compile, OnnxError, data, case.feeds, device="cpu")
    if case.expect is not None:
        # the port keeps int64; infera_tpu agrees wherever its int32 holds the value
        (got,), (want,) = got, want
        np.testing.assert_array_equal(got, case.expect)
        assert got.dtype == np.int64, got.dtype
        keep = np.setdiff1d(np.arange(len(case.expect)), case.x64)
        np.testing.assert_array_equal(want[keep], case.expect[keep])
        assert (want[list(case.x64)] != case.expect[list(case.x64)]).all()
        return
    check_case(case, got, want, (RefOnnxError, OnnxError))


def _registered(package_ops, modules):
    return {op for (domain, op), fn in package_ops.OP_IMPLS.items()
            if domain == "" and fn.__module__ in modules}


def test_every_core_op_is_registered_and_has_a_case():
    import infera_tpu.onnx  # noqa: F401  (registers every module)
    import infera_tpu.onnx.ops as ref_ops
    import infera_tpu_torch.onnx  # noqa: F401
    import infera_tpu_torch.onnx.ops as port_ops

    ref = _registered(ref_ops, {"infera_tpu.onnx.ops", "infera_tpu.onnx.control_flow"})
    assert {"Conv", "Reshape", "If", "Loop", "Scan", "HardSwish"} <= ref
    missing = sorted(op for op in ref if ("", op) not in port_ops.OP_IMPLS)
    assert not missing, missing
    ported = {op for (domain, op) in port_ops.OP_IMPLS if domain == ""}
    assert ported == ref  # no op beyond infera_tpu's core set yet
    covered = {n.op_type for case in CASES.values() for n in case.nodes}
    assert not sorted(ref - covered), sorted(ref - covered)
