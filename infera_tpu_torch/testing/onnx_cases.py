"""One-graph cases of the port's ONNX ops, and the harness that runs them.

A case is a graph of one node (or a few, where a static value has to flow
from one op to the next) with its inputs, made from a numpy seed, and the
tolerance its outputs are held to. The same bytes and inputs run through
two executors: ``infera_tpu``'s against the port on the CPU
(``tests/test_torch_onnx_ops.py`` for the core set, ``CASES`` here for the
rest, ``tests/test_torch_onnx_extra.py``), or the port on the card against
the port on the CPU (``tests/test_torch_cuda_onnx.py`` and
``chip_smoke.py``). Nothing here imports JAX.

``CASES`` covers every registration of ``infera_tpu``'s
``onnx/ops_extra.py`` beyond its unary ops, and all of ``rnn_ops.py``,
``sequence_ops.py`` and ``signal_vision_ops.py``: attribute and input
forms, refusals by message prefix, and edge values (NaN, +-inf, signed
zeros, out-of-range indices and casts, ties, zero divisors). The random ops
(``RANDOM``) are held to properties, not values: ONNX leaves their values
arbitrary, and the port draws from ``torch.Generator``.

Tolerances (relative to each value, and to the output's largest magnitude
for values near zero): shape, index and integer ops exact;
transcendentals 1e-6; MatMul, Conv, DFT, normalisations and reductions
1e-5 (their sums run in another order).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..errors import OnnxError
from ..onnx.proto import (
    _DT_FROM_NP,
    Attribute,
    DataType,
    Graph,
    Model,
    Node,
    Tensor,
    ValueInfo,
)

EXACT, TRANSCENDENTAL, SUMS = 0.0, 1e-6, 1e-5
ROUNDING = TRANSCENDENTAL  # XLA's FMA contraction and reciprocal products


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
    # random ops: a check of the port's outputs (numpy) in place of values
    props: object = None

    def model(self) -> Model:
        return Model(graph=graph(self.nodes, self.feeds.items(), self.inits, self.outputs),
                     opset_imports=[("", 17)])


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
    every output within the case's tolerance. A random case holds each side
    to its properties instead."""
    if case.refuse is not None:
        prefix = "ONNX error: " + case.refuse
        for out, err in zip((want, got), errors):
            assert isinstance(out, err), out
            assert str(out).startswith(prefix), str(out)
        return
    assert not isinstance(want, Exception), want
    assert not isinstance(got, Exception), got
    assert len(got) == len(want) == len(case.outputs)
    if case.props is not None:
        case.props(got)
        case.props(want)
        return
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
        finite = np.isfinite(want) if want.dtype.kind == "f" else np.ones(want.shape, bool)
        scale = float(np.max(np.abs(want[finite]))) if finite.any() else 0.0
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


# ---------------------------------------------------------------------------
# The cases of ops_extra.py, rnn_ops.py, sequence_ops.py, signal_vision_ops.py
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(20261018 + 18)
CASES: dict = {}


def f32(*shape, lo=-3.0, hi=3.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def i64(*shape, lo=-9, hi=10):
    return RNG.integers(lo, hi, shape).astype(np.int64)


def add(cid, nodes, feeds, inits=None, outputs=("Y",), tol=EXACT, refuse=None, **kw):
    assert cid not in CASES, cid
    nodes = nodes if isinstance(nodes, list) else [nodes]
    CASES[cid] = Case(nodes, dict(feeds), dict(inits or {}), tuple(outputs), tol, refuse, **kw)


def unary(op, x, tol=EXACT, cid=None, **attrs):
    add(cid or (op if not attrs else f"{op}-{'-'.join(attrs)}"), node(op, ["X"], **attrs),
        {"X": x}, tol=tol)


NAN, INF = np.float32(np.nan), np.float32(np.inf)
EDGE = np.asarray([NAN, INF, -INF, -0.0, 0.0, -1.5, 2.5, 300.0, -300.0, 3e9, -3e9, 1e-3],
                  np.float32)
X = f32(3, 5)
X4 = f32(2, 4, 5, 6)

# --- activations and normalisations ------------------------------------------
unary("IsInf", EDGE)
unary("IsInf", EDGE, detect_negative=0)
unary("IsInf", EDGE, detect_positive=0)
add("IsInf-int", node("IsInf", ["X"]), {"X": i64(3, 4)})
for op in ("Selu", "Celu"):
    unary(op, X, TRANSCENDENTAL)
    unary(op, EDGE, TRANSCENDENTAL, cid=f"{op}-edges")
unary("Selu", X, TRANSCENDENTAL, alpha=1.5, gamma=0.75)
unary("Celu", X, TRANSCENDENTAL, alpha=1.5)
unary("Celu", X, TRANSCENDENTAL, cid="Celu-alpha-0.3", alpha=0.3)
for op in ("ThresholdedRelu", "Shrink"):
    unary(op, X)
    unary(op, EDGE, cid=f"{op}-edges")
unary("ThresholdedRelu", X, alpha=0.35)
unary("Shrink", X, lambd=1.0, bias=0.25)
TIES = np.asarray([[1, 3, 3, 0], [2, 2, 1, 2], [0, 5, 5, 5]], np.float32)
unary("Hardmax", TIES)
unary("Hardmax", TIES, cid="Hardmax-axis0", axis=0)
unary("Hardmax", np.asarray([[1.0, NAN, 3.0, NAN], [-INF, -INF, -INF, -INF]], np.float32),
      cid="Hardmax-nan-first")
add("Hardmax-int", node("Hardmax", ["X"], axis=1), {"X": i64(3, 4)})
unary("Hardmax", f32(2, 3, 4), cid="Hardmax-3d-axis1", axis=1)
for p in (1, 2):
    unary("LpNormalization", X, SUMS, cid=f"LpNormalization-p{p}", p=p)
    add(f"LpNormalization-p{p}-zero-row", node("LpNormalization", ["X"], p=p, axis=1),
        {"X": np.asarray([[0.0, 0.0, 0.0], [1.0, -2.0, 2.0]], np.float32)}, tol=SUMS)
unary("LpNormalization", f32(3, 4, 5), SUMS, cid="LpNormalization-axis0", axis=0)
add("LpNormalization-int", node("LpNormalization", ["X"]), {"X": i64(3, 4)}, tol=SUMS)
unary("MeanVarianceNormalization", X4, SUMS)
unary("MeanVarianceNormalization", X4, SUMS, axes=[2, 3])
unary("MeanVarianceNormalization", f32(4, 6), SUMS, cid="MeanVarianceNormalization-2d",
      axes=[0, 1])
for op in ("InstanceNormalization", "GroupNormalization"):
    extra = {"num_groups": 2} if op == "GroupNormalization" else {}
    add(op, node(op, ["X", "s", "b"], **extra), {"X": X4}, {"s": f32(4), "b": f32(4)}, tol=SUMS)
    add(f"{op}-epsilon-3d", node(op, ["X", "s", "b"], epsilon=1e-2, **extra),
        {"X": f32(2, 4, 7)}, {"s": f32(4), "b": f32(4)}, tol=SUMS)
    add(f"{op}-constant-input", node(op, ["X", "s", "b"], **extra),
        {"X": np.full((1, 4, 3, 3), 2.5, np.float32)}, {"s": f32(4), "b": f32(4)}, tol=SUMS)
add("GroupNormalization-per-group-affine", node("GroupNormalization", ["X", "s", "b"], num_groups=2),
    {"X": X4}, {"s": f32(2), "b": f32(2)}, tol=SUMS)
add("GroupNormalization-one-group", node("GroupNormalization", ["X", "s", "b"], num_groups=1),
    {"X": X4}, {"s": f32(4), "b": f32(4)}, tol=SUMS)

# --- reductions ----------------------------------------------------------------
R = f32(3, 4, 5)
for op in ("ReduceL1", "ReduceSumSquare", "ReduceLogSum"):
    x = f32(3, 4, 5, lo=0.5, hi=2.0) if op == "ReduceLogSum" else R
    add(f"{op}-attr", node(op, ["X"], axes=[1]), {"X": x}, tol=SUMS)
    add(f"{op}-two-axes-no-keepdims", node(op, ["X"], axes=[0, -1], keepdims=0), {"X": x}, tol=SUMS)
    add(f"{op}-input-axes", node(op, ["X", "a"]), {"X": x}, {"a": np.asarray([2], np.int64)}, tol=SUMS)
    add(f"{op}-all", node(op, ["X"], keepdims=0), {"X": x}, tol=SUMS)
    add(f"{op}-all-keepdims", node(op, ["X"]), {"X": x}, tol=SUMS)
    add(f"{op}-empty-axes-reduce-all", node(op, ["X", "a"]), {"X": x},
        {"a": np.zeros(0, np.int64)}, tol=SUMS)
    add(f"{op}-noop-with-empty-axes", node(op, ["X"], noop_with_empty_axes=1), {"X": x})
    add(f"{op}-runtime-axes-refused", node(op, ["X", "A"]), {"X": x, "A": np.asarray([1], np.int64)},
        refuse=f"{op} '{op.lower()}': axes must be statically known")
add("ReduceL1-int", node("ReduceL1", ["X"], axes=[0]), {"X": i64(4, 3)})
add("ReduceSumSquare-int", node("ReduceSumSquare", ["X"], axes=[1]), {"X": i64(4, 3)})
add("ReduceL1-edges", node("ReduceL1", ["X"], keepdims=0), {"X": EDGE}, tol=SUMS)
add("ReduceLogSum-zero-and-negative", node("ReduceLogSum", ["X"], axes=[1]),
    {"X": np.asarray([[0.0, 0.0], [-1.0, 0.5], [1.0, 2.0]], np.float32)}, tol=SUMS)

# --- Pad -----------------------------------------------------------------------------
P = f32(2, 3, 4)


def pad_case(cid, pads, x=P, mode=None, value=None, axes=None, **kw):
    ins, inits = ["X", "p"], {"p": np.asarray(pads, np.int64)}
    if value is not None or axes is not None:
        ins.append("v" if value is not None else "")
        if value is not None:
            inits["v"] = value
    if axes is not None:
        ins.append("a")
        inits["a"] = np.asarray(axes, np.int64)
    attrs = {"mode": mode} if mode else {}
    add(cid, node("Pad", ins, **attrs), {"X": x}, inits, **kw)


pad_case("Pad-constant", [0, 1, 2, 1, 0, 3])
pad_case("Pad-constant-value", [1, 0, 0, 0, 2, 1], value=np.asarray(7.5, np.float32))
pad_case("Pad-constant-int-value-truncates", [1, 1, 0, 0], x=i64(3, 4), value=np.asarray(7, np.int64))
pad_case("Pad-constant-int-x-float-value", [0, 2, 0, 1], x=i64(3, 4), value=np.asarray(7.5, np.float32))
for mode in ("reflect", "edge", "wrap"):
    pad_case(f"Pad-{mode}-every-axis", [1, 2, 3, 1, 1, 2], mode=mode)
    pad_case(f"Pad-{mode}-leading-axis", [1, 0, 0, 1, 0, 0], mode=mode)
    pad_case(f"Pad-{mode}-wide", [0, 0, 7, 0, 0, 9], mode=mode)  # pads past the axis
    pad_case(f"Pad-{mode}-negative-trims", [0, -1, 2, 0, 1, -2], mode=mode)
    pad_case(f"Pad-{mode}-axes", [2, 3], mode=mode, axes=[-1])
pad_case("Pad-negative-trims", [0, -1, 0, 0, 0, -2])
pad_case("Pad-axes-input", [1, 2, 3, 4], axes=[0, 2])
pad_case("Pad-edges", [2, 2], x=EDGE, mode="reflect")
add("Pad-attr-form", node("Pad", ["X"], pads=[1, 0, 2, 1, 0, 0]), {"X": P})
add("Pad-runtime-value-pads-zero", node("Pad", ["X", "p", "V"]),
    {"X": P, "V": np.asarray(5.0, np.float32)}, {"p": np.asarray([1, 1, 1, 1, 1, 1], np.int64)})
pad_case("Pad-mode-refused", [1, 1, 1, 1, 1, 1], mode="symmetric",
         refuse="Pad mode symmetric not supported")
add("Pad-missing-pads-refused", node("Pad", ["X"]), {"X": P}, refuse="Pad 'pad': missing pads")
add("Pad-runtime-pads-refused", node("Pad", ["X", "Q"]), {"X": P, "Q": np.zeros(6, np.int64)},
    refuse="Pad 'pad': pads must be statically known")

# --- data movement -------------------------------------------------------------------
D = f32(2, 8, 3, 4)
add("DepthToSpace-DCR", node("DepthToSpace", ["X"], blocksize=2), {"X": D})
add("DepthToSpace-CRD", node("DepthToSpace", ["X"], blocksize=2, mode="CRD"), {"X": D})
add("SpaceToDepth", node("SpaceToDepth", ["X"], blocksize=2), {"X": f32(2, 3, 4, 6)})
add("SpaceToDepth-int", node("SpaceToDepth", ["X"], blocksize=3), {"X": i64(1, 2, 6, 3)})
T = f32(3, 5, 4)
for upper in (0, 1):
    add(f"Trilu-upper{upper}", node("Trilu", ["X"], upper=upper), {"X": T})
    for k in (-2, 1, 6):
        add(f"Trilu-upper{upper}-k{k}", node("Trilu", ["X", "k"], upper=upper), {"X": T},
            {"k": np.asarray(k, np.int64)})
add("Trilu-default-upper", node("Trilu", ["X"]), {"X": i64(4, 4)})
add("Trilu-runtime-k-refused", node("Trilu", ["X", "K"]), {"X": T, "K": np.asarray(1, np.int64)},
    refuse="Trilu 'trilu': k must be statically known")
C = f32(3, 4, 5)
for ex in (0, 1):
    for rev in (0, 1):
        for ax in (0, -1):
            add(f"CumSum-exclusive{ex}-reverse{rev}-axis{ax}",
                node("CumSum", ["X", "a"], exclusive=ex, reverse=rev), {"X": C},
                {"a": np.asarray(ax, np.int64)}, tol=SUMS)
add("CumSum-int", node("CumSum", ["X", "a"], exclusive=1), {"X": i64(4, 6)}, {"a": np.asarray([1], np.int64)})
add("CumSum-edges", node("CumSum", ["X", "a"]), {"X": EDGE}, {"a": np.asarray(0, np.int64)}, tol=SUMS)
add("CumSum-runtime-axis-refused", node("CumSum", ["X", "A"]), {"X": C, "A": np.asarray(0, np.int64)},
    refuse="CumSum 'cumsum': axis must be statically known")
IDX = np.asarray([[0, 2, -1], [4, -4, 1]], np.int64)  # 4 and -4 are outside depth 3
for axis in (-1, 0, 1):
    add(f"OneHot-axis{axis}", node("OneHot", ["I", "d", "v"], axis=axis), {"I": IDX},
        {"d": np.asarray(3, np.int64), "v": np.asarray([0.0, 1.0], np.float32)})
add("OneHot-values-and-float-indices", node("OneHot", ["I", "d", "v"]),
    {"I": np.asarray([0.7, 2.2, -1.0, 1.9], np.float32)},
    {"d": np.asarray([4], np.int64), "v": np.asarray([-2.0, 5.0], np.float32)})
add("OneHot-runtime-values-refused", node("OneHot", ["I", "d", "V"]),
    {"I": IDX, "V": np.asarray([0.0, 1.0], np.float32)}, {"d": np.asarray(3, np.int64)},
    refuse="OneHot: values must be static")
add("OneHot-runtime-depth-refused", node("OneHot", ["I", "D", "v"]),
    {"I": IDX, "D": np.asarray(3, np.int64)}, {"v": np.asarray([0.0, 1.0], np.float32)},
    refuse="OneHot 'onehot': depth must be statically known")
for k in (0, 1, -2, 7):
    add(f"EyeLike-k{k}", node("EyeLike", ["X"], k=k), {"X": f32(4, 6)})
add("EyeLike-int-dtype-attr-ignored", node("EyeLike", ["X"], dtype=DataType.FLOAT), {"X": i64(3, 3)})
for dt, like in (("int32", np.zeros(1, np.int32)), ("int8", np.zeros(1, np.int8)),
                 ("uint8", np.zeros(1, np.uint8)), ("bool", np.zeros(1, bool)),
                 ("float", np.zeros(1, np.float32))):
    add(f"CastLike-to-{dt}", node("CastLike", ["X", "L"]), {"X": EDGE}, {"L": like})
add("CastLike-int-to-float", node("CastLike", ["X", "L"]), {"X": i64(3, 4)},
    {"L": np.zeros(1, np.float32)})

# --- TopK --------------------------------------------------------------------------------
TK = f32(3, 7)
for largest in (1, 0):
    for axis in (-1, 0):
        add(f"TopK-largest{largest}-axis{axis}", node("TopK", ["X", "k"], ["V", "I"], largest=largest,
                                                      axis=axis),
            {"X": TK}, {"k": np.asarray([2], np.int64)}, outputs=("V", "I"))
    add(f"TopK-largest{largest}-ties", node("TopK", ["X", "k"], ["V", "I"], largest=largest),
        {"X": TIES}, {"k": np.asarray([3], np.int64)}, outputs=("V", "I"))
    add(f"TopK-largest{largest}-edges", node("TopK", ["X", "k"], ["V", "I"], largest=largest),
        {"X": np.concatenate([EDGE, [NAN, -0.0, 2.5]]).astype(np.float32)},
        {"k": np.asarray(15, np.int64)}, outputs=("V", "I"), signed_zeros=True)
    add(f"TopK-largest{largest}-int", node("TopK", ["X", "k"], ["V", "I"], largest=largest),
        {"X": i64(4, 6, lo=0, hi=4)}, {"k": np.asarray(4, np.int64)}, outputs=("V", "I"))
add("TopK-3d-middle-axis", node("TopK", ["X", "k"], ["V", "I"], axis=1), {"X": f32(2, 5, 3)},
    {"k": np.asarray(5, np.int64)}, outputs=("V", "I"))
add("TopK-runtime-k-refused", node("TopK", ["X", "K"], ["V", "I"]),
    {"X": TK, "K": np.asarray([2], np.int64)}, outputs=("V", "I"),
    refuse="TopK 'topk': k must be statically known")

# --- gathers and scatters ------------------------------------------------------------------
GD = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
add("GatherND-points", node("GatherND", ["X", "I"]), {"X": GD,
                                                      "I": np.asarray([[0, 1, 2], [1, 2, 3]], np.int64)})
add("GatherND-slices", node("GatherND", ["X", "I"]), {"X": GD, "I": np.asarray([[0, 1], [1, 2]], np.int64)})
add("GatherND-rows", node("GatherND", ["X", "I"]), {"X": GD, "I": np.asarray([[[1]], [[0]]], np.int64)})
add("GatherND-negative-and-out-of-range", node("GatherND", ["X", "I"]),
    {"X": GD, "I": np.asarray([[-1, -1], [5, 0], [-4, 1], [0, 9]], np.int64)})
add("GatherND-int-data", node("GatherND", ["X", "I"]), {"X": i64(3, 4), "I": np.asarray([[2, 3], [0, -1]],
                                                                                      np.int64)})
add("GatherND-batch-dims-refused", node("GatherND", ["X", "I"], batch_dims=1),
    {"X": GD, "I": np.asarray([[0], [1]], np.int64)}, refuse="GatherND batch_dims != 0 not supported")
SD = f32(3, 5)
SI = np.asarray([[1, 3, 0], [4, -2, 2]], np.int64)  # distinct in each row once -2 wraps
SU = f32(2, 3)
for red in ("none", "add", "mul"):
    add(f"ScatterElements-axis1-{red}", node("ScatterElements", ["X", "I", "U"], axis=1, reduction=red),
        {"X": SD, "I": SI, "U": SU})
    add(f"ScatterElements-axis0-{red}", node("ScatterElements", ["X", "I", "U"], axis=0, reduction=red),
        {"X": SD, "I": np.asarray([[2, 0, 1], [0, -2, 2]], np.int64), "U": SU})
    add(f"ScatterND-{red}", node("ScatterND", ["X", "I", "U"], reduction=red),
        {"X": GD, "I": np.asarray([[0, 1], [1, 2], [-1, 0]], np.int64), "U": f32(3, 4)})
for red in ("add", "mul"):
    add(f"ScatterElements-duplicates-{red}", node("ScatterElements", ["X", "I", "U"], axis=1, reduction=red),
        {"X": SD, "I": np.asarray([[1, 1, 1], [0, 4, 0]], np.int64), "U": SU}, tol=SUMS)
    add(f"ScatterND-duplicates-{red}", node("ScatterND", ["X", "I", "U"], reduction=red),
        {"X": GD, "I": np.asarray([[0, 1], [0, 1], [1, 0]], np.int64), "U": f32(3, 4)}, tol=SUMS)
add("ScatterElements-out-of-range-dropped", node("ScatterElements", ["X", "I", "U"], axis=1),
    {"X": SD, "I": np.asarray([[7, -6, -11], [5, 1, -5]], np.int64), "U": SU})
add("ScatterND-points-out-of-range-dropped", node("ScatterND", ["X", "I", "U"]),
    {"X": GD, "I": np.asarray([[0, 0, 9], [1, -1, -1], [-3, 0, 0], [0, 2, -5]], np.int64), "U": f32(4)})
add("ScatterElements-int", node("ScatterElements", ["X", "I", "U"], axis=1, reduction="add"),
    {"X": i64(3, 5), "I": SI, "U": i64(2, 3)})
add("ScatterElements-reduction-refused", node("ScatterElements", ["X", "I", "U"], reduction="max"),
    {"X": SD, "I": np.asarray([[0, 1, 2]], np.int64), "U": f32(1, 3)},
    refuse="ScatterElements reduction max not supported")
add("ScatterND-reduction-refused", node("ScatterND", ["X", "I", "U"], reduction="min"),
    {"X": GD, "I": np.asarray([[0, 1]], np.int64), "U": f32(1, 4)},
    refuse="ScatterND reduction min not supported")
CX = f32(4, 3)
for axis in (0, 1, -1):
    add(f"Compress-axis{axis}", node("Compress", ["X", "c"], axis=axis), {"X": CX},
        {"c": np.asarray([True, False, True], bool)})
add("Compress-flat", node("Compress", ["X", "c"]), {"X": CX},
    {"c": np.asarray([0, 1, 1, 0, 0, 1, 1], bool)})
add("Compress-condition-past-the-axis", node("Compress", ["X", "c"], axis=1), {"X": CX},
    {"c": np.asarray([0, 1, 0, 1, 1], bool)})
add("Compress-flat-condition-past-the-end", node("Compress", ["X", "c"]), {"X": f32(2, 2)},
    {"c": np.asarray([0, 1, 0, 0, 1, 1], bool)})
add("Compress-none-kept", node("Compress", ["X", "c"], axis=0), {"X": CX}, {"c": np.zeros(4, bool)})
add("Compress-runtime-condition-refused", node("Compress", ["X", "C"], axis=0),
    {"X": CX, "C": np.asarray([True, False, True, True])},
    refuse="Compress: condition must be static (dynamic output shape)")
RS = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
add("ReverseSequence-time-major", node("ReverseSequence", ["X", "L"]),
    {"X": RS, "L": np.asarray([4, 2, 1], np.int64)})
add("ReverseSequence-batch-major", node("ReverseSequence", ["X", "L"], batch_axis=0, time_axis=1),
    {"X": RS, "L": np.asarray([3, 0, 2, 1], np.int64)})
add("ReverseSequence-length-past-the-end", node("ReverseSequence", ["X", "L"]),
    {"X": RS, "L": np.asarray([6, 4, 5], np.int64)})
add("ReverseSequence-int", node("ReverseSequence", ["X", "L"]),
    {"X": i64(4, 3), "L": np.asarray([2, 5, 3], np.int64)})
for eq, shapes in (("ij,jk->ik", [(3, 4), (4, 5)]), ("bij,bjk->bik", [(2, 3, 4), (2, 4, 5)]),
                   ("ij->ji", [(3, 4)]), ("ii->", [(4, 4)]), ("ii->i", [(4, 4)]),
                   ("i,j->ij", [(3,), (4,)]), ("...ij,...jk->...ik", [(2, 2, 3, 4), (4, 2)]),
                   ("bhqd,bhkd->bhqk", [(2, 3, 5, 4), (2, 3, 6, 4)]), ("ij,ij->", [(3, 4), (3, 4)])):
    add(f"Einsum-{eq}", node("Einsum", [f"A{i}" for i in range(len(shapes))], equation=eq),
        {f"A{i}": f32(*s) for i, s in enumerate(shapes)}, tol=SUMS)
add("Einsum-int", node("Einsum", ["A", "B"], equation="ij,jk->ik"), {"A": i64(3, 4), "B": i64(4, 2)})

# --- Resize ---------------------------------------------------------------------------------
RZ = f32(1, 2, 5, 6)


def resize_case(cid, sizes=None, scales=None, x=RZ, refuse=None, **attrs):
    ins, inits = ["X", "", ""], {}
    if scales is not None:
        ins[2] = "s"
        inits["s"] = np.asarray(scales, np.float32)
    if sizes is not None:
        ins.append("z")
        inits["z"] = np.asarray(sizes, np.int64)
    add(cid, node("Resize", ins, **attrs), {"X": x}, inits, tol=SUMS, refuse=refuse)


for mode in ("nearest", "linear", "cubic"):
    resize_case(f"Resize-{mode}-up", [1, 2, 10, 12], mode=mode)
    resize_case(f"Resize-{mode}-down-antialias", [1, 2, 2, 3], mode=mode)
    resize_case(f"Resize-{mode}-uneven", [1, 2, 7, 4], mode=mode)
    resize_case(f"Resize-{mode}-scales", scales=[1.0, 1.0, 1.5, 0.5], mode=mode)
    resize_case(f"Resize-{mode}-every-axis", [2, 3, 3, 8], mode=mode)
resize_case("Resize-default-nearest", [1, 2, 9, 3])
resize_case("Resize-attrs-ignored", [1, 2, 10, 3], mode="linear",
            coordinate_transformation_mode="align_corners", cubic_coeff_a=-0.75, antialias=0)
resize_case("Resize-x-squared", [1, 1, 1, 4], x=(np.arange(8, dtype=np.float32) ** 2).reshape(1, 1, 1, 8),
            mode="linear")
resize_case("Resize-cubic-impulse", [1, 1, 1, 8], x=np.asarray([0, 0, 1, 0], np.float32).reshape(1, 1, 1, 4),
            mode="cubic")
resize_case("Resize-nearest-int", [1, 2, 8, 3], x=i64(1, 2, 4, 6))
resize_case("Resize-linear-int", [1, 2, 8, 3], x=i64(1, 2, 4, 6), mode="linear")
resize_case("Resize-mode-refused", [1, 2, 8, 3], mode="area", refuse="Resize mode area not supported")
resize_case("Resize-rank-refused", [2, 8, 3], mode="linear",
            refuse="shape must have length equal to the number of dimensions of x")
add("Resize-no-sizes-refused", node("Resize", ["X"]), {"X": RZ}, refuse="Resize: needs static sizes or scales")
resize_case("Resize-empty-scales-refused", scales=np.zeros(0, np.float32),
            refuse="Resize: needs static sizes or scales")
add("Resize-runtime-scales-refused", node("Resize", ["X", "", "S"]),
    {"X": RZ, "S": np.asarray([1, 1, 2, 2], np.float32)}, refuse="Resize: scales must be static")
add("Resize-runtime-sizes-refused", node("Resize", ["X", "", "", "Z"]),
    {"X": RZ, "Z": np.asarray([1, 2, 4, 4], np.int64)}, refuse="Resize 'resize': sizes must be statically known")

# --- the quantized family ------------------------------------------------------------------
# x / 0.25 lands on .5 at odd multiples of 0.125: half to even
QX = np.concatenate([np.arange(-9, 10, dtype=np.float32) * 0.125, EDGE,
                     np.asarray([100.0, -40.0], np.float32)]).reshape(1, -1)
for zp_name, zp in (("uint8", np.asarray(10, np.uint8)), ("int8", np.asarray(-3, np.int8))):
    add(f"QuantizeLinear-{zp_name}", node("QuantizeLinear", ["X", "s", "z"]), {"X": QX},
        {"s": np.asarray(0.25, np.float32), "z": zp})
    add(f"QuantizeLinear-{zp_name}-scale-not-a-power-of-two", node("QuantizeLinear", ["X", "s", "z"]),
        {"X": f32(4, 64, lo=-40, hi=40)}, {"s": np.asarray(0.3, np.float32), "z": zp})
    add(f"DequantizeLinear-{zp_name}", node("DequantizeLinear", ["X", "s", "z"]),
        {"X": RNG.integers(-128 if zp_name == "int8" else 0, 128 if zp_name == "int8" else 256,
                           (3, 5)).astype(zp.dtype)},
        {"s": np.asarray(0.3, np.float32), "z": zp})
add("QuantizeLinear-no-zero-point", node("QuantizeLinear", ["X", "s"]), {"X": QX},
    {"s": np.asarray(0.5, np.float32)})
add("QuantizeLinear-runtime-scale", node("QuantizeLinear", ["X", "S", "z"]),
    {"X": f32(4, 64, lo=-40, hi=40), "S": np.asarray(0.3, np.float32)}, {"z": np.asarray(128, np.uint8)})
add("QuantizeLinear-runtime-int8-zero-point-is-unsigned", node("QuantizeLinear", ["X", "s", "Z"]),
    {"X": f32(2, 8), "Z": np.asarray(-5, np.int8)}, {"s": np.asarray(0.05, np.float32)})
for axis in (1, 0):
    add(f"QuantizeLinear-per-axis{axis}", node("QuantizeLinear", ["X", "s", "z"], axis=axis),
        {"X": f32(3, 3, 4, lo=-20, hi=20)}, {"s": np.asarray([0.1, 0.25, 0.7], np.float32),
                                             "z": np.asarray([0, -4, 9], np.int8)})
    add(f"DequantizeLinear-per-axis{axis}", node("DequantizeLinear", ["X", "s", "z"], axis=axis),
        {"X": RNG.integers(0, 256, (3, 3, 4)).astype(np.uint8)},
        {"s": np.asarray([0.1, 0.25, 0.7], np.float32), "z": np.asarray([0, 128, 9], np.uint8)})
add("DequantizeLinear-no-zero-point", node("DequantizeLinear", ["X", "s"]),
    {"X": RNG.integers(-128, 128, (4, 4)).astype(np.int8)}, {"s": np.asarray(0.02, np.float32)})
add("DequantizeLinear-int32", node("DequantizeLinear", ["X", "s"]),
    {"X": RNG.integers(-100000, 100000, (6,)).astype(np.int32)}, {"s": np.asarray(0.001, np.float32)})
DQL = ("Q", "S", "Z")
for cid, x in (("random", f32(6, 32)), ("positive", f32(4, 8, lo=0.5, hi=9.0)),
               ("negative", f32(4, 8, lo=-9.0, hi=-0.5)), ("zeros", np.zeros((3, 4), np.float32)),
               ("wide", f32(16, 16, lo=-3000, hi=200)),
               ("halves", np.asarray([[-1.0, 0.0, 0.5, 1.0, 2.0, 254.0]], np.float32))):
    add(f"DynamicQuantizeLinear-{cid}", node("DynamicQuantizeLinear", ["X"], DQL), {"X": x}, outputs=DQL)
A8 = RNG.integers(0, 256, (5, 32)).astype(np.uint8)
W8 = RNG.integers(-128, 128, (32, 6)).astype(np.int8)
add("MatMulInteger-uint8-int8-zero-points", node("MatMulInteger", ["A", "w", "az", "wz"]), {"A": A8},
    {"w": W8, "az": np.asarray(128, np.uint8), "wz": np.asarray(-3, np.int8)})
add("MatMulInteger-no-zero-points", node("MatMulInteger", ["A", "w"]), {"A": A8}, {"w": W8})
add("MatMulInteger-extremes", node("MatMulInteger", ["A", "w", "az", "wz"]),
    {"A": np.full((2, 258), 255, np.uint8)},
    {"w": np.full((258, 3), -128, np.int8), "az": np.asarray(0, np.uint8), "wz": np.asarray(127, np.int8)})
add("MatMulInteger-k-past-258-runs-in-f64", node("MatMulInteger", ["A", "w", "az"]),
    {"A": RNG.integers(0, 256, (3, 1000)).astype(np.uint8)},
    {"w": RNG.integers(-128, 128, (1000, 4)).astype(np.int8), "az": np.asarray(255, np.uint8)})
add("MatMulInteger-int8-int8-3d", node("MatMulInteger", ["A", "w"]),
    {"A": RNG.integers(-128, 128, (2, 4, 16)).astype(np.int8)}, {"w": RNG.integers(-128, 128, (16, 3)).astype(np.int8)})
add("MatMulInteger-per-row-zero-point", node("MatMulInteger", ["A", "w", "az"]), {"A": A8[:, :5]},
    {"w": W8[:5], "az": RNG.integers(0, 256, (5,)).astype(np.uint8)})
for kind, dt, lo, hi in (("uint8", np.uint8, 0, 256), ("int8", np.int8, -128, 128)):
    zp = np.asarray(3 if kind == "uint8" else -2, dt)
    for ys, tag in ((0.5, ""), (0.37, "-y-scale-not-a-power-of-two")):
        add(f"QLinearMatMul-{kind}{tag}", node("QLinearMatMul", ["A", "as", "az", "w", "ws", "wz", "ys", "yz"]),
            {"A": RNG.integers(lo, hi, (4, 16)).astype(dt)},
            {"as": np.asarray(0.05, np.float32), "az": zp, "w": RNG.integers(lo, hi, (16, 5)).astype(dt),
             "ws": np.asarray(0.02, np.float32), "wz": zp, "ys": np.asarray(ys, np.float32), "yz": zp})
add("QLinearMatMul-runtime-scales", node("QLinearMatMul", ["A", "AS", "az", "w", "ws", "wz", "YS", "yz"]),
    {"A": RNG.integers(0, 256, (4, 16)).astype(np.uint8), "AS": np.asarray(0.05, np.float32),
     "YS": np.asarray(0.37, np.float32)},
    {"az": np.asarray(7, np.uint8), "w": RNG.integers(0, 256, (16, 5)).astype(np.uint8),
     "ws": np.asarray(0.02, np.float32), "wz": np.asarray(1, np.uint8), "yz": np.asarray(0, np.uint8)})
for tag, a in (("signed-negative", np.asarray([[-5, -3]], np.int8)),
               ("signed-saturates", np.asarray([[-100, -100]], np.int8))):
    add(f"QLinearMatMul-{tag}", node("QLinearMatMul", ["A", "s", "z", "w", "s", "z", "s", "z"]), {"A": a},
        {"s": np.asarray(1.0, np.float32), "z": np.asarray(0, np.int8), "w": np.ones((2, 1), np.int8)})
add("QLinearMatMul-unsigned-clamps-at-zero", node("QLinearMatMul", ["A", "s", "z", "w", "s", "z", "s", "z"]),
    {"A": np.asarray([[-5, -3]], np.int8)},
    {"s": np.asarray(1.0, np.float32), "z": np.asarray(0, np.uint8), "w": np.ones((2, 1), np.int8)})

# --- ConvTranspose ------------------------------------------------------------------------------
CT = f32(2, 4, 5, 6)


def ct_case(cid, x=CT, w_shape=(4, 3, 3, 3), bias=True, **attrs):
    inits = {"W": f32(*w_shape)}
    ins = ["X", "W"]
    if bias:
        inits["B"] = f32(w_shape[1] * attrs.get("group", 1))
        ins.append("B")
    add(cid, node("ConvTranspose", ins, **attrs), {"X": x}, inits, tol=SUMS)


ct_case("ConvTranspose-basic")
ct_case("ConvTranspose-no-bias", bias=False)
ct_case("ConvTranspose-stride2-pads-output-padding", strides=[2, 2], pads=[1, 1, 1, 1], output_padding=[1, 1])
ct_case("ConvTranspose-groups", w_shape=(4, 2, 3, 3), group=2, strides=[2, 1])
ct_case("ConvTranspose-dilation", dilations=[2, 1], pads=[1, 0, 2, 1])
ct_case("ConvTranspose-asymmetric-kernel-stride3", w_shape=(4, 2, 2, 4), strides=[3, 2])
ct_case("ConvTranspose-output-shape", strides=[2, 2], output_shape=[10, 12])
ct_case("ConvTranspose-output-shape-same-upper", strides=[2, 2], output_shape=[10, 11], auto_pad="SAME_UPPER")
for mode in ("SAME_UPPER", "SAME_LOWER", "VALID"):
    ct_case(f"ConvTranspose-{mode}", strides=[2, 2], auto_pad=mode, w_shape=(4, 3, 4, 4))
ct_case("ConvTranspose-output-padding-at-stride", strides=[2, 2], output_padding=[2, 3])
ct_case("ConvTranspose-pads-past-the-kernel-crop", pads=[3, 1, 1, 0])
ct_case("ConvTranspose-pads-leave-no-output", pads=[3, 1, 4, 2])
ct_case("ConvTranspose-1d", x=f32(2, 3, 9), w_shape=(3, 2, 3), strides=[2], pads=[1, 0])
ct_case("ConvTranspose-3d", x=f32(1, 2, 3, 4, 5), w_shape=(2, 3, 2, 3, 2), strides=[2, 1, 2],
        pads=[0, 1, 0, 1, 0, 1])

# --- NonMaxSuppression, Unique, TfIdfVectorizer --------------------------------------------------
BOXES = np.asarray([[[0.0, 0.0, 1.0, 1.0], [0.0, 0.1, 1.0, 1.1], [0.0, 10.0, 1.0, 11.0],
                     [0.0, 10.1, 1.0, 11.1], [1.0, 1.0, 0.0, 0.0], [5.0, 5.0, 6.0, 7.0]],
                    [[0.0, 0.0, 2.0, 2.0], [0.5, 0.5, 2.5, 2.5], [3.0, 3.0, 4.0, 4.0],
                     [0.0, 0.0, 2.0, 2.0], [9.0, 9.0, 9.5, 9.5], [0.1, 0.1, 1.9, 1.9]]], np.float32)
SCORES = RNG.uniform(0, 1, (2, 3, 6)).astype(np.float32)
SCORES[0, 0, :4] = [0.9, 0.75, 0.6, 0.95]
SCORES[1, 1, [0, 3]] = 0.5  # a tie: the lower index first
NMS_IN = ["b", "s", "m", "iou", "sc"]
NMS_INITS = {"b": BOXES, "s": SCORES, "m": np.asarray([3], np.int64), "iou": np.asarray([0.5], np.float32),
             "sc": np.asarray([0.3], np.float32)}
add("NonMaxSuppression", [node("NonMaxSuppression", NMS_IN, ["y"]), node("Identity", ["y"])],
    {"X": X}, NMS_INITS)
add("NonMaxSuppression-defaults", node("NonMaxSuppression", ["b", "s"]), {"X": X},
    {"b": BOXES, "s": SCORES})
add("NonMaxSuppression-center-point-box", node("NonMaxSuppression", NMS_IN, center_point_box=1),
    {"X": X}, {**NMS_INITS, "b": np.abs(BOXES) + 0.5})
add("NonMaxSuppression-max-zero-means-all", node("NonMaxSuppression", NMS_IN),
    {"X": X}, {**NMS_INITS, "m": np.asarray(0, np.int64), "iou": np.asarray(0.0, np.float32)})
add("NonMaxSuppression-feeds-a-device-op", [node("NonMaxSuppression", NMS_IN, ["y"]),
                                            node("Cast", ["y"], ["c"], to=DataType.FLOAT),
                                            node("ReduceSum", ["c"], keepdims=0)],
    {"X": X}, NMS_INITS)
add("NonMaxSuppression-runtime-boxes-refused", node("NonMaxSuppression", ["B", "s"]),
    {"B": BOXES}, {"s": SCORES},
    refuse="NonMaxSuppression 'nonmaxsuppression': boxes must be statically known")
UQ = np.asarray([2, 1, 1, 3, 4, 3, -7, 2], np.int64)
U_OUT = ("Y", "I", "V", "C")
add("Unique-sorted", node("Unique", ["u"], U_OUT), {"X": X}, {"u": UQ}, outputs=U_OUT)
add("Unique-unsorted", node("Unique", ["u"], U_OUT, sorted=0), {"X": X}, {"u": UQ}, outputs=U_OUT)
add("Unique-float-2d-flattened", node("Unique", ["u"], U_OUT), {"X": X},
    {"u": np.asarray([[1.5, -0.0], [0.0, 1.5]], np.float32)}, outputs=U_OUT)
for s in (0, 1):
    add(f"Unique-axis0-sorted{s}", node("Unique", ["u"], U_OUT, axis=0, sorted=s), {"X": X},
        {"u": np.asarray([[2, 3], [1, 0], [1, 0], [2, 3], [0, 9]], np.int64)}, outputs=U_OUT)
add("Unique-runtime-input-refused", node("Unique", ["U"], U_OUT), {"U": UQ}, outputs=U_OUT,
    refuse="Unique 'unique': input must be statically known")
TF_TOKENS = np.asarray([[2, 5, 6, 3, 5, 6], [7, 8, 2, 2, 8, 7]], np.int64)
TF_POOL = dict(ngram_counts=[0, 2], ngram_indexes=[0, 1, 2, 3], pool_int64s=[2, 3, 5, 6, 7, 8])
for mode in ("TF", "IDF", "TFIDF"):
    add(f"TfIdfVectorizer-{mode}", node("TfIdfVectorizer", ["X"], mode=mode, min_gram_length=1,
                                        max_gram_length=2, weights=[0.5, 2.0, 1.5, 3.0], **TF_POOL),
        {"X": TF_TOKENS})
add("TfIdfVectorizer-skip-grams", node("TfIdfVectorizer", ["X"], mode="TF", min_gram_length=2,
                                       max_gram_length=2, max_skip_count=2, **TF_POOL),
    {"X": RNG.integers(2, 9, (3, 12)).astype(np.int64)})
add("TfIdfVectorizer-1d-int32", node("TfIdfVectorizer", ["X"], mode="TF", min_gram_length=1,
                                     max_gram_length=1, ngram_counts=[0], ngram_indexes=[1, 0],
                                     pool_int64s=[2, 3]),
    {"X": np.asarray([2, 2, 3, 9], np.int32)})
add("TfIdfVectorizer-empty-indexes", node("TfIdfVectorizer", ["X"], mode="TF"), {"X": TF_TOKENS})
add("TfIdfVectorizer-float-refused", node("TfIdfVectorizer", ["X"], mode="TF", **TF_POOL),
    {"X": TF_TOKENS.astype(np.float32)}, refuse="TfIdfVectorizer: only integer token input is supported")
add("TfIdfVectorizer-mode-refused", node("TfIdfVectorizer", ["X"], mode="BM25", **TF_POOL),
    {"X": TF_TOKENS}, refuse="TfIdfVectorizer: unknown mode 'BM25'")
add("TfIdfVectorizer-3d-refused", node("TfIdfVectorizer", ["X"], mode="TF", **TF_POOL),
    {"X": TF_TOKENS[None]}, refuse="TfIdfVectorizer: input must be 1-D or 2-D")

# --- RNN, GRU, LSTM --------------------------------------------------------------------------------
SEQ, BATCH, IN, HID = 5, 3, 4, 6


def rnn_case(op, direction="forward", bias=True, h0=True, c0=True, extra_ins=(), **attrs):
    gates = {"RNN": 1, "GRU": 3, "LSTM": 4}[op]
    dirs = 2 if direction == "bidirectional" else 1
    inits = {"W": f32(dirs, gates * HID, IN, lo=-0.6, hi=0.6),
             "R": f32(dirs, gates * HID, HID, lo=-0.6, hi=0.6)}
    ins = ["X", "W", "R"]
    ins.append("B" if bias else "")
    if bias:
        inits["B"] = f32(dirs, 2 * gates * HID, lo=-0.5, hi=0.5)
    ins.append("")  # sequence_lens
    ins.append("H0" if h0 else "")
    if h0:
        inits["H0"] = f32(dirs, BATCH, HID, lo=-1, hi=1)
    if op == "LSTM":
        ins.append("C0" if c0 else "")
        if c0:
            inits["C0"] = f32(dirs, BATCH, HID, lo=-1, hi=1)
    outs = ("Y", "Yh", "Yc") if op == "LSTM" else ("Y", "Yh")
    for pos, name, value in extra_ins:
        while len(ins) <= pos:
            ins.append("")
        ins[pos] = name
        inits[name] = value
    return (node(op, ins, outs, hidden_size=HID, direction=direction, **attrs),
            {"X": f32(SEQ, BATCH, IN)}, inits, outs)


for op in ("RNN", "GRU", "LSTM"):
    for direction in ("forward", "reverse", "bidirectional"):
        n, feeds, inits, outs = rnn_case(op, direction)
        add(f"{op}-{direction}", n, feeds, inits, outputs=outs, tol=SUMS)
    n, feeds, inits, outs = rnn_case(op, bias=False, h0=False, c0=False)
    add(f"{op}-no-bias-no-initial-state", n, feeds, inits, outputs=outs, tol=SUMS)
    if op == "RNN":
        n, feeds, inits, outs = rnn_case(op, activations=["Sigmoid"])
        add("RNN-activation-refused", n, feeds, inits, outputs=outs,
            refuse="RNN: activation Sigmoid not supported")
    else:  # the defaults in another order pass infera_tpu's check and run as the defaults
        acts = {"GRU": ["Tanh", "Sigmoid"], "LSTM": ["Tanh", "Tanh", "Sigmoid"]}[op]
        n, feeds, inits, outs = rnn_case(op, activations=acts)
        add(f"{op}-activations-reordered", n, feeds, inits, outputs=outs, tol=SUMS)
    n, feeds, inits, outs = rnn_case(op, activations=["Relu"] * {"RNN": 1, "GRU": 2, "LSTM": 3}[op])
    add(f"{op}-relu-refused", n, feeds, inits, outputs=outs, refuse=f"{op}: activation Relu not supported")
    n, feeds, inits, outs = rnn_case(op, extra_ins=[(4, "L", np.full(BATCH, SEQ, np.int32))])
    add(f"{op}-sequence-lens-refused", n, feeds, inits, outputs=outs,
        refuse=f"{op}: sequence_lens not supported")
    n, feeds, inits, outs = rnn_case(op)
    n.attributes["direction"] = Attribute.make("direction", "sideways")
    add(f"{op}-direction-refused", n, feeds, inits, outputs=outs, refuse=f"{op}: unknown direction sideways")
for direction in ("forward", "bidirectional"):
    n, feeds, inits, outs = rnn_case("GRU", direction, linear_before_reset=1)
    add(f"GRU-{direction}-linear-before-reset", n, feeds, inits, outputs=outs, tol=SUMS)
n, feeds, inits, outs = rnn_case("LSTM", extra_ins=[(7, "P", f32(1, 3 * HID))])
add("LSTM-peepholes-refused", n, feeds, inits, outputs=outs, refuse="LSTM: peepholes (P) not supported")
n, feeds, inits, outs = rnn_case("LSTM")
feeds["X"] = np.concatenate([f32(SEQ - 1, BATCH, IN), np.asarray([[[NAN, INF, -INF, 0.0]] * BATCH],
                                                                   np.float32)])
add("LSTM-edges-in-the-last-step", n, feeds, inits, outputs=outs, tol=SUMS)
add("LSTM-hidden-size-from-R", node("LSTM", ["X", "W", "R"], ["Y", "Yh", "Yc"]), {"X": f32(SEQ, BATCH, IN)},
    {"W": f32(1, 4 * HID, IN, lo=-0.6, hi=0.6), "R": f32(1, 4 * HID, HID, lo=-0.6, hi=0.6)},
    outputs=("Y", "Yh", "Yc"), tol=SUMS)

# --- Sequence and Optional ---------------------------------------------------------------------------
SX = f32(4, 6)
SEQ_INITS = {"two": np.asarray(2, np.int64), "one": np.asarray(1, np.int64), "neg1": np.asarray(-1, np.int64)}
add("SplitToSequence-ConcatFromSequence", [node("SplitToSequence", ["X"], ["s"], axis=1),
                                           node("ConcatFromSequence", ["s"], axis=1)], {"X": SX})
add("SplitToSequence-keepdims0-stack", [node("SplitToSequence", ["X"], ["s"], axis=0, keepdims=0),
                                        node("ConcatFromSequence", ["s"], axis=1, new_axis=1)], {"X": SX})
add("SplitToSequence-sizes-SequenceAt", [node("SplitToSequence", ["X", "sp"], ["s"], axis=1),
                                         node("SequenceAt", ["s", "one"])], {"X": SX},
    {**SEQ_INITS, "sp": np.asarray([2, 4], np.int64)})
add("SplitToSequence-scalar-size-ragged", [node("SplitToSequence", ["X", "four"], ["s"], axis=1),
                                           node("SequenceAt", ["s", "neg1"], ["Y"]),
                                           node("SequenceLength", ["s"], ["L"])],
    {"X": SX}, {**SEQ_INITS, "four": np.asarray(4, np.int64)}, outputs=("Y", "L"))
add("SplitToSequence-sizes-past-the-end", [node("SplitToSequence", ["X", "sp"], ["s"], axis=0),
                                           node("SequenceAt", ["s", "one"])], {"X": SX},
    {**SEQ_INITS, "sp": np.asarray([1, 5], np.int64)})
add("SequenceConstruct-Insert-Erase-Length",
    [node("SequenceConstruct", ["A", "B"], ["s0"]), node("SequenceInsert", ["s0", "A", "one"], ["s1"]),
     node("SequenceErase", ["s1", "neg1"], ["s2"]),
     node("ConcatFromSequence", ["s2"], ["Y"], axis=0, new_axis=1), node("SequenceLength", ["s2"], ["L"])],
    {"A": f32(3), "B": f32(3)}, SEQ_INITS, outputs=("Y", "L"))
add("SequenceEmpty-Insert-at-end-Concat",
    [node("SequenceEmpty", [], ["e"]), node("SequenceInsert", ["e", "A"], ["s1"]),
     node("SequenceInsert", ["s1", "B"], ["s2"]), node("SequenceInsert", ["s2", "A", "neg1"], ["s3"]),
     node("ConcatFromSequence", ["s3"], axis=-1)], {"A": f32(2, 3), "B": f32(2, 1)}, SEQ_INITS)
add("SequenceErase-default-last", [node("SequenceConstruct", ["A", "B", "C"], ["s"]),
                                   node("SequenceErase", ["s"], ["s1"]),
                                   node("ConcatFromSequence", ["s1"], axis=0)],
    {"A": f32(2), "B": f32(3), "C": f32(4)})
add("SequenceAt-static-element-is-a-reshape-target",
    [node("SequenceConstruct", ["t0", "t1"], ["s"]), node("SequenceAt", ["s", "one"], ["t"]),
     node("Reshape", ["X", "t"])], {"X": SX}, {**SEQ_INITS, "t0": np.asarray([6, 4], np.int64),
                                                "t1": np.asarray([3, -1], np.int64)})
add("SequenceLength-is-static", [node("SplitToSequence", ["X"], ["s"], axis=1),
                                 node("SequenceLength", ["s"], ["n"]),
                                 node("Reshape", ["X", "n"])], {"X": f32(1, 6)})
add("SequenceAt-position-out-of-range-refused",
    [node("SplitToSequence", ["X"], ["s"], axis=0), node("SequenceAt", ["s", "five"])], {"X": SX},
    {"five": np.asarray(5, np.int64)}, refuse="sequence position 5 out of range for length 4")
add("SequenceAt-runtime-position-refused",
    [node("SplitToSequence", ["X"], ["s"], axis=0), node("SequenceAt", ["s", "P"])],
    {"X": SX, "P": np.asarray(1, np.int64)},
    refuse="SequenceAt: position must be static (trace-time constant)")
add("SequenceInsert-runtime-position-refused",
    [node("SequenceEmpty", [], ["e"]), node("SequenceInsert", ["e", "X", "P"], ["s"]),
     node("ConcatFromSequence", ["s"], axis=0)], {"X": SX, "P": np.asarray(0, np.int64)},
    refuse="SequenceInsert: position must be static (trace-time constant)")
add("SequenceErase-empty-refused", [node("SequenceEmpty", [], ["e"]), node("SequenceErase", ["e"], ["s"]),
                                    node("SequenceLength", ["s"])], {"X": SX},
    refuse="SequenceErase on empty sequence")
add("ConcatFromSequence-empty-refused", [node("SequenceEmpty", [], ["e"]),
                                         node("ConcatFromSequence", ["e"], axis=0)], {"X": SX},
    refuse="ConcatFromSequence on empty sequence")
add("SequenceAt-of-a-tensor-refused", node("SequenceAt", ["X", "one"]), {"X": SX}, SEQ_INITS,
    refuse="SequenceAt: input is not a sequence")
add("SplitToSequence-runtime-split-refused", [node("SplitToSequence", ["X", "S"], ["s"]),
                                              node("ConcatFromSequence", ["s"], axis=0)],
    {"X": SX, "S": np.asarray([2, 2], np.int64)}, refuse="SplitToSequence: split sizes must be static")
add("Sequence-graph-output-refused", node("SplitToSequence", ["X"], axis=0), {"X": SX},
    refuse="model 't' output 'Y' is a sequence")
add("Optional-Has-Get", [node("Optional", ["X"], ["o"]), node("OptionalHasElement", ["o"], ["H"]),
                         node("OptionalGetElement", ["o"], ["Y"])], {"X": SX}, outputs=("H", "Y"))
add("Optional-empty-has-no-element", [node("Optional", [""], ["o"]), node("OptionalHasElement", ["o"], ["H"]),
                                      node("Cast", ["H"], ["h"], to=DataType.FLOAT),
                                      node("Add", ["X", "h"])], {"X": SX})
add("OptionalGetElement-empty-refused", [node("Optional", [], ["o"]), node("OptionalGetElement", ["o"], ["g"]),
                                         node("Add", ["X", "g"])], {"X": SX},
    refuse="OptionalGetElement on empty optional")
add("Optional-of-a-sequence", [node("SplitToSequence", ["X"], ["s"], axis=1), node("Optional", ["s"], ["o"]),
                               node("OptionalGetElement", ["o"], ["g"]),
                               node("ConcatFromSequence", ["g"], axis=0)], {"X": SX})

# --- DFT, STFT, MelWeightMatrix ---------------------------------------------------------------------
add("DFT-real", node("DFT", ["X"]), {"X": f32(2, 16, 1)}, tol=SUMS)
add("DFT-complex", node("DFT", ["X"]), {"X": f32(3, 12, 2)}, tol=SUMS)
add("DFT-complex-inverse", node("DFT", ["X"], inverse=1), {"X": f32(3, 12, 2)}, tol=SUMS)
add("DFT-real-inverse", node("DFT", ["X"], inverse=1), {"X": f32(2, 10, 1)}, tol=SUMS)
add("DFT-onesided-axis2", node("DFT", ["X"], axis=2, onesided=1), {"X": f32(2, 5, 8, 1)}, tol=SUMS)
add("DFT-onesided-odd", node("DFT", ["X"], onesided=1), {"X": f32(2, 9, 1)}, tol=SUMS)
add("DFT-negative-axis", node("DFT", ["X"], axis=-3), {"X": f32(4, 6, 3, 2)}, tol=SUMS)
for n in (16, 8):
    add(f"DFT-length-{n}", node("DFT", ["X", "n"]), {"X": f32(1, 10, 1)}, {"n": np.asarray(n, np.int64)},
        tol=SUMS)
add("DFT-axis-input", node("DFT", ["X", "", "a"]), {"X": f32(2, 6, 5, 2)}, {"a": np.asarray(2, np.int64)},
    tol=SUMS)
add("DFT-inverse-onesided-refused", node("DFT", ["X"], inverse=1, onesided=1), {"X": f32(2, 8, 2)},
    refuse="DFT: inverse and onesided are mutually exclusive")
add("DFT-component-axis-refused", node("DFT", ["X"], axis=2), {"X": f32(2, 8, 2)},
    refuse="DFT: axis cannot be the component dimension")
add("DFT-components-refused", node("DFT", ["X"]), {"X": f32(2, 8, 3)},
    refuse="DFT: last dimension must be 1 (real) or 2 (complex)")
add("DFT-runtime-length-refused", node("DFT", ["X", "N"]), {"X": f32(2, 8, 1), "N": np.asarray(8, np.int64)},
    refuse="DFT: dft_length must be statically known")
add("DFT-runtime-axis-refused", node("DFT", ["X", "", "A"]), {"X": f32(2, 8, 1), "A": np.asarray(1, np.int64)},
    refuse="DFT: axis must be statically known")
SIG = f32(2, 64, 1)
add("STFT-hann-window", node("STFT", ["X", "step", "w"]), {"X": SIG},
    {"step": np.asarray(8, np.int64), "w": np.hanning(16).astype(np.float32)}, tol=SUMS)
add("STFT-window-and-length", node("STFT", ["X", "step", "w", "n"]), {"X": SIG},
    {"step": np.asarray(5, np.int64), "w": np.hamming(12).astype(np.float32), "n": np.asarray(12, np.int64)},
    tol=SUMS)
add("STFT-length-no-window-twosided", node("STFT", ["X", "step", "", "n"], onesided=0), {"X": f32(1, 32, 1)},
    {"step": np.asarray(16, np.int64), "n": np.asarray(16, np.int64)}, tol=SUMS)
add("STFT-complex-twosided", node("STFT", ["X", "step", "w"], onesided=0), {"X": f32(2, 40, 2)},
    {"step": np.asarray(6, np.int64), "w": np.hanning(10).astype(np.float32)}, tol=SUMS)
add("STFT-runtime-window", node("STFT", ["X", "step", "W"]),
    {"X": SIG, "W": np.hanning(16).astype(np.float32)}, {"step": np.asarray(8, np.int64)}, tol=SUMS)
add("STFT-runtime-step-refused", node("STFT", ["X", "S", "w"]),
    {"X": SIG, "S": np.asarray(8, np.int64)}, {"w": np.hanning(16).astype(np.float32)},
    refuse="STFT: frame_step must be statically known")
add("STFT-no-window-no-length-refused", node("STFT", ["X", "step"]), {"X": SIG},
    {"step": np.asarray(8, np.int64)}, refuse="STFT: needs window or frame_length")
add("STFT-onesided-complex-refused", node("STFT", ["X", "step", "w"]), {"X": f32(2, 40, 2)},
    {"step": np.asarray(6, np.int64), "w": np.hanning(10).astype(np.float32)},
    refuse="STFT: onesided requires a real signal")
add("STFT-short-signal-refused", node("STFT", ["X", "step", "w"]), {"X": f32(1, 8, 1)},
    {"step": np.asarray(2, np.int64), "w": np.hanning(10).astype(np.float32)},
    refuse="STFT: signal shorter than one frame")
add("STFT-components-refused", node("STFT", ["X", "step", "w"]), {"X": f32(1, 32, 3)},
    {"step": np.asarray(2, np.int64), "w": np.hanning(10).astype(np.float32)},
    refuse="STFT: last dimension must be 1 (real) or 2")
MEL_INS = ["nm", "dl", "sr", "lo", "hi"]
for cid, vals, dt in (("small", (8, 16, 8192, 0.0, 4096.0), 1), ("whisper-f64", (80, 400, 16000, 0.0, 8000.0), 11),
                      ("narrow-band", (10, 64, 16000, 300.0, 3400.0), 1)):
    add(f"MelWeightMatrix-{cid}", [node("MelWeightMatrix", MEL_INS, ["m"], output_datatype=dt),
                                   node("MatMul", ["X", "m"])],
        {"X": f32(3, vals[1] // 2 + 1, lo=0.0, hi=5.0)},
        dict(zip(MEL_INS, [np.asarray(v, np.int64) for v in vals[:3]]
                 + [np.asarray(v, np.float32) for v in vals[3:]])), tol=SUMS)
add("MelWeightMatrix-runtime-refused", [node("MelWeightMatrix", ["NM", "dl", "sr", "lo", "hi"], ["m"]),
                                        node("MatMul", ["X", "m"])],
    {"X": f32(3, 9), "NM": np.asarray(8, np.int64)},
    {"dl": np.asarray(16, np.int64), "sr": np.asarray(8192, np.int64), "lo": np.asarray(0.0, np.float32),
     "hi": np.asarray(4096.0, np.float32)}, refuse="MelWeightMatrix: all five inputs must be statically known")

# --- GridSample, RoiAlign, DeformConv -----------------------------------------------------------------
GS_X = f32(2, 3, 5, 7)
GS_GRID = f32(2, 4, 6, 2, lo=-1.4, hi=1.4)
for mode in ("linear", "nearest", "bilinear"):
    for padding in ("zeros", "border", "reflection"):
        for align in (0, 1):
            if mode == "bilinear" and (padding, align) != ("zeros", 0):
                continue
            add(f"GridSample-{mode}-{padding}-align{align}",
                node("GridSample", ["X", "G"], mode=mode, padding_mode=padding, align_corners=align),
                {"X": GS_X, "G": GS_GRID}, tol=SUMS)
GS_EDGE = np.asarray([[[[NAN, 0.0], [INF, 0.2], [-0.5, -INF], [0.25, 0.25], [1.0, -1.0], [-1.0, 1.0]]]],
                     np.float32)
for mode in ("linear", "nearest"):
    for padding in ("zeros", "border", "reflection"):
        add(f"GridSample-{mode}-{padding}-edges", node("GridSample", ["X", "G"], mode=mode, padding_mode=padding),
            {"X": GS_X[:1], "G": GS_EDGE}, tol=SUMS)
add("GridSample-nearest-half-to-even", node("GridSample", ["X", "G"], mode="nearest", align_corners=1),
    {"X": f32(1, 1, 5, 5), "G": np.asarray([[[[-0.75, -0.25], [0.25, 0.75]]]], np.float32)})
add("GridSample-mode-refused", node("GridSample", ["X", "G"], mode="bicubic"), {"X": GS_X, "G": GS_GRID},
    refuse="GridSample: unsupported mode 'bicubic'")
add("GridSample-padding-refused", node("GridSample", ["X", "G"], padding_mode="mirror"),
    {"X": GS_X, "G": GS_GRID}, refuse="GridSample: unsupported padding_mode 'mirror'")
add("GridSample-5d-refused", node("GridSample", ["X", "G"]), {"X": f32(1, 1, 2, 3, 4), "G": f32(1, 2, 2, 2, 3)},
    refuse="GridSample: only 4-D (NCHW) input is supported")
RA_X = f32(2, 3, 10, 12, lo=0.1, hi=1.0)
RA_ROIS = np.asarray([[1.0, 1.0, 8.0, 6.0], [0.0, 0.0, 11.0, 9.0], [2.5, 3.5, 7.0, 7.0],
                      [-3.0, -2.0, 1.0, 0.5], [9.0, 7.0, 30.0, 25.0]], np.float32)
RA_B = np.asarray([0, 1, 0, 1, 0], np.int64)
for mode in ("avg", "max"):
    for ctm in ("half_pixel", "output_half_pixel"):
        add(f"RoiAlign-{mode}-{ctm}", node("RoiAlign", ["X", "R", "I"], output_height=3, output_width=4,
                                           sampling_ratio=2, mode=mode, coordinate_transformation_mode=ctm),
            {"X": RA_X, "R": RA_ROIS, "I": RA_B}, tol=SUMS)
        add(f"RoiAlign-{mode}-{ctm}-adaptive-static-rois",
            node("RoiAlign", ["X", "r", "i"], output_height=2, output_width=3, spatial_scale=0.5, mode=mode,
                 coordinate_transformation_mode=ctm),
            {"X": RA_X}, {"r": RA_ROIS, "i": RA_B}, tol=SUMS)
add("RoiAlign-adaptive-runtime-rois-refused", node("RoiAlign", ["X", "R", "I"]),
    {"X": RA_X, "R": RA_ROIS, "I": RA_B}, refuse="RoiAlign: sampling_ratio=0 (adaptive) needs static rois")
add("RoiAlign-mode-refused", node("RoiAlign", ["X", "R", "I"], mode="sum", sampling_ratio=1),
    {"X": RA_X, "R": RA_ROIS, "I": RA_B}, refuse="RoiAlign: unsupported mode 'sum'")


def deform_case(cid, n=1, c=4, h=6, w=7, oc=4, k=3, stride=1, pad=0, dil=1, group=1, og=1, mask=False,
                bias=False, zero=False):
    oh = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    ow = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    offset = (np.zeros((n, og * 2 * k * k, oh, ow), np.float32) if zero
              else f32(n, og * 2 * k * k, oh, ow, lo=-1.5, hi=1.5))
    feeds = {"X": f32(n, c, h, w), "O": offset}
    inits = {"W": f32(oc, c // group, k, k)}
    ins = ["X", "W", "O", "", ""]
    if bias:
        ins[3] = "B"
        inits["B"] = f32(oc)
    if mask:
        ins[4] = "M"
        feeds["M"] = f32(n, og * k * k, oh, ow, lo=0.2, hi=1.0)
    add(cid, node("DeformConv", ins, kernel_shape=[k, k], strides=[stride, stride], pads=[pad] * 4,
                  dilations=[dil, dil], group=group, offset_group=og), feeds, inits, tol=SUMS)


deform_case("DeformConv-zero-offsets-bias", n=2, zero=True, bias=True)
deform_case("DeformConv-random-offsets", stride=2, pad=1)
deform_case("DeformConv-groups-offset-groups-mask", group=2, og=2, mask=True, stride=2, pad=1)
deform_case("DeformConv-dilation", dil=2, pad=2, oc=6)
add("DeformConv-3d-refused", node("DeformConv", ["X", "W", "O"]),
    {"X": f32(1, 2, 4), "O": f32(1, 6, 2)}, {"W": f32(2, 2, 3)},
    refuse="DeformConv: only 2-D (NCHW) input is supported")


# --- the random family: properties -------------------------------------------------------------------
def _moments(mean, std, n):
    def check(outs):
        v = np.asarray(outs[0])
        assert v.shape == (n,) and v.dtype == np.float32, (v.shape, v.dtype)
        assert abs(v.mean() - mean) < 0.02 and abs(v.std() - std) < 0.02, (v.mean(), v.std())
    return check


def _uniform(lo, hi, shape):
    def check(outs):
        v = np.asarray(outs[0])
        assert v.shape == shape and v.dtype == np.float32, (v.shape, v.dtype)
        assert (v >= lo).all() and (v < hi).all()
        assert abs(v.mean() - (lo + hi) / 2) < 0.03 * (hi - lo)
    return check


def _bernoulli(p, dtype):
    def check(outs):
        v = np.asarray(outs[0])
        assert v.dtype == dtype and set(np.unique(v)) <= {0, 1}, (v.dtype, np.unique(v))
        assert abs(v.mean() - p) < 0.02, v.mean()
    return check


def _multinomial(outs):
    m = np.asarray(outs[0])
    assert m.shape == (2, 400) and m.dtype.kind == "i", (m.shape, m.dtype)
    assert (m[0] == 2).mean() > 0.9 and ((m[1] >= 0) & (m[1] < 3)).all()
    assert abs((m[1] == 0).mean() - 0.5) < 0.1


RANDOM = {
    "RandomNormal": (node("RandomNormal", [], shape=[20000], seed=3.0, mean=2.0, scale=0.5), {},
                     _moments(2.0, 0.5, 20000)),
    "RandomNormal-unseeded": (node("RandomNormal", [], shape=[20000]), {}, _moments(0.0, 1.0, 20000)),
    "RandomNormal-f64-is-f32": (node("RandomNormal", [], shape=[20000], dtype=11, seed=5.0), {},
                                _moments(0.0, 1.0, 20000)),
    "RandomUniform": (node("RandomUniform", [], shape=[5000], low=2.0, high=3.0), {}, _uniform(2.0, 3.0, (5000,))),
    "RandomNormalLike": (node("RandomNormalLike", ["X"], seed=1.0), {"X": np.zeros((200, 100), np.float32)},
                         lambda outs: _moments(0.0, 1.0, 20000)([np.asarray(outs[0]).reshape(-1)])),
    "RandomUniformLike": (node("RandomUniformLike", ["X"], low=-1.0, high=1.0, seed=2.0),
                          {"X": np.zeros((50, 40), np.int64)}, _uniform(-1.0, 1.0, (50, 40))),
    "Bernoulli": (node("Bernoulli", ["X"], seed=1.0), {"X": np.full((20000,), 0.3, np.float32)},
                  _bernoulli(0.3, np.float32)),
    "Bernoulli-dtype": (node("Bernoulli", ["X"], seed=1.0, dtype=1), {"X": np.full((20000,), 0.7, np.float32)},
                        _bernoulli(0.7, np.float32)),
    "Multinomial": (node("Multinomial", ["X"], sample_size=400, seed=2.0),
                    {"X": np.log(np.asarray([[0.005, 0.005, 0.99], [0.5, 0.25, 0.25]], np.float32))},
                    _multinomial),
}
for rid, (n, feeds, props) in RANDOM.items():
    add(f"random-{rid}", n, feeds or {"Z": np.zeros(1, np.float32)}, props=props)
