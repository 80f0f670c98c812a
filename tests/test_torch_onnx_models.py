"""Whole ONNX models through both packages on the CPU: every case of
``test_onnx_cnn.py``, ``test_onnx_transformer.py`` and
``test_onnx_control_flow.py``, the seven graphs of ``onnx/builder.py`` (the
MobileNetV3-Small stand-in at its real input, through ``predict_from_blob``
at batch 1 and 2), and the control-flow refusals.

Tolerances, of the output's largest magnitude: f32 models 1e-5 (the repo's
parity bound; runs on this CPU show at most 5.5e-7 for the stand-in and
4.1e-7 for the transformer encoder, since Conv and MatMul sum in another
order). Under the bf16 and int8 policies a one-ulp difference in an f32
activation can move a value across a bf16 or int8 rounding boundary, and
one such flip moves an output by one rounding step of its operand: the
port stays within 1e-2 (bf16) and 2e-2 (int8) of ``infera_tpu``'s output
at its largest, and within 5e-4 / 1e-3 on average, a fraction of either
policy's own distance from f32 (0.0055 and 0.024 here; infera_tpu's own test
allows 0.02 and 0.05).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu.errors import OnnxError as RefOnnxError
from infera_tpu.onnx.executor import compile_model_bytes as ref_compile
from infera_tpu_torch.errors import OnnxError
from infera_tpu_torch.onnx import builder, proto
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
from infera_tpu_torch.registry import MODELS as PORT_MODELS

F32_MODEL = 1e-5
BOUNDS = {"bf16": (1e-2, 5e-4), "int8": (2e-2, 1e-3)}  # (max, mean) of max|y|


@pytest.fixture(autouse=True)
def port_on_cpu():
    itt.set_device("cpu")
    yield
    itt.set_device(None)


@pytest.fixture()
def registries(clean_registry):
    PORT_MODELS.clear()
    yield
    PORT_MODELS.clear()


def _run_both(model, *xs, precision="f32"):
    data = model if isinstance(model, bytes) else model.serialize()
    want = [np.asarray(o) for o in ref_compile(data, "ref", precision).run(*xs)]
    got = [o.numpy() for o in port_compile(data, "port", precision, device="cpu").run(*xs)]
    assert len(got) == len(want)
    return got, want


def _close(got, want, rel=F32_MODEL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, float(np.abs(got - want).max()) / scale


def _refused(model, *xs):
    """Both packages refuse the graph; returns the two messages."""
    data = model.serialize()
    with pytest.raises(RefOnnxError) as want:
        ref_compile(data, "ref").run(*xs)
    with pytest.raises(OnnxError) as got:
        port_compile(data, "port", device="cpu").run(*xs)
    return str(got.value), str(want.value)


def _vi(name, shape, dt=DataType.FLOAT):
    return ValueInfo(name=name, elem_type=dt, shape=list(shape))


def _node(op, ins, outs, **attrs):
    return Node(op_type=op, inputs=list(ins), outputs=list(outs), name=op.lower(),
                attributes={k: Attribute.make(k, v) for k, v in attrs.items()})


# --- the seven graphs of onnx/builder.py ---------------------------------------

RNG = np.random.default_rng(15)
GRAPHS = {
    "linear": (builder.linear_model(), [RNG.standard_normal((7, 3))]),
    "multi_output": (builder.multi_output_model(), [RNG.standard_normal((1, 4))]),
    "mlp": (builder.mlp_model(in_dim=16, hidden=(32, 32), out_dim=8), [RNG.standard_normal((33, 16))]),
    "transformer": (builder.transformer_encoder_model(), [RNG.standard_normal((3, 16 * 64))]),
    "if-runtime-then": (builder.if_model(), [np.abs(RNG.standard_normal((2, 4)))]),
    "if-runtime-else": (builder.if_model(), [-np.abs(RNG.standard_normal((2, 4)))]),
    "if-static-true": (builder.if_model(static_cond=True), [RNG.standard_normal((2, 4))]),
    "if-static-false": (builder.if_model(static_cond=False), [RNG.standard_normal((2, 4))]),
    "loop-while": (builder.loop_model(trips=5), [RNG.standard_normal((3, 4))]),
    "loop-scan-outputs": (builder.loop_model(trips=4, scan_output=True), [RNG.standard_normal((2, 4))]),
    "scan": (builder.scan_model(), [RNG.standard_normal((6, 4))]),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_builder_graph_matches_infera_tpu(name):
    model, xs = GRAPHS[name]
    got, want = _run_both(model, *[x.astype(np.float32) for x in xs])
    for g, w in zip(got, want):
        _close(g, w)


def test_mobilenet_stand_in_through_predict_from_blob(tmp_path, registries):
    """The stand-in at its fixed input [1, 3, 224, 224]: the reference's
    602,112-byte blob (zeros), a seeded image, and a batch of two images
    through the fixed-batch path, on both packages' API."""
    path = str(tmp_path / "mobilenet.onnx")
    proto.save_model_file(builder.mobilenet_like_model(), path)
    it.load_model("mnv3", path)
    itt.load_model("mnv3", path)
    image = np.random.default_rng(3).standard_normal(3 * 224 * 224).astype("<f4")
    for blob in (bytes(602_112), image.tobytes(),
                 np.concatenate([image, image[::-1]]).tobytes()):
        want, got = it.predict_from_blob("mnv3", blob), itt.predict_from_blob("mnv3", blob)
        rows = len(blob) // 602_112
        assert (got.rows, got.cols) == (want.rows, want.cols) == (rows, 1000)
        assert np.all(np.isfinite(got.data))
        _close(got.data, want.data)
    info = itt.get_model_info("mnv3")
    assert info == it.get_model_info("mnv3")


def test_mobilenet_stand_in_is_the_v3_small_table():
    m = builder.mobilenet_like_model()
    n_params = sum(int(np.prod(t.dims)) for t in m.graph.initializers.values())
    assert (n_params, len(m.graph.nodes)) == (2_531_314, 122)
    assert {n.op_type for n in m.graph.nodes} == {
        "Conv", "HardSwish", "Relu", "GlobalAveragePool", "HardSigmoid", "Mul", "Add",
        "Flatten", "Gemm"}


# --- test_onnx_cnn.py's cases --------------------------------------------------


@pytest.mark.parametrize("groups,strides", [(1, (1, 1)), (1, (2, 2)), (8, (1, 1))])
def test_conv_matches(groups, strides):
    from test_onnx_cnn import _conv_model

    cin, cout = 8, 16 if groups == 1 else 8
    model, w, b = _conv_model(groups=groups, strides=strides, cin=cin, cout=cout)
    x = np.random.default_rng(1).standard_normal((2, cin, 16, 16)).astype(np.float32)
    (got,), (want,) = _run_both(model.serialize(), x)
    _close(got, want)
    torch_want = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                          stride=strides, padding=1, groups=groups).numpy()
    np.testing.assert_allclose(got, torch_want, rtol=1e-4, atol=1e-4)


def test_small_cnn_end_to_end():
    """Conv → BatchNorm → Clip(relu6) → GlobalAveragePool → Flatten → Gemm
    → Softmax, the stand-in's block shape."""
    rng = np.random.default_rng(0)
    cin, cmid, ncls = 3, 8, 4
    inits = {
        "W1": rng.standard_normal((cmid, cin, 3, 3)).astype(np.float32) * 0.2,
        "scale": rng.standard_normal(cmid).astype(np.float32) * 0.1 + 1.0,
        "bias": rng.standard_normal(cmid).astype(np.float32) * 0.1,
        "mean": rng.standard_normal(cmid).astype(np.float32) * 0.1,
        "var": np.abs(rng.standard_normal(cmid).astype(np.float32)) + 0.5,
        "WFC": rng.standard_normal((cmid, ncls)).astype(np.float32) * 0.3,
        "BFC": rng.standard_normal(ncls).astype(np.float32) * 0.1,
    }
    g = Graph(
        name="cnn",
        nodes=[
            _node("Conv", ["X", "W1"], ["c1"], kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
            _node("BatchNormalization", ["c1", "scale", "bias", "mean", "var"], ["b1"], epsilon=1e-5),
            _node("Clip", ["b1"], ["r1"], min=0.0, max=6.0),
            _node("GlobalAveragePool", ["r1"], ["p1"]),
            _node("Flatten", ["p1"], ["f1"]),
            _node("Gemm", ["f1", "WFC", "BFC"], ["l1"]),
            _node("Softmax", ["l1"], ["Y"], axis=-1),
        ],
        initializers={k: Tensor.from_array(k, v) for k, v in inits.items()},
        inputs=[_vi("X", [-1, cin, 8, 8])],
        outputs=[_vi("Y", [-1, ncls])],
    )
    x = rng.standard_normal((4, cin, 8, 8)).astype(np.float32)
    (got,), (want,) = _run_both(Model(graph=g), x)
    assert got.shape == (4, ncls)
    _close(got, want)


@pytest.mark.parametrize("op", ["MaxPool", "AveragePool"])
def test_maxpool_and_avgpool(op):
    g = Graph(name="pool", nodes=[_node(op, ["X"], ["Y"], kernel_shape=[2, 2], strides=[2, 2])],
              inputs=[_vi("X", [-1, 2, 8, 8])], outputs=[_vi("Y", [-1, 2, 4, 4])])
    x = np.random.default_rng(0).standard_normal((1, 2, 8, 8)).astype(np.float32)
    (got,), (want,) = _run_both(Model(graph=g), x)
    _close(got, want)


def test_blob_cnn_batch_inference(tmp_path, registries):
    """The batch of a blob follows from its length (two images here)."""
    from test_onnx_cnn import _conv_model

    model, _, _ = _conv_model()
    path = str(tmp_path / "cnn.onnx")
    proto.save_model_file(model, path)
    it.load_model("cnn", path)
    itt.load_model("cnn", path)
    blob = np.random.default_rng(4).standard_normal(2 * 8 * 16 * 16).astype("<f4").tobytes()
    want, got = it.predict_from_blob("cnn", blob), itt.predict_from_blob("cnn", blob)
    assert got.rows == want.rows == 2
    _close(got.data, want.data)


# --- test_onnx_transformer.py's cases ---------------------------------------------


def test_single_head_attention_block():
    rng = np.random.default_rng(0)
    seq, d = 16, 32
    inits = {k: rng.standard_normal((d, d)).astype(np.float32) * 0.2 for k in ("WQ", "WK", "WV")}
    inits["scale"] = np.asarray(np.float32(1.0 / np.sqrt(d)))
    nodes = [
        _node("MatMul", ["X", "WQ"], ["Q"]),
        _node("MatMul", ["X", "WK"], ["K"]),
        _node("MatMul", ["X", "WV"], ["V"]),
        _node("Transpose", ["K"], ["KT"], perm=[1, 0]),
        _node("MatMul", ["Q", "KT"], ["QK"]),
        _node("Mul", ["QK", "scale"], ["QKs"]),
        _node("Softmax", ["QKs"], ["A"], axis=-1),
        _node("MatMul", ["A", "V"], ["AV"]),
        _node("Add", ["AV", "X"], ["R"]),
        _node("ReduceMean", ["R"], ["mu"], axes=[-1], keepdims=1),
        _node("Sub", ["R", "mu"], ["Y"]),
    ]
    g = Graph(name="attn", nodes=nodes,
              initializers={k: Tensor.from_array(k, v) for k, v in inits.items()},
              inputs=[_vi("X", [seq, d])], outputs=[_vi("Y", [seq, d])])
    x = rng.standard_normal((seq, d)).astype(np.float32)
    (got,), (want,) = _run_both(Model(graph=g), x)
    _close(got, want)


def test_layernorm_and_gelu_ops():
    rng = np.random.default_rng(0)
    d = 16
    g = Graph(
        name="ln",
        nodes=[_node("LayerNormalization", ["X", "S", "B"], ["L"], axis=-1, epsilon=1e-5),
               _node("Gelu", ["L"], ["Y"])],
        initializers={"S": Tensor.from_array("S", rng.standard_normal(d).astype(np.float32)),
                      "B": Tensor.from_array("B", rng.standard_normal(d).astype(np.float32))},
        inputs=[_vi("X", [-1, d])], outputs=[_vi("Y", [-1, d])])
    x = rng.standard_normal((8, d)).astype(np.float32)
    (got,), (want,) = _run_both(Model(graph=g), x)
    _close(got, want)


def test_transformer_encoder_matches():
    """The encoder at ``onnx.builder``'s widths (seq 16, d_model 64, 4 heads, 2
    layers, 8 classes)."""
    m = builder.transformer_encoder_model(seq=16, d_model=64, n_heads=4, n_layers=2, n_classes=8)
    x = np.random.default_rng(1).standard_normal((3, 16 * 64)).astype(np.float32)
    (got,), (want,) = _run_both(m, x)
    assert got.shape == (3, 8)
    _close(got, want)


def test_transformer_encoder_through_sql_blob(tmp_path, registries):
    from infera_tpu.registry import MODELS as REF_MODELS
    from infera_tpu.sql import Connection as RefConnection
    from infera_tpu_torch.sql import Connection

    path = tmp_path / "tfenc.onnx"
    proto.save_model_file(builder.transformer_encoder_model(seq=4, d_model=16, n_heads=2,
                                                            n_layers=1, n_classes=3), path)
    query = ("select infera_predict_from_blob('tfenc', "
             f"cast(repeat(chr(0), {4 * 16 * 4}) as blob)) r")
    rows = []
    for conn in (RefConnection(), Connection()):
        conn.execute(f"select infera_load_model('tfenc', '{path}')")
        rows.append(conn.execute(query).rows)
    REF_MODELS.clear()
    (want,), (got,) = rows[0], rows[1]
    assert len(got[0]) == len(want[0]) == 3
    _close(np.asarray(got[0], np.float32), np.asarray(want[0], np.float32))


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_transformer_encoder_quantized_paths(precision):
    """bf16 and int8 reach the encoder's MatMul weights through the generic
    graph path, as in infera_tpu; the port holds to infera_tpu's output
    within the policy's rounding flips (module docstring)."""
    m = builder.transformer_encoder_model()
    data = m.serialize()
    x = np.random.default_rng(0).standard_normal((256, 16 * 64)).astype(np.float32)
    (f32,), _ = _run_both(data, x)
    (got,), (want,) = _run_both(data, x, precision=precision)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    worst, mean = BOUNDS[precision]
    assert err.max() <= worst * scale and err.mean() <= mean * scale, (err.max() / scale, err.mean() / scale)
    own = {"bf16": 0.02, "int8": 0.05}[precision]  # infera_tpu's own test
    assert np.abs(got - f32).max() / np.abs(f32).max() < own


# --- test_onnx_control_flow.py's cases ----------------------------------------------


@pytest.mark.parametrize("static_cond", [True, False])
def test_if_static_condition_folds(static_cond):
    x = np.arange(8, dtype=np.float32).reshape(2, 4) - 3.0
    (got,), (want,) = _run_both(builder.if_model(static_cond=static_cond), x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, 2 * x + 1 if static_cond else -x, rtol=1e-6)


def test_if_runtime_condition():
    for value, expect in ((1.5, 4.0), (-1.5, 1.5)):
        x = np.full((2, 4), value, np.float32)
        (got,), (want,) = _run_both(builder.if_model(), x)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, np.full((2, 4), expect), rtol=1e-6)


def test_loop_while_path():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    (got,), (want,) = _run_both(builder.loop_model(trips=5), x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, 6 * x, rtol=1e-6)


def test_loop_scan_output_path():
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    got, want = _run_both(builder.loop_model(trips=4, scan_output=True), x)
    np.testing.assert_allclose(got[0], 5 * x, rtol=1e-6)
    np.testing.assert_allclose(got[1], [(k + 2) * x.sum() for k in range(4)], rtol=1e-5)
    for g, w in zip(got, want):
        _close(g, w)


def test_scan_cumsum():
    x = np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)
    got, want = _run_both(builder.scan_model(), x)
    np.testing.assert_allclose(got[1], np.cumsum(x, 0), rtol=1e-5, atol=1e-6)
    for g, w in zip(got, want):
        _close(g, w)


def _early_exit_loop(scan_output=False, trips=10):
    """The body reports cond = (i < 2): iterations 0, 1 and 2 run their Add,
    the loop stops before i = 3; with a scan output all ``trips`` rows come
    out, those after the exit from the frozen state."""
    nodes = [_node("Less", ["i", "two"], ["c_out"]), _node("Add", ["v_in", "X"], ["v_out"])]
    outputs = [_vi("c_out", [], DataType.BOOL), _vi("v_out", [-1, 4])]
    if scan_output:
        nodes.append(_node("ReduceSum", ["v_out"], ["s_out"], keepdims=0))
        outputs.append(_vi("s_out", []))
    body = Graph(name="body", nodes=nodes,
                 inputs=[_vi("i", [], DataType.INT64), _vi("c_in", [], DataType.BOOL),
                         _vi("v_in", [-1, 4])],
                 outputs=outputs)
    loop_outs = ["Y", "S"] if scan_output else ["Y"]
    g = Graph(
        name="EarlyExit",
        nodes=[_node("Loop", ["M", "go", "X"], loop_outs, body=body)],
        initializers={"M": Tensor.from_array("M", np.asarray(trips, np.int64)),
                      "go": Tensor.from_array("go", np.asarray(True, np.bool_)),
                      "two": Tensor.from_array("two", np.asarray(2, np.int64))},
        inputs=[_vi("X", [-1, 4])],
        outputs=[_vi(o, [-1]) for o in loop_outs])
    return Model(graph=g, opset_imports=[("", 17)])


def test_loop_early_exit_exact():
    x = np.ones((2, 4), np.float32)
    (got,), (want,) = _run_both(_early_exit_loop(), x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, 4 * x)


def test_loop_scan_outputs_with_early_exit():
    x = np.ones((2, 4), np.float32)
    got, want = _run_both(_early_exit_loop(scan_output=True, trips=6), x)
    np.testing.assert_array_equal(got[0], 4 * x)
    # rows 0-2 from the running state; rows 3-5 from the frozen 4x, plus X
    np.testing.assert_array_equal(got[1], [16.0, 24.0, 32.0, 40.0, 40.0, 40.0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_subgraph_reads_a_computed_outer_value():
    """A Loop body reads ``H``, which a node of the parent graph computes
    (outer-scope capture beyond the graph's inputs and initializers)."""
    body = Graph(
        name="body",
        nodes=[_node("Identity", ["c_in"], ["c_out"]), _node("Mul", ["v_in", "H"], ["v_out"])],
        inputs=[_vi("i", [], DataType.INT64), _vi("c_in", [], DataType.BOOL), _vi("v_in", [-1, 4])],
        outputs=[_vi("c_out", [], DataType.BOOL), _vi("v_out", [-1, 4])])
    g = Graph(
        name="Outer",
        nodes=[_node("Tanh", ["X"], ["H"]), _node("Loop", ["M", "", "X"], ["Y"], body=body)],
        initializers={"M": Tensor.from_array("M", np.asarray(3, np.int64))},
        inputs=[_vi("X", [-1, 4])], outputs=[_vi("Y", [-1, 4])])
    x = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    (got,), (want,) = _run_both(Model(graph=g), x)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, x * np.tanh(x) ** 3, rtol=1e-5)


def test_refusals_keep_infera_tpus_message_prefix():
    x = np.ones((2, 4), np.float32)
    # scan outputs with a trip count known only at run time
    m = builder.loop_model(trips=3, scan_output=True)
    g = m.graph
    g.nodes.insert(0, _node("Shape", ["X"], ["shp"]))
    g.nodes.insert(1, _node("ReduceSum", ["shp"], ["n"], keepdims=0))
    g.nodes[2].inputs[0] = "n"
    got, want = _refused(m, x)
    prefix = "ONNX error: Loop '': scan outputs require a statically known trip count"
    assert got.startswith(prefix) and want.startswith(prefix), (got, want)
    # a body that changes a carried value's shape
    m = _early_exit_loop()
    m.graph.nodes[0].attr("body").nodes[1] = _node("Concat", ["v_in", "X"], ["v_out"], axis=0)
    got, want = _refused(m, x)
    prefix = "ONNX error: Loop 'loop': body must preserve the shapes/dtypes of loop-carried values"
    assert got.startswith(prefix) and want.startswith(prefix), (got, want)


def test_probit_post_transform():
    from scipy.stats import norm

    from infera_tpu_torch.onnx.ml_ops import _post_transform

    p = np.asarray([0.1, 0.25, 0.5, 0.9], np.float32)
    got = _post_transform(torch.from_numpy(p), "PROBIT").numpy()
    np.testing.assert_allclose(got, norm.ppf(p), rtol=1e-4, atol=1e-5)


def test_softmax_zero_post_transform():
    from infera_tpu_torch.onnx.ml_ops import _post_transform

    y = np.asarray([[1.0, 0.0, 2.0], [0.0, 0.0, 0.0]], np.float32)
    got = _post_transform(torch.from_numpy(y), "SOFTMAX_ZERO").numpy()
    e1, e2 = np.exp(1.0 - 2.0), np.exp(0.0)
    np.testing.assert_allclose(got[0], [e1 / (e1 + e2), 0.0, e2 / (e1 + e2)], rtol=1e-5)
    np.testing.assert_allclose(got[1], [0.0, 0.0, 0.0], atol=1e-7)


def test_static_values_reach_the_device_once(monkeypatch):
    """Initializers, a Loop body's included, move at load; a Constant and a
    Shape output meeting a device op move at the first run and are reused
    from the node's cache after it (the Shape output is a new array of the
    same values on each run): a second run moves only its input."""
    from infera_tpu_torch.onnx import executor

    body = Graph(
        name="body",
        nodes=[_node("Identity", ["c_in"], ["c_out"]), _node("Add", ["v_in", "step"], ["v_out"])],
        initializers={"step": Tensor.from_array("step", np.float32(0.5))},
        inputs=[_vi("i", [], DataType.INT64), _vi("c_in", [], DataType.BOOL), _vi("v_in", [-1, 4])],
        outputs=[_vi("c_out", [], DataType.BOOL), _vi("v_out", [-1, 4])])
    g = Graph(
        name="Static",
        nodes=[_node("Constant", [], ["c"], value=np.full(4, 2.0, np.float32)),
               _node("Shape", ["X"], ["s"]),
               _node("ConstantOfShape", ["s"], ["z"], value=np.asarray([1.0], np.float32)),
               _node("Cast", ["s"], ["sf"], to=DataType.FLOAT),
               _node("Mul", ["X", "c"], ["xc"]),
               _node("Add", ["xc", "z"], ["xz"]),
               _node("ReduceSum", ["sf"], ["n"], keepdims=0),
               _node("Loop", ["M", "", "xz"], ["l"], body=body),
               _node("Add", ["l", "n"], ["Y"])],
        initializers={"M": Tensor.from_array("M", np.asarray(3, np.int64))},
        inputs=[_vi("X", [-1, 4])], outputs=[_vi("Y", [-1, 4])])
    moved = []
    real = executor._to_tensor
    monkeypatch.setattr(executor, "_to_tensor", lambda v, d: moved.append(np.shape(v)) or real(v, d))
    model = port_compile(Model(graph=g).serialize(), "static", device="cpu")
    assert sorted(moved) == [(), ()]  # M and the body's step, at load
    x = np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)
    moved.clear()
    first = model.run(x)[0].numpy()
    # the input, the Constant, Cast(Shape) into ReduceSum, the Loop's two
    # flags and its counter
    assert sorted(moved) == [(), (), (), (2,), (3, 4), (4,)]
    moved.clear()
    second = model.run(x)[0].numpy()
    assert moved == [(3, 4)]  # the input alone
    np.testing.assert_array_equal(first, second)
    np.testing.assert_allclose(first, 2 * x + 1 + 1.5 + 7, rtol=1e-6)
    want = np.asarray(ref_compile(Model(graph=g).serialize(), "static").run(x)[0])
    _close(first, want)
