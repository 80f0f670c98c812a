"""Counterparts, on the port, of ``infera_tpu``'s tests of the rest of ONNX:
``test_ops_extra.py``, ``test_ops_longtail.py``, ``test_rnn_ops.py``,
``test_signal_vision_ops.py`` and ``test_sequence_ops.py``, one test for
each of theirs.

Each runs the same op through both packages as a one-node graph (the inputs
those tests hand the op as static values become initializers, the others
runtime inputs) and holds the port to ``infera_tpu`` at the case
tolerances of ``infera_tpu_torch.testing.onnx_cases``, then makes the
original test's own checks (against numpy, torch or the spec) on the
port's output.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from infera_tpu_torch.errors import OnnxError
from infera_tpu_torch.onnx.executor import compile_model_bytes as port_compile
from infera_tpu_torch.onnx.proto import Model
from infera_tpu_torch.testing.onnx_cases import EXACT, SUMS, assert_same, graph, node

def _model(op, inputs, attrs, n_out, runtime):
    names = [(f"i{k}" if v is not None else "") for k, v in enumerate(inputs)]
    feeds = {n: v for k, (n, v) in enumerate(zip(names, inputs)) if v is not None and k in runtime}
    inits = {n: v for k, (n, v) in enumerate(zip(names, inputs)) if v is not None and k not in runtime}
    if not feeds:  # a graph needs one runtime input
        feeds = {"unused": np.zeros(1, np.float32)}
    outs = [f"o{k}" for k in range(n_out)]
    g = graph([node(op, names, outs, **(attrs or {}))], feeds.items(), inits, outs)
    return Model(graph=g, opset_imports=[("", 17)]).serialize(), feeds


def both(op, inputs, attrs=None, n_out=1, runtime=(0,), tol=SUMS):
    """The op's outputs on the port (numpy), held to infera_tpu's. The
    inputs at the ``runtime`` positions are graph inputs, the rest static."""
    from infera_tpu.onnx.executor import compile_model_bytes as ref_compile

    data, feeds = _model(op, inputs, attrs, n_out, set(runtime))
    want = [np.asarray(o) for o in ref_compile(data, "ref").run(*feeds.values())]
    got = [o.cpu().numpy() for o in port_compile(data, "port", device="cpu").run(*feeds.values())]
    assert len(got) == len(want) == n_out
    for g, w in zip(got, want):
        assert_same(g, w, tol, op)
    return got


def refused(op, inputs, attrs=None, n_out=1, runtime=(0,)):
    """Both packages refuse; returns the port's message."""
    from infera_tpu.errors import OnnxError as RefOnnxError
    from infera_tpu.onnx.executor import compile_model_bytes as ref_compile

    data, feeds = _model(op, inputs, attrs, n_out, set(runtime))
    with pytest.raises(RefOnnxError) as want:
        ref_compile(data, "ref").run(*feeds.values())
    with pytest.raises(OnnxError) as got:
        port_compile(data, "port", device="cpu").run(*feeds.values())
    return str(got.value), str(want.value)


# --- test_ops_extra.py -------------------------------------------------------------


def test_trig_and_sign():
    x = np.linspace(-0.9, 0.9, 7).astype(np.float32)
    np.testing.assert_allclose(both("Tan", [x], tol=1e-6)[0], np.tan(x), rtol=1e-6)
    np.testing.assert_allclose(both("Asin", [x], tol=1e-6)[0], np.arcsin(x), rtol=1e-6)
    np.testing.assert_allclose(both("Atanh", [x], tol=1e-6)[0], np.arctanh(x), rtol=1e-5)
    np.testing.assert_array_equal(both("Sign", [x], tol=EXACT)[0], np.sign(x))


def test_isnan_isinf():
    x = np.array([1.0, np.nan, np.inf, -np.inf], np.float32)
    np.testing.assert_array_equal(both("IsNaN", [x], tol=EXACT)[0], [False, True, False, False])
    np.testing.assert_array_equal(both("IsInf", [x], tol=EXACT)[0], [False, False, True, True])
    np.testing.assert_array_equal(both("IsInf", [x], {"detect_negative": 0}, tol=EXACT)[0],
                                  [False, False, True, False])


def test_activations_vs_torch():
    x = np.linspace(-3, 3, 31).astype(np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(both("Selu", [x], tol=1e-6)[0], F.selu(tx).numpy(), rtol=1e-5)
    np.testing.assert_allclose(both("Celu", [x], {"alpha": 1.5}, tol=1e-6)[0], F.celu(tx, 1.5).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(both("HardSwish", [x], tol=1e-6)[0], F.hardswish(tx).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(both("Mish", [x], tol=1e-6)[0], F.mish(tx).numpy(), rtol=1e-5)


def test_shrink_threshold_hardmax():
    x = np.array([-2.0, -0.3, 0.0, 0.4, 3.0], np.float32)
    np.testing.assert_allclose(both("Shrink", [x], {"lambd": 0.5, "bias": 0.1}, tol=EXACT)[0],
                               [-1.9, 0.0, 0.0, 0.0, 2.9], rtol=1e-6)
    np.testing.assert_allclose(both("ThresholdedRelu", [x], {"alpha": 0.35}, tol=EXACT)[0],
                               [0, 0, 0, 0.4, 3.0], rtol=1e-6)
    h = both("Hardmax", [np.array([[1.0, 3.0, 2.0]], np.float32)], tol=EXACT)[0]
    np.testing.assert_array_equal(h, [[0, 1, 0]])


def test_reductions():
    x = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
    np.testing.assert_allclose(both("ReduceL1", [x], {"axes": [1], "keepdims": 0})[0], np.abs(x).sum(1),
                               rtol=1e-6)
    np.testing.assert_allclose(both("ReduceSumSquare", [x], {"axes": [0]})[0], (x * x).sum(0, keepdims=True),
                               rtol=1e-6)
    np.testing.assert_allclose(both("ReduceLogSum", [np.abs(x) + 1], {"axes": [1], "keepdims": 0})[0],
                               np.log((np.abs(x) + 1).sum(1)), rtol=1e-6)


def test_pad_modes():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = both("Pad", [x, np.array([0, 1, 0, 1])], tol=EXACT)[0]
    np.testing.assert_array_equal(got, np.pad(x, [(0, 0), (1, 1)]))
    got = both("Pad", [x, np.array([1, 0, 1, 0]), np.array(7.0, np.float32)], tol=EXACT)[0]
    np.testing.assert_array_equal(got, np.pad(x, [(1, 1), (0, 0)], constant_values=7.0))
    got = both("Pad", [x, np.array([0, 1, 0, 1])], {"mode": "edge"}, tol=EXACT)[0]
    np.testing.assert_array_equal(got, np.pad(x, [(0, 0), (1, 1)], mode="edge"))
    # negative pads trim
    got = both("Pad", [x, np.array([0, -1, 0, 0])], tol=EXACT)[0]
    np.testing.assert_array_equal(got, x[:, 1:])
    # reflect and wrap on a leading axis, wider than the axis (numpy's rule)
    for mode in ("reflect", "wrap"):
        got = both("Pad", [x, np.array([3, 0, 4, 0])], {"mode": mode}, tol=EXACT)[0]
        np.testing.assert_array_equal(got, np.pad(x, [(3, 4), (0, 0)], mode=mode))


def test_depth_space_roundtrip():
    x = np.random.default_rng(1).standard_normal((2, 8, 4, 6)).astype(np.float32)
    d = both("DepthToSpace", [x], {"blocksize": 2}, tol=EXACT)[0]
    assert d.shape == (2, 2, 8, 12)
    np.testing.assert_allclose(both("SpaceToDepth", [d], {"blocksize": 2}, tol=EXACT)[0], x, rtol=1e-6)
    want = torch.pixel_shuffle(torch.from_numpy(x), 2).numpy()
    np.testing.assert_allclose(both("DepthToSpace", [x], {"blocksize": 2, "mode": "CRD"}, tol=EXACT)[0],
                               want, rtol=1e-6)


def test_trilu_cumsum():
    x = np.random.default_rng(2).standard_normal((4, 4)).astype(np.float32)
    np.testing.assert_array_equal(both("Trilu", [x], {"upper": 1}, tol=EXACT)[0], np.triu(x))
    np.testing.assert_array_equal(both("Trilu", [x, np.array(1)], {"upper": 0}, tol=EXACT)[0], np.tril(x, 1))
    c = both("CumSum", [x, np.array(1)])[0]
    np.testing.assert_allclose(c, np.cumsum(x, 1), rtol=1e-6)
    c = both("CumSum", [x, np.array(0)], {"exclusive": 1, "reverse": 1})[0]
    want = np.flip(np.cumsum(np.flip(x, 0), 0) - np.flip(x, 0), 0)
    np.testing.assert_allclose(c, want, rtol=1e-5, atol=1e-6)


def test_onehot_eyelike_castlike():
    idx = np.array([0, 2, -1], np.int64)
    got = both("OneHot", [idx, np.array(3), np.array([0.0, 1.0], np.float32)], tol=EXACT)[0]
    np.testing.assert_array_equal(got, [[1, 0, 0], [0, 0, 1], [0, 0, 1]])
    e = both("EyeLike", [np.zeros((3, 4), np.float32)], {"k": 1}, tol=EXACT)[0]
    np.testing.assert_array_equal(e, np.eye(3, 4, k=1, dtype=np.float32))
    c = both("CastLike", [np.array([1.7], np.float32), np.array([1], np.int32)], tol=EXACT)[0]
    assert c.dtype.kind == "i" and c[0] == 1


def test_topk():
    x = np.array([[3.0, 1.0, 4.0, 1.5], [2.0, 9.0, 0.0, 6.0]], np.float32)
    vals, idx = both("TopK", [x, np.array([2])], n_out=2, tol=EXACT)
    np.testing.assert_array_equal(vals, [[4.0, 3.0], [9.0, 6.0]])
    np.testing.assert_array_equal(idx, [[2, 0], [1, 3]])
    vals, idx = both("TopK", [x, np.array([1])], {"largest": 0}, n_out=2, tol=EXACT)
    np.testing.assert_array_equal(vals, [[1.0], [0.0]])
    np.testing.assert_array_equal(idx, [[1], [2]])


def test_gather_scatter_nd():
    data = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    indices = np.array([[0, 1], [1, 2]], np.int64)
    got = both("GatherND", [data, indices], tol=EXACT)[0]
    np.testing.assert_array_equal(got, data[[0, 1], [1, 2]])
    upd = np.array([[9.0] * 4, [8.0] * 4], np.float32)
    got = both("ScatterND", [data, indices, upd], tol=EXACT)[0]
    want = data.copy()
    want[0, 1] = 9.0
    want[1, 2] = 8.0
    np.testing.assert_array_equal(got, want)


def test_scatter_elements():
    data = np.zeros((3, 4), np.float32)
    idx = np.array([[1, 2], [0, 1]], np.int64)
    upd = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    got = both("ScatterElements", [data, idx, upd], {"axis": 1}, tol=EXACT)[0]
    want = torch.zeros(3, 4).scatter_(1, torch.from_numpy(idx), torch.from_numpy(upd)).numpy()
    np.testing.assert_array_equal(got, want)
    got = both("ScatterElements", [data, idx, upd], {"axis": 1, "reduction": "add"}, tol=EXACT)[0]
    np.testing.assert_array_equal(got, want)  # disjoint targets: the same


def test_einsum_resize():
    a = np.random.default_rng(3).standard_normal((3, 4)).astype(np.float32)
    b = np.random.default_rng(4).standard_normal((4, 5)).astype(np.float32)
    got = both("Einsum", [a, b], {"equation": "ij,jk->ik"}, runtime=(0, 1))[0]
    np.testing.assert_allclose(got, a @ b, rtol=1e-5)
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    got = both("Resize", [x, None, None, np.array([1, 1, 8, 8])])[0]
    assert got.shape == (1, 1, 8, 8)
    got = both("Resize", [x, None, np.array([1.0, 1.0, 2.0, 2.0], np.float32)], {"mode": "nearest"})[0]
    assert got.shape == (1, 1, 8, 8)
    np.testing.assert_array_equal(got[0, 0], np.repeat(np.repeat(x[0, 0], 2, 0), 2, 1))


def test_instance_group_norm_vs_torch():
    x = np.random.default_rng(5).standard_normal((2, 6, 5, 5)).astype(np.float32)
    scale = np.random.default_rng(6).standard_normal(6).astype(np.float32)
    bias = np.random.default_rng(7).standard_normal(6).astype(np.float32)
    got = both("InstanceNormalization", [x, scale, bias], {"epsilon": 1e-5})[0]
    want = F.instance_norm(torch.from_numpy(x), weight=torch.from_numpy(scale),
                           bias=torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    got = both("GroupNormalization", [x, scale, bias], {"epsilon": 1e-5, "num_groups": 3})[0]
    want = F.group_norm(torch.from_numpy(x), 3, torch.from_numpy(scale), torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_reverse_sequence():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)  # time × batch
    lens = np.array([4, 2, 1], np.int64)
    got = both("ReverseSequence", [x, lens], runtime=(0, 1), tol=EXACT)[0]
    want = x.copy()
    for b, ln in enumerate(lens):
        want[:ln, b] = x[:ln, b][::-1]
    np.testing.assert_array_equal(got, want)


def test_quantized_ops():
    x = np.array([[-1.0, 0.0, 1.5], [0.5, -0.25, 2.0]], np.float32)
    s, z = np.array(0.25, np.float32), np.array(10, np.uint8)
    q = both("QuantizeLinear", [x, s, z], tol=EXACT)[0]
    np.testing.assert_array_equal(q, np.clip(np.rint(x / 0.25) + 10, 0, 255))
    d = both("DequantizeLinear", [q.astype(np.float32), s, z], tol=EXACT)[0]
    np.testing.assert_allclose(d, (q - 10) * 0.25, rtol=1e-6)
    qd, scale, zp = both("DynamicQuantizeLinear", [x], n_out=3, tol=EXACT)
    recon = (qd - zp) * scale
    assert np.abs(recon - x).max() < float(scale) * 0.75
    a = np.array([[1, 2], [3, 4]], np.int8)
    b = np.array([[5, 6], [7, 8]], np.int8)
    got = both("MatMulInteger", [a, b, np.array(1, np.int8)], tol=EXACT)[0]
    np.testing.assert_array_equal(got, (a.astype(np.int32) - 1) @ b.astype(np.int32))


def test_compress_lpnorm_mvn():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = both("Compress", [x, np.array([True, False, True])], {"axis": 0}, tol=EXACT)[0]
    np.testing.assert_array_equal(got, x[[0, 2]])
    got = both("LpNormalization", [x + 1], {"axis": 1, "p": 1})[0]
    np.testing.assert_allclose(got, (x + 1) / np.abs(x + 1).sum(1, keepdims=True), rtol=1e-6)
    x4 = np.random.default_rng(8).standard_normal((2, 3, 4, 4)).astype(np.float32)
    got = both("MeanVarianceNormalization", [x4])[0]
    mean = x4.mean(axis=(0, 2, 3), keepdims=True)
    var = ((x4 - mean) ** 2).mean(axis=(0, 2, 3), keepdims=True)
    np.testing.assert_allclose(got, (x4 - mean) / np.sqrt(var + 1e-9), rtol=1e-4, atol=1e-5)


def test_qdq_model_end_to_end():
    """An externally quantized (QDQ) graph: DequantizeLinear of the weights
    feeding MatMul."""
    from infera_tpu.onnx.executor import compile_model_bytes as ref_compile

    rng = np.random.default_rng(0)
    w_f = rng.standard_normal((4, 3)).astype(np.float32)
    scale = np.float32(0.05)
    w_q = np.clip(np.rint(w_f / scale), -127, 127).astype(np.int8)
    g = graph([node("DequantizeLinear", ["Wq", "ws", "wz"], ["W"]), node("MatMul", ["X", "W"])],
              [("X", np.zeros((1, 4), np.float32))],
              {"Wq": w_q.astype(np.float32), "ws": np.array(scale, np.float32), "wz": np.array(0.0, np.float32)})
    data = Model(graph=g).serialize()
    x = rng.standard_normal((8, 4)).astype(np.float32)
    got = port_compile(data, "qdq", device="cpu").run(x)[0].numpy()
    assert_same(got, np.asarray(ref_compile(data, "qdq").run(x)[0]), SUMS)
    np.testing.assert_allclose(got, x @ (w_q.astype(np.float32) * scale), rtol=1e-5, atol=1e-6)


def test_qlinearmatmul_signed_output_saturation():
    b = np.array([[1], [1]], np.int8)
    s = np.float32(1.0)
    a = np.array([[-5, -3]], np.int8)
    out = both("QLinearMatMul", [a, s, np.int8(0), b, s, np.int8(0), s, np.int8(0)], tol=EXACT)[0]
    assert out[0, 0] == -8  # the signed range keeps the negative value
    out_u = both("QLinearMatMul", [a, s, np.uint8(0), b, s, np.uint8(0), s, np.uint8(0)], tol=EXACT)[0]
    assert out_u[0, 0] == 0  # the unsigned range clamps at 0
    a2 = np.array([[-100, -100]], np.int8)
    out2 = both("QLinearMatMul", [a2, s, np.int8(0), b, s, np.int8(0), s, np.int8(0)], tol=EXACT)[0]
    assert out2[0, 0] == -128


class TestTfIdfVectorizer:
    def _run(self, x, **attrs):
        return both("TfIdfVectorizer", [np.asarray(x)], attrs, tol=EXACT)[0]

    def test_tf_uni_and_bigrams(self):
        x = np.array([[2, 5, 6, 3, 5, 6], [7, 8, 2, 2, 8, 7]], np.int64)
        out = self._run(x, mode="TF", min_gram_length=1, max_gram_length=2, max_skip_count=0,
                        ngram_counts=[0, 2], ngram_indexes=[0, 1, 2, 3], pool_int64s=[2, 3, 5, 6, 7, 8])
        np.testing.assert_array_equal(out, [[1, 1, 2, 0], [2, 0, 0, 1]])

    def test_skip_grams_and_length_window(self):
        x = np.array([[5, 9, 6, 0]], np.int64)
        out = self._run(x, mode="TF", min_gram_length=2, max_gram_length=2, max_skip_count=1,
                        ngram_counts=[0, 1], ngram_indexes=[0, 1], pool_int64s=[5, 5, 6])
        np.testing.assert_array_equal(out, [[0, 1]])

    def test_idf_and_tfidf_weights(self):
        x = np.array([[2, 5, 2], [3, 3, 3]], np.int64)
        kw = dict(min_gram_length=1, max_gram_length=1, ngram_counts=[0], ngram_indexes=[0, 1],
                  pool_int64s=[2, 3], weights=[0.5, 2.0])
        np.testing.assert_allclose(self._run(x, mode="IDF", **kw), [[0.5, 0.0], [0.0, 2.0]])
        np.testing.assert_allclose(self._run(x, mode="TFIDF", **kw), [[1.0, 0.0], [0.0, 6.0]])

    def test_1d_input_and_string_rejection(self):
        out = self._run(np.array([2, 2, 3], np.int64), mode="TF", min_gram_length=1, max_gram_length=1,
                        ngram_counts=[0], ngram_indexes=[0, 1], pool_int64s=[2, 3])
        assert out.shape == (2,)
        np.testing.assert_array_equal(out, [2, 1])
        got, want = refused("TfIdfVectorizer", [np.array([2.0, 3.0], np.float32)], {"mode": "TF"})
        prefix = "ONNX error: TfIdfVectorizer: only integer token input is supported"
        assert got.startswith(prefix) and want.startswith(prefix)


# --- test_ops_longtail.py ------------------------------------------------------------


@pytest.mark.parametrize("stride,pad,out_pad,group,dilation",
                         [(1, 0, 0, 1, 1), (2, 1, 1, 1, 1), (2, 0, 0, 2, 1), (1, 1, 0, 1, 2)])
def test_conv_transpose_matches_torch(stride, pad, out_pad, group, dilation):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 9, 9)).astype(np.float32)
    w = rng.standard_normal((4, 6 // group, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = F.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride=stride,
                              padding=pad, output_padding=out_pad, groups=group, dilation=dilation).numpy()
    got = both("ConvTranspose", [x, w, b], dict(strides=[stride] * 2, pads=[pad] * 4,
                                               output_padding=[out_pad] * 2, group=group,
                                               dilations=[dilation] * 2))[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_conv_transpose_output_shape_attr():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 3, 5, 5)).astype(np.float32)
    w = rng.standard_normal((3, 4, 3, 3)).astype(np.float32)
    want = F.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w), stride=2).numpy()  # 11x11
    got = both("ConvTranspose", [x, w], {"strides": [2, 2], "output_shape": [11, 11]})[0]
    assert got.shape == (1, 4, 11, 11)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


BOXES = np.asarray([[[0.0, 0.0, 1.0, 1.0], [0.0, 0.1, 1.0, 1.1], [0.0, 10.0, 1.0, 11.0],
                     [0.0, 10.1, 1.0, 11.1]]], np.float32)
NMS_SCORES = np.asarray([[[0.9, 0.75, 0.6, 0.95]]], np.float32)


def test_non_max_suppression_static():
    got = both("NonMaxSuppression", [BOXES, NMS_SCORES, np.asarray([3], np.int64),
                                     np.asarray([0.5], np.float32), np.asarray([0.0], np.float32)],
               runtime=(), tol=EXACT)[0]
    # score-descending; box 1 suppressed by 0, box 2 by 3
    assert got.tolist() == [[0, 0, 3], [0, 0, 0]]


def test_non_max_suppression_traced_raises():
    got, want = refused("NonMaxSuppression", [BOXES, NMS_SCORES], runtime=(0, 1))
    for msg in (got, want):
        assert "statically known" in msg, msg


def test_unique_sorted_and_unsorted():
    x = np.asarray([2, 1, 1, 3, 4, 3], np.int64)
    y, idx, inv, cnt = both("Unique", [x], n_out=4, runtime=(), tol=EXACT)
    assert y.tolist() == [1, 2, 3, 4] and cnt.tolist() == [2, 1, 2, 1]
    assert (y[inv] == x).all()
    y, idx, inv, cnt = both("Unique", [x], {"sorted": 0}, n_out=4, runtime=(), tol=EXACT)
    assert y.tolist() == [2, 1, 3, 4] and cnt.tolist() == [1, 2, 2, 1]
    assert (y[inv] == x).all() and idx.tolist() == [0, 1, 3, 4]


def test_unique_axis():
    x = np.asarray([[1, 0], [1, 0], [2, 3]], np.int64)
    y, idx, inv, cnt = both("Unique", [x], {"axis": 0}, n_out=4, runtime=(), tol=EXACT)
    assert y.tolist() == [[1, 0], [2, 3]] and cnt.tolist() == [2, 1]


# --- test_rnn_ops.py --------------------------------------------------------------------

SEQ, BATCH, IN, HID = 5, 3, 4, 6


def _lstm_onnx_weights(lstm, reverse=False):
    sfx = "_reverse" if reverse else ""
    w, r, bi, bh = (getattr(lstm, f"{k}_l0{sfx}").detach().numpy()
                    for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    h = HID

    def reorder(m):  # ifgo → iofc
        return np.concatenate([m[:h], m[3 * h:], m[h:2 * h], m[2 * h:3 * h]], 0)

    return reorder(w), reorder(r), np.concatenate([reorder(bi), reorder(bh)], 0)


@pytest.mark.parametrize("direction", ["forward", "bidirectional"])
def test_lstm_vs_torch(direction):
    bidi = direction == "bidirectional"
    torch.manual_seed(0)
    lstm = torch.nn.LSTM(IN, HID, bidirectional=bidi)
    x = np.random.default_rng(0).standard_normal((SEQ, BATCH, IN)).astype(np.float32)
    h0 = np.random.default_rng(1).standard_normal((2 if bidi else 1, BATCH, HID)).astype(np.float32)
    c0 = np.random.default_rng(2).standard_normal(h0.shape).astype(np.float32)
    ws, rs, bs = zip(*[_lstm_onnx_weights(lstm, rev) for rev in ([False, True] if bidi else [False])])
    y, yh, yc = both("LSTM", [x, np.stack(ws), np.stack(rs), np.stack(bs), None, h0, c0],
                     {"hidden_size": HID, "direction": direction}, n_out=3)
    ty, (th, tc) = lstm(torch.from_numpy(x), (torch.from_numpy(h0), torch.from_numpy(c0)))
    dirs = 2 if bidi else 1
    ty = ty.detach().numpy().reshape(SEQ, BATCH, dirs, HID).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(y, ty, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(yh, th.detach().numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(yc, tc.detach().numpy(), rtol=1e-4, atol=1e-5)


def test_gru_vs_torch():
    torch.manual_seed(1)
    gru = torch.nn.GRU(IN, HID)
    x = np.random.default_rng(3).standard_normal((SEQ, BATCH, IN)).astype(np.float32)
    h = HID

    def reorder(m):  # rzn → zrh
        return np.concatenate([m[h:2 * h], m[:h], m[2 * h:]], 0)

    w, r, bi, bh = (getattr(gru, f"{k}_l0").detach().numpy()
                    for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    # torch's GRU applies the reset gate after the hidden matmul
    y, yh = both("GRU", [x, reorder(w)[None], reorder(r)[None],
                         np.concatenate([reorder(bi), reorder(bh)], 0)[None]],
                 {"hidden_size": HID, "linear_before_reset": 1}, n_out=2)
    ty, th = gru(torch.from_numpy(x))
    np.testing.assert_allclose(y[:, 0], ty.detach().numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(yh, th.detach().numpy(), rtol=1e-4, atol=1e-5)


def test_rnn_vs_torch():
    torch.manual_seed(2)
    rnn = torch.nn.RNN(IN, HID)
    x = np.random.default_rng(4).standard_normal((SEQ, BATCH, IN)).astype(np.float32)
    b = np.concatenate([rnn.bias_ih_l0.detach().numpy(), rnn.bias_hh_l0.detach().numpy()], 0)[None]
    y, yh = both("RNN", [x, rnn.weight_ih_l0.detach().numpy()[None], rnn.weight_hh_l0.detach().numpy()[None], b],
                 {"hidden_size": HID}, n_out=2)
    ty, th = rnn(torch.from_numpy(x))
    np.testing.assert_allclose(y[:, 0], ty.detach().numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(yh, th.detach().numpy(), rtol=1e-4, atol=1e-5)


def test_lstm_model_end_to_end():
    """An LSTM sequence classifier: LSTM → last hidden → Squeeze → MatMul,
    against an independent numpy recurrence."""
    from infera_tpu.onnx.executor import compile_model_bytes as ref_compile

    rng = np.random.default_rng(5)
    W = rng.standard_normal((1, 4 * HID, IN)).astype(np.float32) * 0.3
    R = rng.standard_normal((1, 4 * HID, HID)).astype(np.float32) * 0.3
    Wd = rng.standard_normal((HID, 2)).astype(np.float32)
    x = rng.standard_normal((SEQ, BATCH, IN)).astype(np.float32)
    g = graph([node("LSTM", ["X", "W", "R"], ["Y", "Yh", "Yc"], hidden_size=HID),
               node("Squeeze", ["Yh", "sq_axes"], ["H"]), node("MatMul", ["H", "Wd"], ["logits"])],
              [("X", x)], {"W": W, "R": R, "Wd": Wd, "sq_axes": np.array([0], np.int64)}, ("logits",))
    data = Model(graph=g).serialize()
    got = port_compile(data, "lstm_clf", device="cpu").run(x)[0].numpy()
    assert got.shape == (BATCH, 2)
    assert_same(got, np.asarray(ref_compile(data, "lstm_clf").run(x)[0]), SUMS)
    h = np.zeros((BATCH, HID), np.float32)
    c = np.zeros((BATCH, HID), np.float32)

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    for t in range(SEQ):
        gates = x[t] @ W[0].T + h @ R[0].T
        i, o, f = sig(gates[:, :HID]), sig(gates[:, HID:2 * HID]), sig(gates[:, 2 * HID:3 * HID])
        c = f * c + i * np.tanh(gates[:, 3 * HID:])
        h = o * np.tanh(c)
    np.testing.assert_allclose(got, h @ Wd, rtol=1e-4, atol=1e-5)


# --- test_signal_vision_ops.py -----------------------------------------------------------


def test_dft_real_forward_matches_numpy():
    x = np.random.default_rng(0).standard_normal((2, 16, 1)).astype(np.float32)
    got = both("DFT", [x])[0]
    want = np.fft.fft(x[..., 0].astype(np.float64), axis=1)
    np.testing.assert_allclose(got[..., 0], want.real, atol=1e-4)
    np.testing.assert_allclose(got[..., 1], want.imag, atol=1e-4)


def test_dft_complex_inverse_roundtrip():
    x = np.random.default_rng(1).standard_normal((3, 12, 2)).astype(np.float32)
    spec = both("DFT", [x])[0]
    np.testing.assert_allclose(both("DFT", [spec], {"inverse": 1})[0], x, atol=1e-4)


def test_dft_onesided_and_axis():
    x = np.random.default_rng(2).standard_normal((2, 5, 8, 1)).astype(np.float32)
    got = both("DFT", [x], {"axis": 2, "onesided": 1})[0]
    want = np.fft.rfft(x[..., 0].astype(np.float64), axis=2)
    assert got.shape == (2, 5, 5, 2)
    np.testing.assert_allclose(got[..., 0], want.real, atol=1e-4)
    np.testing.assert_allclose(got[..., 1], want.imag, atol=1e-4)


def test_dft_length_pad_and_truncate():
    x = np.random.default_rng(3).standard_normal((1, 10, 1)).astype(np.float32)
    got = both("DFT", [x, np.asarray(16)])[0]
    np.testing.assert_allclose(got[..., 0], np.fft.fft(x[..., 0].astype(np.float64), n=16, axis=1).real,
                               atol=1e-4)
    got = both("DFT", [x, np.asarray(8)])[0]
    np.testing.assert_allclose(got[..., 1], np.fft.fft(x[:, :8, 0].astype(np.float64), axis=1).imag,
                               atol=1e-4)


def test_stft_matches_numpy_frames():
    sig = np.random.default_rng(4).standard_normal((2, 64, 1)).astype(np.float32)
    window = np.hanning(16).astype(np.float32)
    got = both("STFT", [sig, np.asarray(8), window])[0]
    frames = (64 - 16) // 8 + 1
    assert got.shape == (2, frames, 9, 2)
    for b in range(2):
        for t in range(frames):
            want = np.fft.rfft(sig[b, t * 8: t * 8 + 16, 0].astype(np.float64) * window)
            np.testing.assert_allclose(got[b, t, :, 0], want.real, atol=1e-4)
            np.testing.assert_allclose(got[b, t, :, 1], want.imag, atol=1e-4)


def test_stft_twosided_no_window():
    sig = np.random.default_rng(5).standard_normal((1, 32, 1)).astype(np.float32)
    got = both("STFT", [sig, np.asarray(16), None, np.asarray(16)], {"onesided": 0})[0]
    assert got.shape == (1, 2, 16, 2)
    np.testing.assert_allclose(got[0, 0, :, 0], np.fft.fft(sig[0, :16, 0].astype(np.float64)).real,
                               atol=1e-4)


def test_mel_weight_matrix_shape_and_triangles():
    got = both("MelWeightMatrix", [np.asarray(8), np.asarray(16), np.asarray(8192),
                                   np.asarray(0.0, np.float32), np.asarray(4096.0, np.float32)],
               runtime=(), tol=EXACT)[0]
    assert got.shape == (9, 8) and got.dtype == np.float32
    assert (got >= 0).all() and (got <= 1).all()
    assert (np.diff(got.argmax(axis=0)) >= 0).all() and got.sum() > 0


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [0, 1])
def test_grid_sample_matches_torch(mode, padding, align):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 4, 6, 2)).astype(np.float32)
    got = both("GridSample", [x, grid], {"mode": mode, "padding_mode": padding, "align_corners": align},
               runtime=(0, 1))[0]
    want = F.grid_sample(torch.from_numpy(x), torch.from_numpy(grid),
                         mode="bilinear" if mode == "linear" else mode, padding_mode=padding,
                         align_corners=bool(align)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _roi_align_ref(x, rois, bidx, out_h, out_w, ratio, scale, mode, ctm):
    """RoiAlign from the spec, one sample at a time (test_signal_vision_ops.py's)."""
    N, C, H, W = x.shape
    out = np.zeros((rois.shape[0], C, out_h, out_w), np.float64)
    for r in range(rois.shape[0]):
        x1, y1, x2, y2 = rois[r].astype(np.float64) * scale
        if ctm == "half_pixel":
            x1, y1, x2, y2 = x1 - 0.5, y1 - 0.5, x2 - 0.5, y2 - 0.5
        rw, rh = x2 - x1, y2 - y1
        if ctm != "half_pixel":
            rw, rh = max(rw, 1.0), max(rh, 1.0)
        bw, bh = rw / out_w, rh / out_h
        b = int(bidx[r])
        for ph in range(out_h):
            for pw in range(out_w):
                n_acc = 0
                for iy in range(ratio):
                    for ix in range(ratio):
                        y = y1 + ph * bh + (iy + 0.5) * bh / ratio
                        xx = x1 + pw * bw + (ix + 0.5) * bw / ratio
                        if y < -1.0 or y > H or xx < -1.0 or xx > W:
                            continue
                        y, xx = min(max(y, 0.0), H - 1), min(max(xx, 0.0), W - 1)
                        y0, x0 = int(np.floor(y)), int(np.floor(xx))
                        y1b, x1b = min(y0 + 1, H - 1), min(x0 + 1, W - 1)
                        ly, lx = y - y0, xx - x0
                        v = (x[b, :, y0, x0] * (1 - ly) * (1 - lx) + x[b, :, y0, x1b] * (1 - ly) * lx
                             + x[b, :, y1b, x0] * ly * (1 - lx) + x[b, :, y1b, x1b] * ly * lx)
                        n_acc += 1
                        if mode == "avg":
                            out[r, :, ph, pw] += v
                        else:
                            out[r, :, ph, pw] = np.maximum(out[r, :, ph, pw], v)
                if mode == "avg" and n_acc:
                    out[r, :, ph, pw] /= n_acc
    return out


@pytest.mark.parametrize("mode", ["avg", "max"])
@pytest.mark.parametrize("ctm", ["half_pixel", "output_half_pixel"])
def test_roi_align_matches_reference(mode, ctm):
    rng = np.random.default_rng(7)
    x = rng.uniform(0.1, 1.0, (2, 3, 10, 12)).astype(np.float32)
    rois = np.array([[1.0, 1.0, 8.0, 6.0], [0.0, 0.0, 11.0, 9.0], [2.5, 3.5, 7.0, 7.0]], np.float32)
    bidx = np.array([0, 1, 0], np.int64)
    got = both("RoiAlign", [x, rois, bidx], dict(output_height=3, output_width=4, sampling_ratio=2,
                                                 spatial_scale=1.0, mode=mode,
                                                 coordinate_transformation_mode=ctm), runtime=(0, 1, 2))[0]
    np.testing.assert_allclose(got, _roi_align_ref(x, rois, bidx, 3, 4, 2, 1.0, mode, ctm), rtol=1e-4,
                               atol=1e-5)


def test_roi_align_adaptive_needs_static_rois():
    x = np.zeros((1, 1, 4, 4), np.float32)
    rois = np.array([[0.0, 0.0, 3.0, 3.0]], np.float32)
    bidx = np.array([0], np.int64)
    got = both("RoiAlign", [x, rois, bidx], {"output_height": 2, "output_width": 2}, runtime=(0, 2))[0]
    assert got.shape == (1, 1, 2, 2)
    got, want = refused("RoiAlign", [x, rois, bidx], runtime=(0, 1, 2))
    for msg in (got, want):
        assert "sampling_ratio" in msg, msg


def test_deform_conv_zero_offsets_equals_conv():
    rng = np.random.default_rng(8)
    n, c, h, wd, oc, k = 2, 4, 8, 9, 6, 3
    x = rng.standard_normal((n, c, h, wd)).astype(np.float32)
    w = rng.standard_normal((oc, c, k, k)).astype(np.float32)
    b = rng.standard_normal(oc).astype(np.float32)
    offset = np.zeros((n, 2 * k * k, h - k + 1, wd - k + 1), np.float32)
    got = both("DeformConv", [x, w, offset, b], {"kernel_shape": [k, k]}, runtime=(0, 2))[0]
    want = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _deform_conv_ref(x, w, offset, mask, stride, pad, group, og):
    """Deformable convolution from the spec, one tap at a time."""
    N, C, H, W = x.shape
    oC, _, kH, kW = w.shape
    oH, oW = offset.shape[2], offset.shape[3]
    out = np.zeros((N, oC, oH, oW), np.float64)
    cpg, cpo = C // group, C // og
    off = offset.reshape(N, og, kH, kW, 2, oH, oW)
    msk = None if mask is None else mask.reshape(N, og, kH, kW, oH, oW)
    for n in range(N):
        for o in range(oC):
            g = o // (oC // group)
            for oy in range(oH):
                for ox in range(oW):
                    acc = 0.0
                    for ci in range(cpg):
                        ch = g * cpg + ci
                        eg = ch // cpo
                        for i in range(kH):
                            for j in range(kW):
                                y = oy * stride - pad + i + off[n, eg, i, j, 0, oy, ox]
                                xx = ox * stride - pad + j + off[n, eg, i, j, 1, oy, ox]
                                y0, x0 = int(np.floor(y)), int(np.floor(xx))
                                ly, lx = y - y0, xx - x0
                                v = 0.0
                                for dy, wy in ((0, 1 - ly), (1, ly)):
                                    for dx, wx in ((0, 1 - lx), (1, lx)):
                                        if 0 <= y0 + dy < H and 0 <= x0 + dx < W:
                                            v += x[n, ch, y0 + dy, x0 + dx] * wy * wx
                                if msk is not None:
                                    v *= msk[n, eg, i, j, oy, ox]
                                acc += v * w[o, ci, i, j]
                    out[n, o, oy, ox] = acc
    return out


@pytest.mark.parametrize("group,og,with_mask", [(1, 1, False), (2, 2, True)])
def test_deform_conv_random_offsets_vs_reference(group, og, with_mask):
    rng = np.random.default_rng(9)
    n, c, h, wd, oc, k, stride, pad = 1, 4, 6, 7, 4, 3, 2, 1
    oh, ow = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    x = rng.standard_normal((n, c, h, wd)).astype(np.float32)
    w = rng.standard_normal((oc, c // group, k, k)).astype(np.float32)
    offset = rng.uniform(-1.5, 1.5, (n, og * 2 * k * k, oh, ow)).astype(np.float32)
    mask = rng.uniform(0.2, 1.0, (n, og * k * k, oh, ow)).astype(np.float32) if with_mask else None
    got = both("DeformConv", [x, w, offset, None, mask] if with_mask else [x, w, offset],
               dict(kernel_shape=[k, k], strides=[stride] * 2, pads=[pad] * 4, group=group, offset_group=og),
               runtime=(0, 2, 4))[0]
    np.testing.assert_allclose(got, _deform_conv_ref(x, w, offset, mask, stride, pad, group, og),
                               rtol=1e-4, atol=1e-4)


def _port_random(op, inputs, **attrs):
    data, feeds = _model(op, inputs, attrs, 1, {0} if inputs else set())
    return port_compile(data, "rand", device="cpu").run(*feeds.values())[0].numpy()


def test_random_normal_moments_and_determinism():
    """Properties only: the port draws from torch.Generator, not jax.random
    (ROADMAP Queue 3); the values of infera_tpu are not compared."""
    kw = dict(shape=[20000], mean=2.0, scale=0.5)
    got = _port_random("RandomNormal", [], seed=3.0, **kw)
    assert got.shape == (20000,) and got.dtype == np.float32
    assert abs(got.mean() - 2.0) < 0.02 and abs(got.std() - 0.5) < 0.02
    np.testing.assert_array_equal(got, _port_random("RandomNormal", [], seed=3.0, **kw))
    assert not np.array_equal(got, _port_random("RandomNormal", [], seed=4.0, **kw))


def test_random_uniform_range_and_like_shapes():
    got = _port_random("RandomUniform", [], shape=[5000], low=2.0, high=3.0)
    assert (got >= 2.0).all() and (got < 3.0).all()
    assert _port_random("RandomNormalLike", [np.zeros((3, 4), np.float32)]).shape == (3, 4)


def test_bernoulli_and_multinomial():
    b = _port_random("Bernoulli", [np.full((20000,), 0.3, np.float32)], seed=1.0)
    assert set(np.unique(b)) <= {0.0, 1.0} and abs(b.mean() - 0.3) < 0.02
    m = _port_random("Multinomial", [np.log(np.asarray([[0.005, 0.005, 0.99]], np.float32))],
                     sample_size=8, seed=2.0)
    assert m.shape == (1, 8) and (m == 2).mean() > 0.8


# --- test_sequence_ops.py ------------------------------------------------------------------


def _seq_run(nodes, feeds, inits=None, outputs=("Y",)):
    """The graph's outputs on both packages (numpy), infera_tpu's second."""
    from infera_tpu.onnx.executor import compile_model_bytes as ref_compile

    data = Model(graph=graph(nodes, feeds.items(), inits, outputs), opset_imports=[("", 17)]).serialize()
    got = [o.numpy() for o in port_compile(data, "seq", device="cpu").run(*feeds.values())]
    want = [np.asarray(o) for o in ref_compile(data, "seq").run(*feeds.values())]
    for g, w in zip(got, want):
        assert_same(g, w, EXACT)
    return got


def test_split_to_sequence_concat_roundtrip():
    x = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)
    (y,) = _seq_run([node("SplitToSequence", ["X"], ["seq"], axis=1),
                     node("ConcatFromSequence", ["seq"], axis=1)], {"X": x})
    np.testing.assert_array_equal(y, x)


def test_split_sizes_and_stack():
    x = np.random.default_rng(1).standard_normal((3, 6)).astype(np.float32)
    (y,) = _seq_run([node("SplitToSequence", ["X", "split"], ["seq"], axis=1),
                     node("SequenceAt", ["seq", "pos"])], {"X": x},
                    {"split": np.asarray([2, 4], np.int64), "pos": np.asarray(1, np.int64)})
    np.testing.assert_array_equal(y, x[:, 2:])


def test_construct_insert_erase_length():
    a = np.asarray([1.0, 2.0, 3.0], np.float32)
    b = np.asarray([4.0, 5.0, 6.0], np.float32)
    y, ln = _seq_run([node("SequenceConstruct", ["A", "B"], ["s0"]),
                      node("SequenceInsert", ["s0", "A", "pos0"], ["s1"]),   # [A, A, B]
                      node("SequenceErase", ["s1", "neg1"], ["s2"]),          # [A, A]
                      node("ConcatFromSequence", ["s2"], ["Y"], axis=0, new_axis=1),
                      node("SequenceLength", ["s2"], ["L"])],
                     {"A": a, "B": b}, {"pos0": np.asarray(1, np.int64), "neg1": np.asarray(-1, np.int64)},
                     outputs=("Y", "L"))
    np.testing.assert_array_equal(y, np.stack([a, a]))
    assert int(ln) == 2


def test_optional_ops():
    x = np.ones((2, 2), np.float32)
    h, y = _seq_run([node("Optional", ["X"], ["o"]), node("OptionalHasElement", ["o"], ["H"]),
                     node("OptionalGetElement", ["o"], ["Y"])], {"X": x}, outputs=("H", "Y"))
    assert bool(h) is True
    np.testing.assert_array_equal(y, x)


def _seq_refused(nodes, feeds, inits=None):
    from infera_tpu.errors import OnnxError as RefOnnxError
    from infera_tpu.onnx.executor import compile_model_bytes as ref_compile

    data = Model(graph=graph(nodes, feeds.items(), inits), opset_imports=[("", 17)]).serialize()
    with pytest.raises(RefOnnxError) as want:
        ref_compile(data, "seq").run(*feeds.values())
    with pytest.raises(OnnxError) as got:
        port_compile(data, "seq", device="cpu").run(*feeds.values())
    return str(got.value), str(want.value)


def test_dynamic_position_raises():
    """A position computed from tensor values: a clear refusal on both, not
    a wrong answer."""
    got, want = _seq_refused([node("SplitToSequence", ["X"], ["seq"], axis=0),
                              node("SequenceAt", ["seq", "P"])],
                             {"X": np.ones((4, 2), np.float32), "P": np.asarray(1, np.int64)})
    for msg in (got, want):
        assert "static" in msg, msg


def test_sequence_output_rejected():
    got, want = _seq_refused([node("SplitToSequence", ["X"], axis=0)], {"X": np.ones((4, 2), np.float32)})
    assert got == want and "sequence" in got


def test_resize_r16_is_jax_image_resize_not_onnx_half_pixel():
    """R16 (ROADMAP Queue 3): Resize follows infera_tpu's jax.image.resize,
    which antialiases a linear downsample and runs Keys cubic with a = -0.5;
    ONNX's half_pixel sampling (torch's interpolate) answers otherwise."""
    x = (np.arange(8, dtype=np.float32) ** 2).reshape(1, 1, 1, 8)
    got = both("Resize", [x, None, None, np.asarray([1, 1, 1, 4])], {"mode": "linear"})[0]
    np.testing.assert_array_equal(got.ravel(), [1.0, 7.0, 21.0, 40.0])
    onnx = F.interpolate(torch.from_numpy(x[0]), size=4, mode="linear", align_corners=False)
    np.testing.assert_array_equal(onnx.numpy().ravel(), [0.5, 6.5, 20.5, 42.5])
    imp = np.asarray([0, 0, 1, 0], np.float32).reshape(1, 1, 1, 4)
    got = both("Resize", [imp, None, None, np.asarray([1, 1, 1, 8])], {"mode": "cubic"})[0]
    assert abs(got.ravel()[4] - 0.8671875) < 1e-6
    onnx = F.interpolate(torch.from_numpy(imp), size=(1, 8), mode="bicubic", align_corners=False)
    assert abs(onnx.numpy().ravel()[4] - 0.87890625) < 1e-6
