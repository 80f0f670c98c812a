"""The ai.onnx.ml operators of the port against ``infera_tpu``'s, on the CPU.

Every case of ``tests/test_tree_ensemble.py`` runs through both packages on
the same model bytes and the same inputs (numpy, from a seed), beside the
host tree walk of that file; then the rest of ``onnx/ml_ops.py``'s operators,
each post transform, config 4's forests and rows with non-finite features.
Tolerances: 1e-5 against ``infera_tpu`` (the repo's f32 parity bar: the leaf
sums are added in another order), 1e-6 between the GEMM forest and the
gather traversal, labels exact."""

import numpy as np
import pytest
import torch

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu.errors import OnnxError as RefOnnxError
from infera_tpu.onnx import ml_ops as ref_ml_ops
from infera_tpu.onnx.executor import compile_model_bytes as ref_compile
from infera_tpu_torch.errors import OnnxError
from infera_tpu_torch.onnx import builder, ml_ops, proto
from infera_tpu_torch.onnx.executor import compile_model_bytes
from infera_tpu_torch.onnx.proto import Attribute, DataType, Graph, Model, Node, ValueInfo
from infera_tpu_torch.registry import MODELS as PORT_MODELS

CPU = torch.device("cpu")


def _port(data: bytes, name="p"):
    return compile_model_bytes(data, name, device=CPU)


def _run_both(data: bytes, x: np.ndarray) -> tuple:
    """(infera_tpu's outputs, the port's outputs) as numpy, each model
    compiled fresh so that INFERA_TREE_MODE is read anew."""
    ref = [np.asarray(o) for o in ref_compile(data, "r").run(x)]
    port = [o.numpy() for o in _port(data).run(x)]
    return ref, port


def _host_gbt_predict(model: proto.Model, x: np.ndarray) -> np.ndarray:
    """Reference implementation: per-row, per-tree pointer chase (as in
    tests/test_tree_ensemble.py)."""
    node = model.graph.nodes[0]
    a = {k: v.value for k, v in node.attributes.items()}
    tree_ids = np.asarray(a["nodes_treeids"])
    feats = np.asarray(a["nodes_featureids"])
    modes = a["nodes_modes"]
    values = np.asarray(a["nodes_values"], np.float32)
    t_child = np.asarray(a["nodes_truenodeids"])
    f_child = np.asarray(a["nodes_falsenodeids"])
    tbl = {(tree_ids[k], a["nodes_nodeids"][k]): k for k in range(len(tree_ids))}
    leaf_w = {}
    for t, nd, w in zip(a["target_treeids"], a["target_nodeids"], a["target_weights"]):
        leaf_w[(t, nd)] = leaf_w.get((t, nd), 0.0) + w
    base = a.get("base_values", [0.0])[0]
    out = np.zeros(len(x), np.float32)
    for i, row in enumerate(x):
        acc = base
        for t in np.unique(tree_ids):
            nd = 0
            while True:
                k = tbl[(t, nd)]
                if modes[k] == "LEAF":
                    acc += leaf_w.get((t, nd), 0.0)
                    break
                nd = t_child[k] if row[feats[k]] <= values[k] else f_child[k]
        out[i] = acc
    return out


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# --------------------------------------------------------------------------- tree ensembles


def test_gbt_regressor_matches_host_walk_and_reference():
    model = builder.gbt_regressor_model(n_features=8, n_trees=5, depth=4, seed=3)
    x = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    (ref,), (port,) = _run_both(model.serialize(), x)
    _close(port.reshape(-1), _host_gbt_predict(model, x))
    _close(port, ref)


@pytest.fixture()
def registries(clean_registry):
    itt.set_device("cpu")
    PORT_MODELS.clear()
    yield
    PORT_MODELS.clear()
    itt.set_device(None)


def test_gbt_through_predict_api(tmp_path, registries):
    model = builder.gbt_regressor_model(n_features=4, n_trees=3, depth=3, seed=1)
    p = tmp_path / "gbt.onnx"
    proto.save_model_file(model, p)
    it.load_model("gbt", str(p))
    itt.load_model("gbt", str(p))
    assert itt.get_model_info("gbt") == it.get_model_info("gbt")
    assert '"input_shape":[-1,4]' in itt.get_model_info("gbt")
    x = np.random.default_rng(2).standard_normal((10, 4)).astype(np.float32)
    res, ref = itt.predict("gbt", x), it.predict("gbt", x)
    assert (res.rows, res.cols) == (ref.rows, ref.cols) == (10, 1)
    _close(res.data, _host_gbt_predict(model, x))
    _close(res.data, ref.data)


def _hand_classifier() -> Model:
    """Hand-built 1-tree classifier over 2 classes (tests/test_tree_ensemble.py):
    x0 <= 0 → class 0 weight 1; else class 1 weight 1."""
    attrs = {
        "classlabels_int64s": Attribute.make("classlabels_int64s", [10, 20]),
        "nodes_treeids": Attribute.make("nodes_treeids", [0, 0, 0]),
        "nodes_nodeids": Attribute.make("nodes_nodeids", [0, 1, 2]),
        "nodes_featureids": Attribute.make("nodes_featureids", [0, 0, 0]),
        "nodes_modes": Attribute.make("nodes_modes", ["BRANCH_LEQ", "LEAF", "LEAF"]),
        "nodes_values": Attribute.make("nodes_values", [0.0, 0.0, 0.0]),
        "nodes_truenodeids": Attribute.make("nodes_truenodeids", [1, 0, 0]),
        "nodes_falsenodeids": Attribute.make("nodes_falsenodeids", [2, 0, 0]),
        "class_treeids": Attribute.make("class_treeids", [0, 0]),
        "class_nodeids": Attribute.make("class_nodeids", [1, 2]),
        "class_ids": Attribute.make("class_ids", [0, 1]),
        "class_weights": Attribute.make("class_weights", [1.0, 1.0]),
        "post_transform": Attribute.make("post_transform", "NONE"),
    }
    g = Graph(
        name="clf",
        nodes=[Node(op_type="TreeEnsembleClassifier", domain="ai.onnx.ml",
                    inputs=["X"], outputs=["label", "scores"], attributes=attrs)],
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT, shape=[-1, 1])],
        outputs=[ValueInfo(name="label", elem_type=DataType.INT64, shape=[-1]),
                 ValueInfo(name="scores", elem_type=DataType.FLOAT, shape=[-1, 2])],
    )
    return Model(graph=g, opset_imports=[("", 13), ("ai.onnx.ml", 3)])


def test_tree_classifier():
    x = np.array([[-1.0], [1.0], [0.0]], np.float32)
    (ref_label, ref_scores), (label, scores) = _run_both(_hand_classifier().serialize(), x)
    assert label.dtype == np.int64
    np.testing.assert_array_equal(label, [10, 20, 10])
    np.testing.assert_array_equal(label, ref_label)
    np.testing.assert_array_equal(scores, [[1, 0], [0, 1], [1, 0]])
    np.testing.assert_array_equal(scores, ref_scores)


def _single_node_model(op_type, attrs, in_dim, out_dims, extra_inits=None) -> Model:
    """One ai.onnx.ml node over X [-1, in_dim]; outputs named Y0, Y1, ..."""
    outs = [f"Y{i}" for i in range(len(out_dims))]
    inputs = ["X"] + list(extra_inits or {})
    inits = {k: proto.Tensor.from_array(k, v) for k, v in (extra_inits or {}).items()}
    g = Graph(
        name=op_type,
        nodes=[Node(op_type=op_type, domain="ai.onnx.ml", inputs=inputs, outputs=outs,
                    attributes={k: Attribute.make(k, v) for k, v in attrs.items()})],
        initializers=inits,
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT, shape=[-1, in_dim])],
        outputs=[ValueInfo(name=o, elem_type=t, shape=s) for o, (t, s) in zip(outs, out_dims)],
    )
    return Model(graph=g, opset_imports=[("", 13), ("ai.onnx.ml", 3)])


def test_linear_regressor_ml():
    model = _single_node_model(
        "LinearRegressor", {"coefficients": [2.0, -1.0, 0.5], "intercepts": [0.25],
                            "targets": 1}, 3, [(DataType.FLOAT, [-1, 1])])
    out = _port(model.serialize()).run(np.array([[1.0, 2.0, 3.0]], np.float32))[0].numpy()
    assert abs(float(out.reshape(-1)[0]) - 1.75) < 1e-6
    x = np.random.default_rng(3).standard_normal((50, 3)).astype(np.float32)
    (ref,), (port,) = _run_both(model.serialize(), x)
    _close(port, ref)


def _fresh(model: Model, name: str):
    """Fresh compile (fresh Node objects) of the port's model."""
    return _port(model.serialize(), name)


def test_gemm_matches_gather_complete_trees(monkeypatch):
    """The matmul-only forest agrees with the gather traversal on complete
    heap-layout trees to float tolerance, with the host walk, and with
    infera_tpu's GEMM forest."""
    model = builder.gbt_regressor_model(n_features=8, n_trees=7, depth=5, seed=11)
    x = np.random.default_rng(4).standard_normal((257, 8)).astype(np.float32)
    monkeypatch.setenv("INFERA_TREE_MODE", "gather")
    got_gather = _fresh(model, "ga").run(x)[0].numpy()
    monkeypatch.setenv("INFERA_TREE_MODE", "gemm")
    got_gemm = _fresh(model, "ge").run(x)[0].numpy()
    np.testing.assert_allclose(got_gemm, got_gather, rtol=1e-6, atol=1e-6)
    _close(got_gemm.reshape(-1), _host_gbt_predict(model, x))
    _close(got_gemm, np.asarray(ref_compile(model.serialize(), "r").run(x)[0]))


def test_gemm_large_batch_tiling(monkeypatch):
    """N far above the GEMM row tile takes the tiled loop and its ragged
    last tile."""
    model = builder.gbt_regressor_model(n_features=4, n_trees=3, depth=3, seed=5)
    x = np.random.default_rng(6).standard_normal((10000, 4)).astype(np.float32)
    monkeypatch.setenv("INFERA_TREE_MODE", "gemm")
    monkeypatch.setattr(ml_ops._PackedTrees, "_GEMM_TILE", 1024)
    monkeypatch.setattr(ref_ml_ops._PackedTrees, "_GEMM_TILE", 1024)
    (ref,), (port,) = _run_both(model.serialize(), x)
    _close(port.reshape(-1), _host_gbt_predict(model, x))
    _close(port, ref)


def _irregular_model() -> Model:
    """tree 0: a single leaf (0.7); tree 1: shuffled node ids, mixed modes:
    node 0: f0 BRANCH_GT 0.5 -> true: node 3, false: node 1 (leaf, w=1);
    node 3: f1 BRANCH_LT -0.2 -> true: node 2 (leaf, w=2), false: node 4 (w=3)."""
    attrs = {
        "n_targets": 1,
        "nodes_treeids": [0, 1, 1, 1, 1, 1],
        "nodes_nodeids": [0, 0, 1, 3, 2, 4],
        "nodes_featureids": [0, 0, 0, 1, 0, 0],
        "nodes_modes": ["LEAF", "BRANCH_GT", "LEAF", "BRANCH_LT", "LEAF", "LEAF"],
        "nodes_values": [0.0, 0.5, 0.0, -0.2, 0.0, 0.0],
        "nodes_truenodeids": [0, 3, 0, 2, 0, 0],
        "nodes_falsenodeids": [0, 1, 0, 4, 0, 0],
        "target_treeids": [0, 1, 1, 1],
        "target_nodeids": [0, 1, 2, 4],
        "target_ids": [0, 0, 0, 0],
        "target_weights": [0.7, 1.0, 2.0, 3.0],
        "post_transform": "NONE",
    }
    return _single_node_model("TreeEnsembleRegressor", attrs, 2, [(DataType.FLOAT, [-1, 1])])


def test_gemm_irregular_trees(monkeypatch):
    """Non-complete trees, non-heap node ids, mixed branch modes and a
    single-leaf tree: GEMM and gather agree exactly, in both packages."""
    model = _irregular_model()
    x = np.array([[0.6, -0.5], [0.6, 0.0], [0.4, 9.0], [0.5, -9.0]], np.float32)
    want = np.array([2.7, 3.7, 1.7, 1.7], np.float32)
    got = {}
    for mode in ("gemm", "gather"):
        monkeypatch.setenv("INFERA_TREE_MODE", mode)
        (ref,), (port,) = _run_both(model.serialize(), x)
        np.testing.assert_array_equal(port, ref)
        got[mode] = port.reshape(-1)
    np.testing.assert_allclose(got["gemm"], want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got["gemm"], got["gather"])


def test_gemm_oversize_falls_back(monkeypatch):
    """Forests whose path tables exceed the limit take the gather path under
    auto and raise under forced gemm, with infera_tpu's message."""
    monkeypatch.setattr(ml_ops._PackedTrees, "_GEMM_C_LIMIT", 16)
    monkeypatch.setattr(ref_ml_ops._PackedTrees, "_GEMM_C_LIMIT", 16)
    model = builder.gbt_regressor_model(n_features=4, n_trees=2, depth=3, seed=9)
    x = np.random.default_rng(1).standard_normal((8, 4)).astype(np.float32)
    monkeypatch.setenv("INFERA_TREE_MODE", "auto")
    (ref,), (port,) = _run_both(model.serialize(), x)
    _close(port.reshape(-1), _host_gbt_predict(model, x))
    _close(port, ref)

    monkeypatch.setenv("INFERA_TREE_MODE", "gemm")
    with pytest.raises(OnnxError) as port_err:
        _fresh(model, "fb_force").run(x)
    with pytest.raises(RefOnnxError) as ref_err:
        ref_compile(model.serialize(), "fb_ref").run(x)
    assert str(port_err.value) == str(ref_err.value)
    assert str(port_err.value) == ("ONNX error: INFERA_TREE_MODE=gemm but the ensemble "
                                   "exceeds the GEMM path-table limit")


# --------------------------------------------------------------------------- config 4


@pytest.mark.parametrize("mode", ["auto", "gather"])
def test_config4_regressor_and_classifier(monkeypatch, mode):
    """BASELINE config 4's forest (64 trees of depth 6 over 16 features) and
    a 3-class classifier of the same shape, on 2,048 rows."""
    monkeypatch.setenv("INFERA_TREE_MODE", mode)
    x = np.random.default_rng(0).standard_normal((2048, 16)).astype(np.float32)
    reg = builder.gbt_regressor_model(n_features=16, n_trees=64, depth=6, seed=0)
    (ref,), (port,) = _run_both(reg.serialize(), x)
    _close(port, ref)
    clf = builder.gbt_classifier_model(n_features=16, n_trees=64, depth=6, n_classes=3,
                                       labels=[7, 19, 42], seed=3)
    (ref_label, ref_scores), (label, scores) = _run_both(clf.serialize(), x)
    np.testing.assert_array_equal(label, ref_label)
    _close(scores, ref_scores)


# --------------------------------------------------------------------------- the other ml ops


def test_linear_classifier():
    x = np.random.default_rng(5).standard_normal((40, 3)).astype(np.float32)
    for post in ("NONE", "SOFTMAX", "LOGISTIC"):
        model = _single_node_model(
            "LinearClassifier",
            {"coefficients": [0.5, -1.0, 2.0, 1.5, 0.25, -0.75, -2.0, 1.0, 0.5],
             "intercepts": [0.1, -0.2, 0.3], "classlabels_ints": [3, 1, 4],
             "post_transform": post},
            3, [(DataType.INT64, [-1]), (DataType.FLOAT, [-1, 3])])
        (ref_label, ref_scores), (label, scores) = _run_both(model.serialize(), x)
        np.testing.assert_array_equal(label, ref_label)
        assert set(label.tolist()) <= {3, 1, 4}
        _close(scores, ref_scores)


def test_scaler():
    model = _single_node_model("Scaler", {"offset": [1.0, -2.0, 0.5], "scale": [2.0, 0.5, -1.0]},
                               3, [(DataType.FLOAT, [-1, 3])])
    x = np.random.default_rng(6).standard_normal((30, 3)).astype(np.float32)
    (ref,), (port,) = _run_both(model.serialize(), x)
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("norm", ["MAX", "L1", "L2"])
def test_normalizer(norm):
    model = _single_node_model("Normalizer", {"norm": norm}, 4, [(DataType.FLOAT, [-1, 4])])
    x = np.random.default_rng(7).standard_normal((30, 4)).astype(np.float32)
    x[3] = 0.0  # a zero row divides by 1
    (ref,), (port,) = _run_both(model.serialize(), x)
    _close(port, ref)
    np.testing.assert_array_equal(port[3], 0.0)


def test_zipmap_passes_the_scores_through():
    model = _single_node_model("ZipMap", {"classlabels_int64s": [0, 1, 2]}, 3,
                               [(DataType.FLOAT, [-1, 3])])
    x = np.random.default_rng(8).standard_normal((5, 3)).astype(np.float32)
    (ref,), (port,) = _run_both(model.serialize(), x)
    np.testing.assert_array_equal(port, x)
    np.testing.assert_array_equal(port, ref)


def test_array_feature_extractor():
    model = _single_node_model("ArrayFeatureExtractor", {}, 5, [(DataType.FLOAT, [-1, 3])],
                               extra_inits={"I": np.array([4, 0, 2], np.int64)})
    x = np.random.default_rng(9).standard_normal((6, 5)).astype(np.float32)
    (ref,), (port,) = _run_both(model.serialize(), x)
    np.testing.assert_array_equal(port, x[:, [4, 0, 2]])
    np.testing.assert_array_equal(port, ref)


def _multi_target_regressor(post: str, agg: str = "SUM") -> Model:
    """The builder's forest with its leaves spread over 3 targets."""
    model = builder.gbt_regressor_model(n_features=5, n_trees=6, depth=3, seed=4)
    node = model.graph.nodes[0]
    ids = node.attr("target_ids")
    node.attributes["target_ids"] = Attribute.make("target_ids",
                                                   [k % 3 for k in range(len(ids))])
    for k, v in (("n_targets", 3), ("post_transform", post), ("aggregate_function", agg),
                 ("base_values", [0.5, -0.25, 0.125])):
        node.attributes[k] = Attribute.make(k, v)
    model.graph.outputs[0].shape = [-1, 3]
    return model


@pytest.mark.parametrize("post", ["NONE", "SOFTMAX", "LOGISTIC", "SOFTMAX_ZERO", "PROBIT"])
def test_post_transforms(post):
    """Each post transform on a 3-target regressor (PROBIT of values outside
    [0, 1] is NaN on both sides) and on the config-4-shaped classifier,
    whose labels stay exact."""
    x = np.random.default_rng(10).standard_normal((200, 5)).astype(np.float32)
    (ref,), (port,) = _run_both(_multi_target_regressor(post).serialize(), x)
    assert port.shape == (200, 3)
    _close(port, ref)
    if post == "PROBIT":
        assert np.isnan(port).any() and np.isfinite(port).any()
    clf = builder.gbt_classifier_model(n_features=5, n_trees=8, depth=3, n_classes=3, seed=2)
    clf.graph.nodes[0].attributes["post_transform"] = Attribute.make("post_transform", post)
    (ref_label, ref_scores), (label, scores) = _run_both(clf.serialize(), x)
    np.testing.assert_array_equal(label, ref_label)
    _close(scores, ref_scores)


def test_average_aggregate_with_base_values():
    x = np.random.default_rng(11).standard_normal((100, 5)).astype(np.float32)
    (ref,), (port,) = _run_both(_multi_target_regressor("NONE", "AVERAGE").serialize(), x)
    _close(port, ref)


# --------------------------------------------------------------------------- non-finite features


@pytest.mark.parametrize("mode", ["auto", "gemm", "gather"])
def test_rows_with_non_finite_features(monkeypatch, mode):
    """A NaN, +inf or -inf feature: infera_tpu's GEMM forest (auto and gemm)
    multiplies every feature by 0 or 1, so the row sees NaN at every node
    that tests another feature; its gather traversal compares the value
    itself. The port gives the same rows under each mode."""
    monkeypatch.setenv("INFERA_TREE_MODE", mode)
    x = np.random.default_rng(12).standard_normal((12, 4)).astype(np.float32)
    x[1, 0] = np.nan
    x[2, 1] = np.inf
    x[3, 2] = -np.inf
    x[4, 0], x[4, 3] = np.inf, -np.inf
    x[5, :] = np.nan
    x[6, 3] = -np.inf
    reg = builder.gbt_regressor_model(n_features=4, n_trees=5, depth=3, seed=1)
    (ref,), (port,) = _run_both(reg.serialize(), x)
    _close(port, ref)
    clf = builder.gbt_classifier_model(n_features=4, n_trees=5, depth=3, n_classes=3,
                                       labels=[7, 19, 42], seed=3)
    (ref_label, _), (label, _) = _run_both(clf.serialize(), x)
    np.testing.assert_array_equal(label, ref_label)
    finite = _host_gbt_predict(reg, x[[0, 7, 8]])
    _close(port.reshape(-1)[[0, 7, 8]], finite)


def test_kernel_forest_refuses_what_the_strip_packing_refuses():
    """K4's tables exist exactly where infera_tpu's in-kernel strip tables
    do: a BRANCH_GT forest, a tree over 128 leaves and a feature past the
    inputs are refused by both."""
    def both(model, n_out, key, d_in):
        node = model.graph.nodes[0]
        ref_node = proto.load_model_bytes(model.serialize()).graph.nodes[0]
        port = ml_ops._PackedTrees(node, n_out, key).kernel_forest(d_in)
        ref = ref_ml_ops._PackedTrees(ref_node, n_out, key).pallas_forest(d_in)
        assert (port is None) == (ref is None)
        return port

    gbt = builder.gbt_regressor_model(n_features=4, n_trees=3, depth=3, seed=1)
    tables = both(gbt, 1, "target", 4)
    assert tables["node"].shape == (3, 15, 4) and tables["max_depth"] == 3
    assert not tables["strict"]
    both(gbt, 1, "target", 3)   # a feature index may reach 3
    assert both(builder.gbt_regressor_model(n_features=4, n_trees=2, depth=8), 1,
                "target", 4) is None
    assert both(_multi_target_regressor("NONE"), 3, "target", 5) is not None
    gt = _irregular_model()
    assert both(gt, 1, "target", 2) is None
