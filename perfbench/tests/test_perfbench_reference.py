"""The reference's MLP, forest walk, grouping and comparison against answers
worked out by hand on a few rows; the ONNX files it writes against the
program on the CPU."""

import math

import numpy as np
import pytest
import torch

from perfbench import harness, reference
from perfbench.models import mlp, tree_ensemble

CFG = {"table": {"name": "t", "rows": 6, "key": {"name": "g", "first": 0, "counts": [3, 1, 2]},
                 "columns": [{"names": ["c0", "c1"], "draw": "standard_normal"}]},
       "models": [{"name": "m", "kind": "tree_ensemble", "features": 2, "trees": 1,
                   "depth": 1, "base_value": 0.5}]}


def test_mlp_by_hand():
    spec = {"features": 2, "hidden": [2], "outputs": 2, "softmax": True}
    params = {"layers": [(np.array([[1.0, -1.0], [2.0, 0.0]], np.float32),
                          np.array([0.0, 1.0], np.float32)),
                         (np.array([[1.0, 0.0], [0.0, 1.0]], np.float32),
                          np.array([0.0, 0.0], np.float32))]}
    x = torch.tensor([[1.0, 1.0], [-1.0, 0.0]])
    # row 0: h = relu([3, 0]) -> logits [3, 0]; row 1: h = relu([-1, 2]) -> [0, 2]
    v, err = mlp.reference(spec, params, x, 1)
    want = [math.exp(3) / (math.exp(3) + 1), 1 / (1 + math.exp(2))]
    assert v.tolist() == pytest.approx(want, rel=1e-12)
    assert err is None
    v2, _ = mlp.reference(spec, params, x, 2)
    assert (v + v2).tolist() == pytest.approx([1.0, 1.0])


def _two_level_tree():
    # root: c1 <= 0.5 ? node 1 : node 2; node 1: c0 <= -1 ? leaf 0 : leaf 1;
    # node 2: c0 <= 2 ? leaf 2 : leaf 3
    return {"feature": np.array([[1, 0, 0]]), "threshold": np.array([[0.5, -1.0, 2.0]],
                                                                      np.float32),
            "leaf": np.array([[10.0, 20.0, 30.0, 40.0]], np.float32)}


def test_forest_walk_by_hand():
    params = _two_level_tree()
    x = torch.tensor([[-2.0, 0.0], [0.0, 0.5], [1.0, 3.0], [2.5, 0.6]])
    assert tree_ensemble.walk(params, x).tolist() == [[0], [1], [2], [3]]
    spec = {"trees": 1, "depth": 2, "features": 2, "base_value": 0.5}
    v, err = tree_ensemble.reference(spec, params, x, None)
    assert v.tolist() == [10.5, 20.5, 30.5, 40.5]
    assert bool((err > 0).all())


def test_logistic_gives_the_probability_and_its_bound():
    params = {"feature": np.array([[0]]), "threshold": np.array([[0.0]], np.float32),
              "leaf": np.array([[-1.0, 2.0]], np.float32)}
    spec = {"trees": 1, "depth": 1, "features": 1, "base_value": 0.5, "logistic": True}
    v, err = tree_ensemble.reference(spec, params, torch.tensor([[-1.0], [1.0]]), None)
    assert v.tolist() == pytest.approx([1 / (1 + math.exp(0.5)), 1 / (1 + math.exp(-2.5))],
                                       rel=1e-12)
    _, err_z = tree_ensemble.reference({**spec, "logistic": False}, params,
                                       torch.tensor([[-1.0], [1.0]]), None)
    assert torch.allclose(err, 0.25 * err_z + 8 * 2.0 ** -24)


def test_inputs_hold_the_published_key_counts_and_one_hot_columns():
    cfg = {"table": {"rows": 10, "key": {"name": "k", "first": 1, "counts": [6, 3, 1]},
                     "columns": [{"names": ["a", "b"], "draw": "standard_normal"},
                                 {"prefix": "h", "count": 3, "draw": "one_hot"}]},
           "models": []}
    assert reference.feature_names(cfg) == ["a", "b", "h1", "h2", "h3"]
    feats, keys, _ = harness.make_inputs(cfg, 2**31 + 3, torch.device("cpu"))
    assert feats.shape == (5, 10) and sorted(keys.tolist()) == [1] * 6 + [2] * 3 + [3]
    assert (feats[2:].sum(0) == 1).all() and set(np.unique(feats[2:])) <= {0.0, 1.0}
    # cut to 7 rows: 4.2, 2.1, 0.7 by largest remainder
    assert reference.key_counts({"table": {**cfg["table"], "rows": 7}}) == [4, 2, 1]


def test_grouping_by_hand():
    feats = np.array([[1.0, 2.0, 3.0, 4.0, 5.0, 6.0], [0.0] * 6], np.float32)
    keys = np.array([0, 1, 0, 2, 2, 0])
    params = {"m": {"feature": np.array([[0]]), "threshold": np.array([[3.5]], np.float32),
                    "leaf": np.array([[1.0, 2.0]], np.float32)}}
    t = {"prediction": {"model": "m"}, "where": {"column": "c0", "op": ">", "values": [1.5]},
         "aggregates": [["count", "*"], ["sum", "c0"], ["avg", "prediction"],
                        ["min", "c0"], ["max", "prediction"]]}
    outs = reference.model_outputs(CFG, params, feats, {("m", None)}, "cpu")
    exp = reference.expected(CFG, t, 1.5, feats, keys, outs, "cpu")
    # kept rows 1..5: group 0 = rows 2, 5 (c0 3, 6; predictions 1.5, 2.5);
    # group 1 = row 1 (2; 1.5); group 2 = rows 3, 4 (4, 5; 2.5, 2.5)
    assert exp.keys.tolist() == [0, 1, 2] and exp.required.all()
    assert exp.lo.tolist() == exp.hi.tolist() == [[2, 9, 2.0, 3, 2.5], [1, 2, 1.5, 2, 1.5],
                                                  [2, 9, 2.5, 4, 2.5]]
    assert exp.kept_rows == 5
    rows = [(0, 2, 9.0, 2.0, 3.0, 2.5), (1, 1, 2.0, 1.5, 2.0, 1.5), (2, 2, 9.0, 2.5, 4.0, 2.5)]
    assert reference.judge(exp, rows) == (False, 0.0, 0.0)
    off = [rows[0], (1, 2, 2.0, 1.5, 2.0, 1.5), (2, 2, 9.0, 2.5, 4.0, 2.5 * 1.01)]
    wrong, count_gap, agg_gap = reference.judge(exp, off)
    assert not wrong and count_gap == 1 and agg_gap == pytest.approx(0.01)
    assert reference.judge(exp, rows[:2])[0]               # a required group missing
    assert reference.judge(exp, rows[::-1])[0]             # not in key order


def test_a_row_at_the_threshold_may_go_either_way():
    feats = np.array([[-1.0, 1.0, -1.0], [0.0] * 3], np.float32)
    keys = np.array([0, 0, 1])
    params = {"m": {"feature": np.array([[0]]), "threshold": np.array([[0.0]], np.float32),
                    "leaf": np.array([[0.0, 1.0]], np.float32)}}
    t = {"prediction": {"model": "m"}, "where": {"column": "prediction", "op": ">",
                                                 "values": [0.5]},
         "aggregates": [["count", "*"], ["avg", "prediction"]]}
    outs = reference.model_outputs(CFG, params, feats, {("m", None)}, "cpu")
    # predictions 0.5, 1.5, 0.5: rows 0 and 2 sit on the threshold
    exp = reference.expected(CFG, t, 0.5, feats, keys, outs, "cpu")
    assert exp.keys.tolist() == [0, 1] and exp.required.tolist() == [True, False]
    assert exp.lo[0].tolist() == [1, 1.0] and exp.hi[0].tolist() == [2, 1.5]
    assert reference.judge(exp, [(0, 2, 1.0)]) == (False, 0.0, 0.0)
    assert reference.judge(exp, [(0, 1, 1.5), (1, 1, 0.5)]) == (False, 0.0, 0.0)


@pytest.mark.parametrize("config", ["mlp_classifier_f32", "gbt_models_f32"])
def test_written_models_score_as_the_reference_on_the_program(config, cpu_program):
    import infera_tpu_torch as itt

    cfg = harness.load("configs", config)
    cfg["table"]["rows"] = 512
    feats, _, params = harness.make_inputs(cfg, 2**31 + 7, torch.device("cpu"))
    for spec in cfg["models"]:
        kind = reference.model_kind(spec["kind"])
        path = cpu_program / f"{spec['name']}.onnx"
        path.write_bytes(kind.onnx_bytes(spec, params[spec["name"]]))
        itt.load_model(spec["name"], str(path))
        x = np.ascontiguousarray(feats[:spec["features"]].T)
        got = np.asarray(itt.predict(spec["name"], x).data, np.float64)
        v, err = kind.reference(spec, params[spec["name"]], torch.as_tensor(x), None)
        if err is not None:
            assert (np.abs(got.reshape(-1) - v.numpy()) <= err.numpy() + 1e-6).all()
        else:
            want = torch.softmax(_logits(params[spec["name"]], x), 1).numpy()
            np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-5, atol=1e-6)
        itt.unload_model(spec["name"])


def _logits(params, x):
    h = torch.as_tensor(x).double()
    for i, (w, b) in enumerate(params["layers"]):
        h = h @ torch.as_tensor(w).double() + torch.as_tensor(b).double()
        h = torch.relu(h) if i < len(params["layers"]) - 1 else h
    return h
