"""A gradient-boosted tree ensemble (ai.onnx.ml TreeEnsembleRegressor, with
post_transform LOGISTIC where the spec sets ``logistic``: a binary
classifier's probability, as XGBoost's ``predict_proba[:, 1]``): complete
binary trees in heap order, every split BRANCH_LEQ. Trees from the run's
generator; the ONNX file the program loads; the plain reference walk; the
work one row needs."""

from __future__ import annotations

import torch

from .. import onnx_writer as ow

_U = 2.0 ** -24          # unit roundoff of f32


def make(spec: dict, gen: torch.Generator, device) -> dict:
    """Split features uniform over the spec's features, thresholds N(0, 1),
    leaf weights N(0, 0.01), as f32 arrays: feature and threshold
    [trees, 2**depth - 1] by heap index, leaf [trees, 2**depth]."""
    t, d = spec["trees"], spec["depth"]
    feat = torch.randint(0, spec["features"], (t, (1 << d) - 1), generator=gen, device=device)
    thr = torch.randn((t, (1 << d) - 1), generator=gen, device=device)
    leaf = torch.randn((t, 1 << d), generator=gen, device=device) * 0.1
    return {"feature": feat.cpu().numpy(), "threshold": thr.cpu().numpy(),
            "leaf": leaf.cpu().numpy()}


def onnx_bytes(spec: dict, params: dict) -> bytes:
    feat, thr, leaf = params["feature"], params["threshold"], params["leaf"]
    n_trees, n_internal = thr.shape
    a = {key: [] for key in ("nodes_treeids", "nodes_nodeids", "nodes_featureids", "nodes_modes",
                             "nodes_values", "nodes_truenodeids", "nodes_falsenodeids")}
    w = {key: [] for key in ("target_treeids", "target_nodeids", "target_ids",
                             "target_weights")}
    for t in range(n_trees):
        for nd in range(2 * n_internal + 1):
            inner = nd < n_internal
            a["nodes_treeids"].append(t)
            a["nodes_nodeids"].append(nd)
            a["nodes_featureids"].append(int(feat[t, nd]) if inner else 0)
            a["nodes_modes"].append("BRANCH_LEQ" if inner else "LEAF")
            a["nodes_values"].append(float(thr[t, nd]) if inner else 0.0)
            a["nodes_truenodeids"].append(2 * nd + 1 if inner else 0)
            a["nodes_falsenodeids"].append(2 * nd + 2 if inner else 0)
            if not inner:
                w["target_treeids"].append(t)
                w["target_nodeids"].append(nd)
                w["target_ids"].append(0)
                w["target_weights"].append(float(leaf[t, nd - n_internal]))
    node = ow.node("TreeEnsembleRegressor", ["X"], ["Y"], "ai.onnx.ml", n_targets=1,
                   base_values=[float(spec["base_value"])],
                   post_transform="LOGISTIC" if spec.get("logistic") else "NONE", **a, **w)
    return ow.model("GbtRegressor", [node], [],
                    [ow.value_info("X", ow.FLOAT, [-1, spec["features"]])],
                    [ow.value_info("Y", ow.FLOAT, [-1, 1])], [("", 13), ("ai.onnx.ml", 3)])


def walk(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Each row's leaf in each tree, [n, trees]: the f32 feature against the
    f32 threshold at every level, ``<=`` going left."""
    feat = torch.as_tensor(params["feature"], device=x.device)
    thr = torch.as_tensor(params["threshold"], device=x.device)
    n_trees, n_internal = thr.shape
    trees = torch.arange(n_trees, device=x.device)
    node = torch.zeros((x.shape[0], n_trees), dtype=torch.long, device=x.device)
    for _ in range((n_internal + 1).bit_length() - 1):
        go_right = torch.gather(x, 1, feat[trees, node]) > thr[trees, node]
        node = 2 * node + 1 + go_right.long()
    return node - n_internal


def reference(spec: dict, params: dict, x: torch.Tensor, output: int | None) -> tuple:
    """(value, err) over the rows of ``x`` [n, features] f32, in f64:
    z = base + the leaf weights, and with ``logistic`` p = 1 / (1 + e^-z).
    ``err`` bounds the program's f32 value: any f32 summation of the n
    terms is off by at most gamma_(n-1) times the sum of their magnitudes;
    the logistic's slope is at most 1/4, and its f32 exp (2 ulp), add and
    divide add a few units of roundoff, bounded by 8 u."""
    leaf = torch.as_tensor(params["leaf"], device=x.device).double()
    w = leaf[torch.arange(leaf.shape[0], device=x.device), walk(params, x)]     # [n, trees]
    base = float(spec["base_value"])
    n_terms = spec["trees"] + 1
    gamma = (n_terms - 1) * _U / (1 - (n_terms - 1) * _U)
    z, err = w.sum(1) + base, gamma * (w.abs().sum(1) + abs(base))
    if spec.get("logistic"):
        return torch.sigmoid(z), 0.25 * err + 8 * _U
    return z, err


def ops_per_row(spec: dict) -> int:
    """Per tree, a comparison and a child select at each level, and an add
    at the leaf."""
    return spec["trees"] * (2 * spec["depth"] + 1)
