"""The work counts against hand counts."""

import pytest

from perfbench import harness, work
from perfbench.models import mlp, tree_ensemble

MLP_CFG = harness.load("configs", "mlp_classifier_f32")
GBT_CFG = harness.load("configs", "gbt_models_f32")
B = harness.load("mixes", "sql1_mlp")["templates"]["b"]
D, E = (harness.load("mixes", "sql4_gbt")["templates"][k] for k in ("d", "e"))


def test_ops_per_row_by_hand():
    assert mlp.ops_per_row(MLP_CFG["models"][0]) == 2 * (54 * 100 + 100 * 7) == 12_200
    for spec in GBT_CFG["models"]:
        assert tree_ensemble.ops_per_row(spec) == 100 * (6 * 2 + 1) == 1_300
    assert tree_ensemble.ops_per_row({"trees": 2, "depth": 3, "features": 4}) == 2 * 7


def test_mlp_query_scores_only_kept_rows():
    n = MLP_CFG["table"]["rows"]
    ops, nbytes = work.count(MLP_CFG, B, kept_rows=1000, groups=7)
    assert ops == 12_200 * 1000
    # cover_type and the 54 features (elevation among them), four bytes a
    # row each, and 7 groups of 4 outputs
    assert nbytes == 55 * 4 * n + 7 * 4 * 8


@pytest.mark.parametrize("template, columns", [(D, 29), (E, 22)])
def test_forest_query_scores_every_row(template, columns):
    n = GBT_CFG["table"]["rows"]
    ops, nbytes = work.count(GBT_CFG, template, kept_rows=7, groups=2)
    assert ops == 1_300 * n
    # label and the model's 28 or 21 features, and 2 groups of 4 outputs
    assert nbytes == columns * 4 * n + 2 * 4 * 8


def test_least_time_takes_the_larger_bound():
    peaks = work.card_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == work.PEAKS["SXM"]
    assert work.least_seconds(67e12, 1, peaks, "f32") == pytest.approx(1.0)
    assert work.least_seconds(1, 3.35e12, peaks, "f32") == pytest.approx(1.0)
    assert work.card_peaks("NVIDIA H100 PCIe")["f32"] == 51e12
