"""BENCHMARK.json against the benchmark's contract, and every entry found by
name from files alone."""

import json
import re
import shutil

import pytest

from perfbench import harness

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["perfbench"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_keep_the_contract(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"])
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
        if section == "per_layer":
            assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        if section == "workloads":
            assert e["chips"] in (1, 4) and NAME.match(e["config"]) and NAME.match(e["traffic"])


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer_metric():
    for wl in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if wl["name"] in m.get("workloads",
                                                                              [wl["name"]])]
        layer = [m for m in BENCH["per_layer"] if wl["name"] in m.get("workloads", [wl["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_found_by_name(wl, trace):
    c = harness.cell(BENCH, wl, trace)
    assert c.config["name"] == c.workload["config"]
    assert c.mix["name"] == c.workload["traffic"]
    listed = BENCH["per_layer" if trace else "end_to_end"]
    assert [m["name"] for m, _ in c.metrics] == [m["name"] for m in listed
                                               if wl in m.get("workloads", [wl])]
    assert all(callable(reader.read) for _, reader in c.metrics)
    for t in c.mix["templates"].values():
        sql = harness.sql_of(c.config, t, harness.values_of(t)[0])
        key = c.config["table"]["key"]["name"]
        assert sql.startswith(f"select {key}, ") and sql.endswith(f"order by {key}")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file_matches_its_entry(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert set(data["limits"]) == {"count_gap", "agg_gap"}


def test_new_entries_are_found_from_new_files(tmp_path, monkeypatch):
    """A later cell is a copy of files under new names, found with no edit."""
    pkg = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", pkg, ignore=shutil.ignore_patterns(".cache"))
    (pkg / "configs" / "mlp_copy.json").write_text(
        (pkg / "configs" / "mlp_classifier_f32.json").read_text())
    (pkg / "mixes" / "sql4_copy.json").write_text(json.dumps(
        {**json.loads((pkg / "mixes" / "sql1_mlp.json").read_text()), "name": "sql4_copy",
         "clients": [{"template": "b", "count": 4}]}))
    (pkg / "metrics" / "queries_done.py").write_text(
        "def read(run):\n    return len(run.completed())\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mlp.sql4", "config": "mlp_copy", "traffic": "sql4_copy",
                               "chips": 1, "why": "four clients"})
    bench["end_to_end"].append({"name": "queries_done", "unit": "queries", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["mlp.sql4"]})
    monkeypatch.setattr(harness, "HERE", pkg)
    c = harness.cell(bench, "mlp.sql4", False)
    assert c.mix["clients"] == [{"template": "b", "count": 4}]
    assert [m["name"] for m, _ in c.metrics][-1] == "queries_done"
    assert "queries_done" not in [m["name"] for m, _ in harness.cell(bench, "mlp_f32.sql1",
                                                                      False).metrics]
