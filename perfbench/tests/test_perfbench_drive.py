"""Both cells driven end to end on the CPU at a tiny size through
``harness.run`` (the CLI refuses to run without a card): a result line of
the contract's shape, ``correct`` true on the program as it is, and false
under each configuration's control and under each fault a cell can have."""

import json
import math

import numpy as np
import pytest

from perfbench import harness

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
ROWS = 1 << 14            # the device plan's least table
SEED = 2**31 + 99         # past 32 signed bits


def _run(name, tmp_path, trace=False, control=None, seconds=5.0):
    import time

    return harness.run(BENCH, name, SEED, seconds, trace, time.perf_counter(), device="cpu",
                       rows=ROWS, control=control, tmpdir=tmp_path)


@pytest.mark.parametrize("name", CELLS)
def test_a_run_prints_a_contract_shaped_line(name, cpu_program):
    r = _run(name, cpu_program)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    wanted = [m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", [name])]
    assert sorted(r["metrics"]) == sorted(wanted)
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"]) and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert all(set(v) == {"value", "limit"} and v["value"] <= v["limit"]
               for v in r["checks"].values())
    json.dumps(r, allow_nan=False)


def test_a_traced_run_adds_the_window_and_the_breakdown(cpu_program):
    r = _run(CELLS[0], cpu_program, trace=True)
    assert list(r)[-2:] == ["breakdown", "checks"] and r["correct"] is True
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] >= 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the device readers find nothing and stay silent
    bases = {name.split(".")[0] for name in r["metrics"]}
    assert not {"device_idle", "kernel_roofline", "mfu"} & bases
    assert {"frontend_ms", "planner_ms", "exec_ms"} <= bases


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(name, cpu_program):
    wl = next(w for w in BENCH["workloads"] if w["name"] == name)
    control = harness.load("configs", wl["config"])["control"]
    r = _run(name, cpu_program, control=control)
    assert r["correct"] is False and r["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_a_query_off_its_path_comes_out_not_correct(name, cpu_program, monkeypatch):
    """With the kernel tier off the program serves every query on its torch
    program: every answer is right and off the path the mix names."""
    monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
    r = _run(name, cpu_program)
    assert r["correct"] is False and r["failed"] == r["attempted"] > 0
    assert r["checks"]["off_path"]["value"] == r["attempted"]
    assert r["checks"]["bad_answers"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_half_the_rows_left_out_comes_out_not_correct(name, cpu_program, monkeypatch):
    init = harness.Program.__init__

    def half(self, config, features, keys, params, *a, **k):
        n = keys.shape[0] // 2
        init(self, config, np.ascontiguousarray(features[:, :n]), keys[:n], params, *a, **k)

    monkeypatch.setattr(harness.Program, "__init__", half)
    r = _run(name, cpu_program)
    assert r["correct"] is False and r["checks"]["count_gap"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_produced_comes_out_not_correct(name, cpu_program, monkeypatch):
    execute = harness.execute
    calls = []

    def altered(conn, sql, label):
        rows, err, path, phases = execute(conn, sql, label)
        calls.append(1)
        if len(calls) == 20 and rows:              # one answer of the window
            g, *vals = rows[-1]
            rows = rows[:-1] + [(g, *vals[:-1], vals[-1] * (1 + 1e-3) + 1e-3)]
        return rows, err, path, phases

    monkeypatch.setattr(harness, "execute", altered)
    r = _run(name, cpu_program, seconds=8.0)
    assert len(calls) >= 20
    assert r["correct"] is False and r["failed"] == 1
