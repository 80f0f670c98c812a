"""The benchmark on the card: each cell's CLI run at its full size with a
short window comes out correct with a contract-shaped line, and each
cell's control comes out not correct. Run on a machine with a card:
``python -m pytest perfbench/tests -q -m cuda``."""

import json
import subprocess
import sys

import pytest
import torch

from .conftest import ROOT

pytestmark = pytest.mark.cuda
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(args: list) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_correct_on_the_card(cuda, name):
    out = _run(["perfbench/run.py", "--workload", name, "--seed", str(2**31 + 17),
                "--seconds", "2", "--trace", "0"])
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["device"]["memory_peak_bytes"] > 0
    assert sorted(r["metrics"]) == sorted(m["name"] for m in BENCH["end_to_end"]
                                          if name in m.get("workloads", [name]))
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(cuda, name):
    out = _run(["perfbench/control.py", "--workload", name, "--seeds", "5", "--seconds", "1"])
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is False and r["failed"] > 0
