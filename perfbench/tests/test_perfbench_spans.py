"""The readers of the program's spans (``parse_ms``, ``cpu_ms``,
``off_cpu_ms``, ``lower_ms``, ``wait_ms``, ``idle_frontend``): each one's
exact value on a hand-built run and span list, None where there is nothing
to read, and a traced run of a cell on the CPU at a tiny size."""

import json
import math
import sys
import time

import pytest

from perfbench import harness, profiler_trace

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ("parse_ms", "cpu_ms", "off_cpu_ms", "lower_ms", "wait_ms", "idle_frontend")
MS = 1_000_000          # ns
S = 1_000_000_000


def _span(name, qid, sid, parent, thread, t0, t1, cpu0=None, cpu1=None):
    from infera_tpu_torch.observability import Span

    return Span(name, qid, sid, parent, thread, t0, t1, cpu0, cpu1)


def _run(trace):
    return harness.Run(config={}, mix={}, queries=[], start=0.0, end=10.0, setup_s=1.0,
                       trace=trace, least_s={}, table_rows=1)


def _trace(gaps=(), busy_s=1.0):
    return profiler_trace.Trace(t0=0.0, t1=10.0, busy_s=busy_s, gaps=list(gaps))


def _serve(monkeypatch, spans, dropped=False):
    from infera_tpu_torch import observability

    monkeypatch.setattr(observability, "spans", lambda t0, t1: (list(spans), dropped))


def _queries():
    """Three queries on one thread, wall (CPU) ms of execute 10 (6), 20 (10)
    and 30 (11); parse 2, 4 and 3; lower 0.5, 1.5 and 1; wait 3, 5 and 4;
    the first also upload, probe 0.1 and copy 1; and a parse of a query
    whose execute began before the window."""
    t = 1 * S
    return [
        _span("parse", 1, 2, 1, 7, t, t + 2 * MS),
        _span("upload", 1, 5, 4, 7, t, t + MS // 10),
        _span("probe", 1, 6, 4, 7, t, t + MS // 10),
        _span("lower", 1, 9, 8, 7, t, t + MS // 2),
        _span("wait", 1, 10, 8, 7, t, t + 3 * MS),
        _span("copy", 1, 11, 8, 7, t, t + MS),
        _span("execute", 1, 1, None, 7, t, t + 10 * MS, 0, 6 * MS),
        _span("parse", 2, 13, 12, 7, 2 * t, 2 * t + 4 * MS),
        _span("lower", 2, 14, 12, 7, 2 * t, 2 * t + 3 * MS // 2),
        _span("wait", 2, 15, 12, 7, 2 * t, 2 * t + 5 * MS),
        _span("execute", 2, 12, None, 7, 2 * t, 2 * t + 20 * MS, 0, 10 * MS),
        _span("parse", 3, 17, 16, 7, 3 * t, 3 * t + 3 * MS),
        _span("lower", 3, 18, 16, 7, 3 * t, 3 * t + MS),
        _span("wait", 3, 19, 16, 7, 3 * t, 3 * t + 4 * MS),
        _span("execute", 3, 16, None, 7, 3 * t, 3 * t + 30 * MS, MS, 12 * MS),
        _span("parse", 99, 20, 19, 7, t, t + 50 * MS),
    ]


@pytest.mark.parametrize("name, value", [("parse_ms", 3.0), ("cpu_ms", 9.0),
                                         ("off_cpu_ms", (4.0 + 10.0 + 19.0) / 3),
                                         ("lower_ms", 1.0), ("wait_ms", 4.0)])
def test_each_host_reader_gives_the_exact_mean(name, value, monkeypatch):
    _serve(monkeypatch, _queries())
    assert harness.load_metric(name).read(_run(_trace())) == pytest.approx(value, rel=1e-12)


# Client threads 1 and 2 run whole queries from 2 s to 8.5 s; of the gaps
# 3–5 s and 6–7 s (3 s), thread 1's device plans cover 3–4 s and 6.5–7 s
# (1.5 s: a share of 0.5 outside them), thread 2's 3.2–3.8 s (0.6 s: 0.8);
# the gaps before 2 s and after 8.5 s are left out. One client alone, from
# 2 s to 9 s: its device plans cover 3.5–4.5 s and 6.5–7 s, half the gaps.
TWO_CLIENTS = [_span("execute", 1, 1, None, 1, 1 * S, 4 * S),
               _span("execute", 2, 2, None, 1, 4 * S, 9 * S),
               _span("execute", 3, 3, None, 2, 2 * S, 17 * S // 2),
               _span("device_plan", 1, 4, 1, 1, 3 * S, 4 * S),
               _span("device_plan", 3, 5, 3, 2, 16 * S // 5, 19 * S // 5),
               _span("device_plan", 2, 6, 2, 1, 13 * S // 2, 15 * S // 2)]
ONE_CLIENT = [_span("execute", 1, 1, None, 1, 2 * S, 9 * S),
              _span("device_plan", 1, 2, 1, 1, 7 * S // 2, 9 * S // 2),
              _span("device_plan", 1, 3, 1, 1, 13 * S // 2, 7 * S)]


@pytest.mark.parametrize("spans, value", [(TWO_CLIENTS, 100.0 * (0.5 + 0.8) / 2),
                                          (ONE_CLIENT, 50.0)],
                         ids=["two clients", "one client"])
def test_idle_frontend_is_each_clients_share_of_idle_time_outside_its_device_plans(
        spans, value, monkeypatch):
    _serve(monkeypatch, spans)
    gaps = [(0.5, 1.5), (3.0, 5.0), (6.0, 7.0), (9.2, 9.8)]
    got = harness.load_metric("idle_frontend").read(_run(_trace(gaps)))
    assert got == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_every_reader_is_silent_with_nothing_to_read(name, monkeypatch):
    reader = harness.load_metric(name)
    gaps = [(3.0, 5.0)]
    _serve(monkeypatch, _queries())
    assert reader.read(_run(None)) is None                    # no trace
    _serve(monkeypatch, [s for s in _queries() if s.name != "execute"])
    assert reader.read(_run(_trace(gaps))) is None           # no query in the window
    _serve(monkeypatch, _queries(), dropped=True)
    assert reader.read(_run(_trace(gaps))) is None           # spans dropped in it
    from infera_tpu_torch import observability

    monkeypatch.delattr(observability, "spans")              # a program with no spans
    assert reader.read(_run(_trace(gaps))) is None
    monkeypatch.delitem(sys.modules, "infera_tpu_torch.observability")   # none loaded
    assert reader.read(_run(_trace(gaps))) is None


def test_a_traced_run_on_the_cpu_reads_the_host_spans(cpu_program):
    r = harness.run(BENCH, "mlp_f32.sql1", 2**31 + 7, 5.0, True, time.perf_counter(),
                    device="cpu", rows=1 << 14, tmpdir=cpu_program)
    assert r["correct"] is True
    for name in ("parse_ms", "cpu_ms", "off_cpu_ms", "lower_ms", "wait_ms"):
        v = r["metrics"][f"{name}.mlp"]["value"]
        assert math.isfinite(v) and v >= 0, name
    assert r["metrics"]["parse_ms.mlp"]["value"] > 0 and r["metrics"]["cpu_ms.mlp"]["value"] > 0
    # no device on the CPU: no idle time to share out
    assert "idle_frontend.mlp" not in r["metrics"]
