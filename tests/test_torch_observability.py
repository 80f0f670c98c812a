"""``infera_tpu_torch.observability`` on the CPU: the profiler trace and its
spans, ``annotate`` with no profiler running, the kernel build cache, and the
metrics ring (as ``tests/test_observability.py`` holds ``infera_tpu``'s);
then the program's spans: nothing recorded with no profiler, the tree of a
K2 query (its plain version) under one query id, the plan cache's hits,
threads, CPU time, the ring's bound and the spans in the trace file."""

import json
import threading
import time

import pytest
import torch

import infera_tpu_torch as itt
from infera_tpu_torch import config as config_mod
from infera_tpu_torch import observability as obs
from infera_tpu_torch.ops import _kernels
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_plan as dp


def _trace_events(log_dir):
    (path,) = log_dir.glob("*.pt.trace.json")
    return json.loads(path.read_text())["traceEvents"]


def test_trace_writes_a_trace_holding_the_annotated_spans(tmp_path):
    with obs.trace(str(tmp_path / "t")) as prof:
        for _ in range(3):
            with obs.annotate("query A"):
                torch.ones(256).cumsum(0)
    spans = [e for e in _trace_events(tmp_path / "t")
             if e.get("cat") == "user_annotation" and e["name"] == "query A"]
    assert len(spans) == 3 and all(e["dur"] >= 0 for e in spans)
    assert any(e.key == "query A" and e.count == 3 for e in prof.key_averages())


def test_trace_is_written_when_the_region_raises(tmp_path):
    with pytest.raises(KeyError):
        with obs.trace(str(tmp_path)):
            with obs.annotate("failing"):
                raise KeyError("x")
    assert any(e.get("name") == "failing" for e in _trace_events(tmp_path))


def test_trace_logs_its_path(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("INFERA_LOG_LEVEL", "INFO")
    config_mod.reset_config_for_tests()
    try:
        with obs.trace(str(tmp_path)):
            pass
        (path,) = tmp_path.glob("*.pt.trace.json")
        assert f"[INFO] profiler trace written to {path}" in capsys.readouterr().err
    finally:
        monkeypatch.delenv("INFERA_LOG_LEVEL")
        config_mod.reset_config_for_tests()


def test_perfetto_link_is_refused(tmp_path):
    with pytest.raises(ValueError, match="Perfetto UI"):
        with obs.trace(str(tmp_path), create_perfetto_link=True):
            pass
    assert not list(tmp_path.iterdir())


def test_annotate_is_usable():
    with obs.annotate("op-name"):
        x = sum(range(10))
    assert x == 45


def test_persistent_cache_moves_the_build_directory_without_building(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD", _kernels.BUILD)   # restored after the test
    loaded = dict(_kernels._libs)
    cache = tmp_path / "kernels"
    assert obs.enable_persistent_compilation_cache(str(cache)) == str(cache)
    assert _kernels.BUILD == cache
    assert _kernels._lib_path("fused_query") == cache / "libfused_query.so"
    assert not cache.exists()                       # nothing is built until first use
    assert _kernels._stale("fused_query")
    assert _kernels._libs == loaded


def test_persistent_cache_defaults_under_the_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD", _kernels.BUILD)
    monkeypatch.setenv("INFERA_CACHE_DIR", str(tmp_path))
    config_mod.reset_config_for_tests()
    try:
        got = obs.enable_persistent_compilation_cache()
    finally:
        monkeypatch.delenv("INFERA_CACHE_DIR")
        config_mod.reset_config_for_tests()
    assert got == str(tmp_path / "cuda_kernel_cache")
    assert _kernels.BUILD == tmp_path / "cuda_kernel_cache"


def test_measure_records_metrics():
    with obs.measure("q1", rows=1000) as m:
        pass
    assert m.wall_s >= 0
    rec = next(r for r in obs.METRICS.entries if r.name == "q1")
    assert rec.rows == 1000
    assert {"name", "rows", "wall_ms", "rows_per_s", "path"} <= set(rec.as_dict())


def test_metrics_ring_capacity():
    reg = obs.MetricsRegistry(capacity=3)
    for i in range(5):
        reg.record(obs.QueryMetrics(name=f"q{i}", rows=i, wall_s=1.0))
    assert len(reg.entries) == 3
    assert reg.entries[0].name == "q4"


# ---------------------------------------------------------------------- the program's spans

N = dp.MIN_DEVICE_ROWS * 2
Q = "select g, count(*), sum(f) from t group by g order by g"
PHASES = ("plan", "upload", "probe", "exec", "assemble")


@pytest.fixture()
def k2_conn(monkeypatch):
    """A connection over one table whose aggregate runs K2's plain version,
    the cells' path on the card."""
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    itt.set_device("cpu")
    conn = Connection()
    conn.execute(f"create table t as select x % 8 as g, x * 0.5 as f from range({N}) r(x)")
    yield conn
    itt.set_device(None)


def _traced(log_dir, fn) -> list:
    """The spans recorded while ``fn`` ran inside ``observability.trace``."""
    t0 = time.perf_counter()
    with obs.trace(str(log_dir)):
        fn()
    got, dropped = obs.spans(t0, time.perf_counter())
    assert not dropped
    return got


def _tree(spans: list, query_id: int) -> dict:
    """{name: [spans]} of one query, each checked to lie inside its parent."""
    mine = [s for s in spans if s.query_id == query_id]
    by_id = {s.span_id: s for s in mine}
    out: dict = {}
    for s in mine:
        out.setdefault(s.name, []).append(s)
        if s.parent_id is not None:
            p = by_id[s.parent_id]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns, (s, p)
            assert p.thread == s.thread
    return out


def _parent(tree, name):
    (s,) = tree[name]
    return next(p.name for ps in tree.values() for p in ps if p.span_id == s.parent_id)


def test_span_with_no_profiler_records_nothing_and_is_the_shared_no_op():
    before = list(obs.SPANS._ring)
    sp = obs.span("x", root=True)
    assert sp is obs.NO_SPAN and obs.annotate("y") is obs.NO_SPAN
    with sp as entered:
        assert entered is obs.NO_SPAN
    assert sp.open(123) is obs.NO_SPAN and sp.close() is None
    assert list(obs.SPANS._ring) == before


def test_query_path_reads_no_span_clock_and_opens_no_record_function_when_off(k2_conn,
                                                                               monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("read or opened with no profiler running")

    before = list(obs.SPANS._ring)
    monkeypatch.setattr(obs, "_now", refuse)
    monkeypatch.setattr(obs, "_cpu", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    rows = k2_conn.execute(Q).rows
    assert k2_conn._exec_path == "device_plan_cuda" and len(rows) == 8
    assert list(obs.SPANS._ring) == before


def test_a_k2_query_records_its_tree_under_one_query_id(k2_conn, tmp_path):
    got = _traced(tmp_path, lambda: k2_conn.execute(Q))
    (root,) = [s for s in got if s.name == "execute"]
    assert root.parent_id is None and root.query_id is not None
    tree = _tree(got, root.query_id)
    assert sorted(tree) == sorted(["execute", "parse", "statement", "device_plan", *PHASES,
                                   "lower", "pack", "launch", "wait", "copy"])
    assert all(len(v) == 1 for v in tree.values())
    assert {_parent(tree, n) for n in ("parse", "statement")} == {"execute"}
    assert _parent(tree, "device_plan") == "statement"
    assert {_parent(tree, n) for n in PHASES} == {"device_plan"}
    assert {_parent(tree, n) for n in ("lower", "launch", "wait", "copy")} == {"exec"}
    assert _parent(tree, "pack") == "lower"
    # the phases follow one another, and exec's children too
    for a, b in zip(PHASES, PHASES[1:]):
        assert tree[a][0].t1_ns <= tree[b][0].t0_ns
    for a, b in (("lower", "launch"), ("launch", "wait"), ("wait", "copy")):
        assert tree[a][0].t1_ns <= tree[b][0].t0_ns
    # each phase and its span are the same two readings
    phases = k2_conn._last_phases
    assert sorted(phases) == sorted(f"{n}_ms" for n in PHASES)
    for n in PHASES:
        (s,) = tree[n]
        assert phases[f"{n}_ms"] == round((s.t1_ns - s.t0_ns) / 1e6, 3)


def test_the_same_query_again_finds_its_plan_packed(k2_conn, tmp_path):
    got = _traced(tmp_path, lambda: [k2_conn.execute(Q) for _ in range(2)])
    first, again = sorted(s.query_id for s in got if s.name == "execute")
    assert "pack" in _tree(got, first) and "lower" in _tree(got, again)
    assert "pack" not in _tree(got, again)


def test_two_threads_queries_get_their_own_ids_and_parents(k2_conn, tmp_path):
    conns = [k2_conn, Connection(k2_conn.catalog)]
    for c in conns:
        c.execute(Q)                  # plan and probe once, outside the window
    errors: list = []

    def client(c):
        try:
            for _ in range(3):
                c.execute(Q)
        except Exception as e:       # raised again below
            errors.append(e)

    def both():
        threads = [threading.Thread(target=client, args=(c,)) for c in conns]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)

    got = _traced(tmp_path, both)
    assert not errors
    roots = [s for s in got if s.name == "execute"]
    assert len(roots) == 6 and len({s.query_id for s in roots}) == 6
    assert len({s.thread for s in roots}) == 2
    for r in roots:
        tree = _tree(got, r.query_id)
        assert {s.thread for ss in tree.values() for s in ss} == {r.thread}
        assert _parent(tree, "device_plan") == "statement"


def test_cpu_time_is_read_at_the_root_and_is_at_most_wall_time(k2_conn, tmp_path):
    got = _traced(tmp_path, lambda: [k2_conn.execute(Q) for _ in range(3)])
    res_ns = 1e9 * max(time.get_clock_info("thread_time").resolution,
                       time.get_clock_info("perf_counter").resolution)
    roots = [s for s in got if s.name == "execute"]
    assert len(roots) == 3
    for s in roots:
        assert 0 < s.cpu1_ns - s.cpu0_ns <= s.t1_ns - s.t0_ns + res_ns, s
    assert all(s.cpu0_ns is None and s.cpu1_ns is None for s in got if s.name != "execute")


def test_a_span_left_open_is_dropped_when_its_parent_closes(tmp_path):
    def body():
        with obs.span("outer", root=True):
            obs.span("left open").open()
            with obs.span("inner"):
                pass
        assert obs._local.stack == []

    got = _traced(tmp_path, body)
    assert [s.name for s in got] == ["inner", "outer"]
    inner, outer = got
    assert inner.parent_id != outer.span_id and inner.query_id == outer.query_id


def test_the_ring_drops_its_oldest_spans_past_its_bound_and_counts_them(tmp_path, monkeypatch):
    monkeypatch.setattr(obs, "SPANS", obs.SpanRing(4))

    def six():
        for i in range(6):
            with obs.span(f"s{i}"):
                pass

    t0 = time.perf_counter()
    with obs.trace(str(tmp_path)):
        six()
    t1 = time.perf_counter()
    assert obs.SPANS.dropped == 2
    got, dropped = obs.spans(t0, t1)
    assert [s.name for s in got] == ["s2", "s3", "s4", "s5"] and dropped
    # a window that starts after the dropped spans ended lost nothing
    got, dropped = obs.spans(got[0].t0_ns / 1e9, t1)
    assert [s.name for s in got] == ["s2", "s3", "s4", "s5"] and not dropped


def test_the_trace_file_holds_the_spans_as_x_events(k2_conn, tmp_path):
    got = _traced(tmp_path, lambda: k2_conn.execute(Q))
    events = _trace_events(tmp_path)
    mine = [e for e in events if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in mine) == sorted(s.name for s in got)
    assert all(e["ph"] == "X" and e["dur"] >= 0 and {"query_id", "parent"} <= set(e["args"])
               for e in mine)
    (root,) = [e for e in mine if e["name"] == "execute"]
    assert root["args"]["parent"] is None
    assert all(e["args"]["query_id"] == root["args"]["query_id"] for e in mine)
    # on the profiler's clock: inside the window of the profiler's own events
    others = [e for e in events if e.get("ph") == "X" and e.get("cat") != "program_span"]
    lo = min(float(e["ts"]) for e in others)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in others)
    assert all(lo - 1e3 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e3 for e in mine)
    assert not [e for e in events if e.get("name", "").startswith("infera.trace_")]
