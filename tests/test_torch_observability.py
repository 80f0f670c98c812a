"""``infera_tpu_torch.observability`` on the CPU: the profiler trace and its
spans, ``annotate`` with no profiler running, the kernel build cache, and the
metrics ring (as ``tests/test_observability.py`` holds ``infera_tpu``'s)."""

import json

import pytest
import torch

from infera_tpu_torch import config as config_mod
from infera_tpu_torch import observability as obs
from infera_tpu_torch.ops import _kernels


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
    assert {"name", "rows", "wall_ms", "rows_per_s", "bytes_in", "path"} <= set(rec.as_dict())


def test_metrics_ring_capacity():
    reg = obs.MetricsRegistry(capacity=3)
    for i in range(5):
        reg.record(obs.QueryMetrics(name=f"q{i}", rows=i, wall_s=1.0))
    assert len(reg.entries) == 3
    assert reg.entries[0].name == "q4"
