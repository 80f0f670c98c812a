"""Observability: profiler traces, per-query metrics, the kernel build cache
(counterpart of ``infera_tpu/observability.py``).

- ``trace(log_dir)``: a ``torch.profiler`` trace of the enclosed region (CPU,
  and the card's kernels and copies when the port's device is CUDA), written
  as a Chrome/Perfetto JSON file into ``log_dir``.
- ``annotate(name)``: a named span in that trace; usable with no profiler
  running.
- ``QueryMetrics`` + ``measure()``: for every SQL statement, its wall time,
  rows, rows/s, the execution path that served it and the phases of a fused
  device plan, in the process-wide ``METRICS`` ring.
- ``enable_persistent_compilation_cache()``: the port compiles nothing
  through XLA; what persists across restarts is ``nvcc``'s kernel libraries,
  so this points their build directory at a cache directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import log


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Collect a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` (``<pid>.<ns>.pt.trace.json``); yields the profiler, whose
    ``key_averages()`` sum the region's operations by name."""
    if create_perfetto_link:
        raise ValueError("create_perfetto_link needs the Perfetto UI: open the trace file "
                         "written into log_dir at ui.perfetto.dev instead")
    from torch.profiler import ProfilerActivity, profile

    from .device import get_device

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and get_device().type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = Path(log_dir) / f"{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        log.info(f"profiler trace written to {path}")


def annotate(name: str):
    """A named span for profiler attribution (host, and the card's work
    launched inside it)."""
    return torch.profiler.record_function(name)


@dataclass
class QueryMetrics:
    name: str
    rows: int = 0
    wall_s: float = 0.0
    bytes_in: int = 0
    # execution path that served the statement: host | device_plan_cuda
    path: str = "host"
    # per-phase wall-clock breakdown of a fused plan (device_plan.py:
    # plan_ms, upload_ms, probe_ms, exec_ms, assemble_ms)
    phases: dict | None = None

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.wall_s if self.wall_s > 0 else 0.0

    def as_dict(self) -> dict:
        d = {
            "name": self.name,
            "rows": self.rows,
            "wall_ms": round(self.wall_s * 1e3, 3),
            "rows_per_s": round(self.rows_per_s, 1),
            "bytes_in": self.bytes_in,
            "path": self.path,
        }
        if self.phases:
            d["phases"] = self.phases
        return d


@dataclass
class MetricsRegistry:
    """Process-wide query metrics ring (most recent first)."""

    entries: list = field(default_factory=list)
    capacity: int = 256

    def record(self, m: QueryMetrics) -> None:
        self.entries.insert(0, m)
        del self.entries[self.capacity:]

    def summary(self) -> list:
        return [m.as_dict() for m in self.entries]


METRICS = MetricsRegistry()


@contextlib.contextmanager
def measure(name: str, rows: int = 0, bytes_in: int = 0):
    """Record wall time + rows/s for a query region into METRICS."""
    m = QueryMetrics(name=name, rows=rows, bytes_in=bytes_in)
    t0 = time.perf_counter()
    try:
        yield m
    finally:
        m.wall_s = time.perf_counter() - t0
        METRICS.record(m)


def enable_persistent_compilation_cache(cache_dir: str | None = None) -> str:
    """Build and load the CUDA kernel libraries under ``cache_dir`` (default
    ``<INFERA_CACHE_DIR>/cuda_kernel_cache``) from now on, so that a later
    process finds them built; libraries already loaded stay loaded."""
    from .config import get_config
    from .ops import _kernels

    if cache_dir is None:
        cache_dir = str(get_config().cache_dir / "cuda_kernel_cache")
    _kernels.set_build_dir(cache_dir)
    log.info(f"persistent kernel build cache at {cache_dir}")
    return cache_dir
