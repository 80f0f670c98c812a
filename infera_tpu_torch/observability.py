"""Per-query metrics (counterpart of part of ``infera_tpu/observability.py``).

``QueryMetrics`` + ``measure()`` record, for every SQL statement, its wall
time, rows, rows/s, the execution path that served it and the phases of a
fused device plan into the process-wide ``METRICS`` ring. Profiler traces and
the compilation cache of ``infera_tpu`` come in a later slice.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


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
