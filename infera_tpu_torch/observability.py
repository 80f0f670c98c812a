"""Observability: profiler traces, the program's spans, per-query metrics,
the kernel build cache (counterpart of ``infera_tpu/observability.py``).

- ``trace(log_dir)``: a ``torch.profiler`` trace of the enclosed region (CPU,
  and the card's kernels and copies when the port's device is CUDA), written
  as a Chrome/Perfetto JSON file into ``log_dir``, with the program's spans
  of the region on their threads.
- ``span(name)``: one interval of the program's own work, recorded while a
  profiler session runs (``trace``, or any ``torch.profiler`` window) into
  the process-wide ring ``SPANS``, under the query id of the
  ``Connection.execute`` call that holds it; with no session it is a shared
  no-op that reads no clock. ``spans(t0_s, t1_s)`` reads a window of the
  ring back.
- ``annotate(name)``: a span that the profiler's own trace holds too (a
  ``record_function``, opened only while a session runs).
- ``QueryMetrics`` + ``measure()``: for every SQL statement, its wall time,
  rows, rows/s, the execution path that served it and the phases of a fused
  device plan, in the process-wide ``METRICS`` ring.
- ``enable_persistent_compilation_cache()``: the port compiles nothing
  through XLA; what persists across restarts is ``nvcc``'s kernel libraries,
  so this points their build directory at a cache directory.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

from . import log

# ---------------------------------------------------------------------- spans

RING_SPANS = 65_536
# the trace's marker ranges, which tie the profiler's clock to perf_counter
_TRACE_START, _TRACE_STOP = "infera.trace_start", "infera.trace_stop"


class Span(NamedTuple):
    """One recorded span; times in ns of ``time.perf_counter_ns``, CPU times
    of the thread in ns of ``time.thread_time_ns`` (a query's root span
    only; None on every other span)."""
    name: str
    query_id: int | None      # of the Connection.execute call that holds it
    span_id: int
    parent_id: int | None
    thread: int               # the OS thread id, the profiler trace's ``tid``
    t0_ns: int
    t1_ns: int
    cpu0_ns: int | None
    cpu1_ns: int | None


class SpanRing:
    """A bounded ring of closed spans (tuples of ``Span``'s fields, oldest
    first) that counts the spans it dropped."""

    def __init__(self, maxlen: int):
        self._ring: collections.deque = collections.deque(maxlen=maxlen)
        lock = threading.Lock()
        self._acquire, self._release = lock.acquire, lock.release
        self.dropped = 0
        self._dropped_t1 = -1     # the latest end of a dropped span, ns

    def add(self, rec: tuple) -> None:
        ring = self._ring
        self._acquire()
        try:
            if len(ring) == ring.maxlen:
                self.dropped += 1
                self._dropped_t1 = max(self._dropped_t1, ring[0][6])
            ring.append(rec)
        finally:
            self._release()

    def window(self, t0_ns: int, t1_ns: int) -> tuple:
        """(the spans wholly inside [t0_ns, t1_ns] in the order they closed,
        whether a span that ended after t0_ns was dropped)."""
        self._acquire()
        try:
            recs = list(self._ring)
            dropped = self._dropped_t1 >= t0_ns
        finally:
            self._release()
        return [Span(*r) for r in recs if t0_ns <= r[5] and r[6] <= t1_ns], dropped


SPANS = SpanRing(RING_SPANS)
_query_ids = itertools.count(1)
_span_ids = itertools.count(1)
_now, _cpu = time.perf_counter_ns, time.thread_time_ns


class _Thread(threading.local):
    def __init__(self):
        self.stack: list = []     # the open spans, innermost last
        self.thread = threading.get_native_id()


_local = _Thread()


class _OpenSpan:
    """A span being recorded. ``open``/``close`` (or ``with``): closing pops
    every span opened inside it and left open, which is not recorded."""

    __slots__ = ("name", "root", "rf", "query_id", "span_id", "parent_id", "t0", "cpu0",
                 "stack")

    def __init__(self, name: str, root: bool, profiler: bool):
        self.name, self.root = name, root
        self.rf = torch.profiler.record_function(name) if profiler else None

    def open(self, t0_ns: int | None = None) -> _OpenSpan:
        """Start the span, at ``t0_ns`` (a perf_counter_ns reading the
        caller took) or now."""
        self.t0 = _now() if t0_ns is None else t0_ns
        stack = self.stack = _local.stack
        parent = stack[-1] if stack else None
        self.parent_id = None if parent is None else parent.span_id
        if self.root:
            self.query_id, self.cpu0 = next(_query_ids), _cpu()
        else:
            self.query_id, self.cpu0 = None if parent is None else parent.query_id, None
        self.span_id = next(_span_ids)
        stack.append(self)
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def close(self) -> int:
        """End the span now and record it; returns the perf_counter_ns
        reading that ended it."""
        cpu1 = None if self.cpu0 is None else _cpu()
        t1 = _now()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = self.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i:]
                SPANS.add((self.name, self.query_id, self.span_id, self.parent_id,
                           _local.thread, self.t0, t1, self.cpu0, cpu1))
                break
        return t1       # not found: a span around it closed first

    __enter__ = open

    def __exit__(self, *exc) -> None:
        self.close()


class _NoSpan:
    """What ``span`` gives while no profiler session runs."""

    __slots__ = ()

    def open(self, t0_ns: int | None = None) -> _NoSpan:
        return self

    def close(self) -> None:
        return None

    __enter__ = open

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()


def span(name: str, root: bool = False, profiler: bool = False):
    """A span of the program's work, recorded only while a ``torch.profiler``
    session runs (on any thread: the profiler's Python flag is process-wide);
    otherwise the shared ``NO_SPAN``. Use as ``with span(name):``, or
    ``span(name).open(t0_ns)`` ... ``.close()`` where its start is a reading
    the caller took. ``root``: the span is a query's: it takes a fresh query
    id and reads the thread's CPU time at its ends; any other span takes its
    parent's id and reads no CPU time, a system call that took 35-300 µs a
    read in a thread driving the card under gVisor (the wall clock: 0.1-0.6
    µs), where the CPU clock also moves in 10 ms ticks, so only a mean over
    many queries means anything. ``profiler``: the session's own trace holds
    it too, as a ``record_function``."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return _OpenSpan(name, root, profiler)


def spans(t0_s: float, t1_s: float) -> tuple:
    """(the recorded spans that lie wholly inside the perf_counter window
    [t0_s, t1_s], as ``Span``s; whether the ring dropped a span that ended
    after t0_s)."""
    return SPANS.window(int(t0_s * 1e9), int(t1_s * 1e9))


def _write_spans(path: Path, t0_ns: int, t1_ns: int) -> None:
    """Move the ring's spans of [t0_ns, t1_ns] into the Chrome trace at
    ``path`` as "X" events (category ``program_span``) on their threads,
    onto the profiler's clock by the window's two marker ranges, which are
    then taken out."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    marks = {e["name"]: float(e["ts"]) for e in events
             if e.get("ph") == "X" and e.get("name") in (_TRACE_START, _TRACE_STOP)}
    if len(marks) != 2:
        return
    # profiler µs less perf_counter µs, from the two markers
    offset = ((marks[_TRACE_START] - t0_ns / 1e3) + (marks[_TRACE_STOP] - t1_ns / 1e3)) / 2
    pid = os.getpid()
    got, _dropped = SPANS.window(t0_ns, t1_ns)
    events[:] = [e for e in events if e.get("name") not in (_TRACE_START, _TRACE_STOP)]
    events += [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.thread,
                "ts": s.t0_ns / 1e3 + offset, "dur": (s.t1_ns - s.t0_ns) / 1e3,
                "args": {"query_id": s.query_id, "span_id": s.span_id, "parent": s.parent_id,
                         **({} if s.cpu0_ns is None else
                            {"cpu_us": (s.cpu1_ns - s.cpu0_ns) / 1e3})}} for s in got]
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Collect a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` (``<pid>.<ns>.pt.trace.json``), the program's spans of the
    region among its events; yields the profiler, whose ``key_averages()``
    sum the region's operations by name."""
    if create_perfetto_link:
        raise ValueError("create_perfetto_link needs the Perfetto UI: open the trace file "
                         "written into log_dir at ui.perfetto.dev instead")
    from torch.profiler import ProfilerActivity, profile, record_function

    from .device import get_device

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and get_device().type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    t0 = time.perf_counter_ns()
    with record_function(_TRACE_START):
        pass
    try:
        yield prof
    finally:
        t1 = time.perf_counter_ns()
        with record_function(_TRACE_STOP):
            pass
        prof.stop()
        path = Path(log_dir) / f"{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        _write_spans(path, t0, t1)
        log.info(f"profiler trace written to {path}")


def annotate(name: str):
    """A named span for profiler attribution (host, and the card's work
    launched inside it): ``span(name, profiler=True)``, a no-op with no
    profiler running."""
    return span(name, profiler=True)


@dataclass
class QueryMetrics:
    name: str
    rows: int = 0
    wall_s: float = 0.0
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
def measure(name: str, rows: int = 0):
    """Record wall time + rows/s for a query region into METRICS, inside the
    span ``statement``."""
    m = QueryMetrics(name=name, rows=rows)
    with span("statement"):
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
