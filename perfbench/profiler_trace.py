"""A ``torch.profiler`` window over the running cell, read back into host
seconds: the card's kernels, copies and sets, their union, and the idle
gaps between them.

The union and idle arithmetic is copied from the port's
``testing/profile_query.trace_device_summary``. The profiler's clock is
tied to ``time.perf_counter`` by a span this module opens at each end of
the window on the thread that runs the profiler.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_START, _STOP = "perfbench.trace_start", "perfbench.trace_stop"


@dataclass
class Trace:
    t0: float                                    # perf_counter seconds
    t1: float
    events: list = field(default_factory=list)   # (name, category, start, end), clipped
    busy_s: float = 0.0
    gaps: list = field(default_factory=list)     # (start, end) with no device activity

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


class Window:
    """Start with ``start()``, end with ``stop()``, which returns the Trace."""

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()
        with record_function(_START):
            pass

    def stop(self) -> Trace:
        from torch.profiler import record_function

        self._t1 = time.perf_counter()
        with record_function(_STOP):
            pass
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X" and "dur" in e]
        finally:
            os.unlink(path)
        return read(events, self._t0, self._t1)


def warm() -> None:
    """Start and stop the profiler once, so that the traced window does not
    pay its first start."""
    w = Window()
    w.start()
    w.stop()


def read(events: list, t0: float, t1: float) -> Trace:
    """The Trace of profiler events (µs) whose two marker spans were opened
    at perf_counter times ``t0`` and ``t1``."""
    marks = {e["name"]: float(e["ts"]) for e in events if e["name"] in (_START, _STOP)}
    # profiler µs of a perf_counter second: the two markers fix the offset
    offset = ((marks[_START] - t0 * 1e6) + (marks[_STOP] - t1 * 1e6)) / 2
    dev = []
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        lo = (float(e["ts"]) - offset) / 1e6
        hi = lo + float(e["dur"]) / 1e6
        lo, hi = max(lo, t0), min(hi, t1)
        if hi > lo:
            dev.append((e["name"], e["cat"], lo, hi))
    dev.sort(key=lambda r: r[2])
    busy, gaps, cur_lo, cur_hi = 0.0, [], None, None
    last = t0
    for _, _, lo, hi in dev:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
                last = cur_hi
            if lo > last:
                gaps.append((last, lo))
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
        last = cur_hi
    if t1 > last:
        gaps.append((last, t1))
    return Trace(t0=t0, t1=t1, events=dev, busy_s=busy, gaps=gaps)
