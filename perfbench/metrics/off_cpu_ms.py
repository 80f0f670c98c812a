"""off_cpu_ms (program spans: ``observability.spans``): the mean per traced
query of the time its client thread was off the CPU: the ``execute`` span's
wall time less its CPU time (``time.thread_time_ns``). That holds every
wait the thread slept through: for the interpreter lock (``Tensor.cpu`` and
the ctypes launch let it go), for the OS, and for the card where a
read-back sleeps rather than spins. The traced queries are the ``execute``
spans wholly inside the traced window; None with no trace, a program that
records no spans, no such query, or spans dropped in the window. Moves
latency_p95_ms (.mlp), rows_per_s (.gbt)."""

import sys


def read(run):
    if run.trace is None:
        return None
    # what the running program recorded; the reader loads nothing of it
    spans = getattr(sys.modules.get("infera_tpu_torch.observability"), "spans", None)
    if spans is None:
        return None
    got, dropped = spans(run.trace.t0, run.trace.t1)
    off = [(s.t1_ns - s.t0_ns) - (s.cpu1_ns - s.cpu0_ns) for s in got if s.name == "execute"]
    return None if dropped or not off else sum(off) / len(off) / 1e6
