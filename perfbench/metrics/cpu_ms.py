"""cpu_ms (program spans: ``observability.spans``): the mean per traced
query of its client thread's CPU time over the ``execute`` span
(``time.thread_time_ns``), a measure of the host's work that waiting for
the interpreter lock or the card leaves out. Where the CPU clock moves in
ticks (10 ms under gVisor) only the mean over many queries holds. The
traced queries are the ``execute`` spans wholly inside the traced window;
None with no trace, a program that records no spans, no such query, or
spans dropped in the window. Moves latency_p95_ms (.mlp), rows_per_s
(.gbt)."""

import sys


def read(run):
    if run.trace is None:
        return None
    # what the running program recorded; the reader loads nothing of it
    spans = getattr(sys.modules.get("infera_tpu_torch.observability"), "spans", None)
    if spans is None:
        return None
    got, dropped = spans(run.trace.t0, run.trace.t1)
    cpu = [(s.cpu1_ns - s.cpu0_ns) / 1e6 for s in got if s.name == "execute"]
    return None if dropped or not cpu else sum(cpu) / len(cpu)
