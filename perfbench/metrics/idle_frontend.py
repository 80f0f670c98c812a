"""idle_frontend (program spans over the device trace), %: of the card's
idle time in the traced window (``run.trace.gaps``), the share in which a
client had no ``device_plan`` span open, the mean over the clients: idle
time while the client was in the SQL front end, the finish on the host or
its own code between queries. The rest is its host work inside the
device plan. With one client, the share of idle time that no device plan
covers. Counted where every client's spans are whole: from the latest
first ``execute`` start to the earliest last ``execute`` end among the
client threads (a span open when the trace began was never recorded).
None with no trace, no device activity, a program that records no spans,
no such query, or spans dropped in the window. Moves latency_p95_ms
(.mlp), rows_per_s (.gbt)."""

import sys


def _covered(gaps, plans) -> float:
    """Seconds of ``gaps`` that the sorted intervals ``plans`` cover."""
    covered = 0.0
    for g0, g1 in gaps:
        reach = g0              # the gap is covered up to here
        for p0, p1 in plans:
            p0, p1 = max(p0, reach), min(p1, g1)
            if p1 > p0:
                covered += p1 - p0
                reach = p1
    return covered


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    # what the running program recorded; the reader loads nothing of it
    spans = getattr(sys.modules.get("infera_tpu_torch.observability"), "spans", None)
    if spans is None:
        return None
    got, dropped = spans(tr.t0, tr.t1)
    first: dict = {}
    last: dict = {}
    for s in got:
        if s.name == "execute":
            first[s.thread] = min(first.get(s.thread, s.t0_ns), s.t0_ns)
            last[s.thread] = max(last.get(s.thread, s.t1_ns), s.t1_ns)
    if dropped or not first:
        return None
    lo, hi = max(first.values()) / 1e9, min(last.values()) / 1e9
    gaps = [(max(g0, lo), min(g1, hi)) for g0, g1 in tr.gaps]
    gaps = [(g0, g1) for g0, g1 in gaps if g1 > g0]
    idle = sum(g1 - g0 for g0, g1 in gaps)
    if idle <= 0:
        return None
    shares = [1.0 - _covered(gaps, sorted((s.t0_ns / 1e9, s.t1_ns / 1e9) for s in got
                                          if s.name == "device_plan" and s.thread == t)) / idle
              for t in first]
    return 100.0 * sum(shares) / len(shares)
