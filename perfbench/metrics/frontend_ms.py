"""frontend_ms (program spans: ``conn._last_phases``): the mean per traced
query of its client's wall time less the device plan's phases: the parse,
the routing, the finish on the host and the thread's wait for the
interpreter. Moves latency_p95_ms."""


def read(run):
    qs = [q for q in run.traced() if q.phases]
    if not qs:
        return None
    own = [q.latency_s * 1e3 - sum(v for k, v in q.phases.items() if k.endswith("_ms"))
           for q in qs]
    return sum(own) / len(own)
