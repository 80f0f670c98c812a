"""planner_ms (program spans: ``conn._last_phases``): the mean per traced
query of plan_ms + upload_ms + probe_ms + assemble_ms, the device plan's
host work around the launch. Moves latency_p95_ms."""

PHASES = ("plan_ms", "upload_ms", "probe_ms", "assemble_ms")


def read(run):
    qs = [q for q in run.traced() if q.phases]
    if not qs:
        return None
    return sum(sum(q.phases.get(k, 0.0) for k in PHASES) for q in qs) / len(qs)
