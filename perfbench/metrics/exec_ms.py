"""exec_ms (program spans: ``conn._last_phases``): the mean per traced query
of the device plan's exec_ms: the launch, any wait behind other clients'
work on the card, and the read-back of the group table. Moves rows_per_s."""


def read(run):
    qs = [q for q in run.traced() if q.phases and "exec_ms" in q.phases]
    return sum(q.phases["exec_ms"] for q in qs) / len(qs) if qs else None
