"""lower_ms (program spans: ``observability.spans``): the mean per traced
query of its ``lower`` span: the plan lowered onto K2's slots and looked up
in (or packed into) the connection's plan cache, inside exec_ms. The
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
    queries = {s.query_id for s in got if s.name == "execute"}
    ms: dict = {}
    for s in got:
        if s.name == "lower" and s.query_id in queries:
            ms[s.query_id] = ms.get(s.query_id, 0.0) + (s.t1_ns - s.t0_ns) / 1e6
    return None if dropped or not ms else sum(ms.values()) / len(ms)
