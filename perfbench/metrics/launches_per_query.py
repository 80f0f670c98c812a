"""launches_per_query (device trace): the kernels the card ran in the traced
window over the queries that got their rows in it; counted from the
profiler, not from the program's counters. Moves rows_per_s."""


def read(run):
    qs = run.traced()
    if not qs or run.trace is None:
        return None
    kernels = sum(1 for _, cat, _, _ in run.trace.events if cat == "kernel")
    return kernels / len(qs) if kernels else None
