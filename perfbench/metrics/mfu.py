"""mfu (device trace window; host clock), %: the sum of the least times on
the card of the queries that got their rows in the traced window, over
that window: the whole step's share of the card's published peak at the
configuration's precision, or of its memory rate where the bytes bound a
query. Moves rows_per_s."""


def read(run):
    qs = run.traced()
    if not qs or run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * sum(run.least_s[(q.template, q.value)] for q in qs) / run.trace.window_s
