"""latency_p95_ms (host clock): the 95th percentile of every query that got
its rows inside the window, timed on its client's thread from the call of
``Connection.execute`` to the rows in hand. Moves: itself."""

import numpy as np


def read(run):
    lat = [q.latency_s for q in run.completed()]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
