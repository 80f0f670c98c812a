"""kernel_roofline (device trace), %: the sum of each traced query's least
time on the card (``work.py``: its operations over the configuration's
peak or its bytes over the memory's, whichever is larger) over the sum of
all kernel, copy and set time in the traced window. Moves rows_per_s."""


def read(run):
    qs = run.traced()
    if not qs or run.trace is None:
        return None
    device_s = sum(hi - lo for _, _, lo, hi in run.trace.events)
    if device_s <= 0:
        return None
    return 100.0 * sum(run.least_s[(q.template, q.value)] for q in qs) / device_s
