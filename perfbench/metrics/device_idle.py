"""device_idle (device trace), %: the share of the traced window in which
no kernel, copy or set ran on the card. Moves rows_per_s."""


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
