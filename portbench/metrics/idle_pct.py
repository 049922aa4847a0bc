"""idle_pct: the share of the traced window in which no operation ran on
the device (1 - the union of its busy intervals / the window), in %."""


def read(r):
    if r.window_ns <= 0 or r.busy_ns <= 0:
        return None
    return 100.0 * (1.0 - r.busy_ns / r.window_ns)
