"""idle_pct: the share of the traced span (whole requests), gaps between
requests included, in which no operation ran on the device (the union of the
device's intervals, from the profiler)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
