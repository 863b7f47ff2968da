"""device_ms_per_image: milliseconds in which an operation ran on the
device (the union of the device's intervals, from the profiler) per image
of the traced requests. The device's work, without the host's share, so
steadier than the window's time per image where the host is shared."""


def read(run):
    t = run.trace
    if t is None or run.unit != "image" or run.traced_work <= 0:
        return None
    return 1e3 * t.busy_s / run.traced_work
