"""Arithmetic shared by the metric readers of `metrics/`."""
from __future__ import annotations

__all__ = ["roofline_share", "kernels_per"]


def roofline_share(run, kinds, families):
    """A family of kernels' share of its roofline, in %: the sum of each
    counted call's bound (`counting.bound_s`) times the units the traced
    requests completed, over the families' kernel time in the trace. None where the
    trace holds no such kernel or the count no such call."""
    t, c = run.trace, run.counts
    if t is None or c is None:
        return None
    spent = sum(t.family_s.get(f, 0.0) for f in families)
    if spent <= 0.0 or c.n_calls(kinds) == 0:
        return None
    return 100.0 * c.bound_s(kinds, run.dtype) * run.traced_work / spent


def kernels_per(run, unit):
    """The profiler's count of device kernels in the trace over the units
    the traced requests completed, where the cell's unit is `unit`."""
    t = run.trace
    if t is None or run.unit != unit or run.traced_work <= 0:
        return None
    return t.n_kernels / run.traced_work
