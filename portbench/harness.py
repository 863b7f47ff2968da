"""One run of one cell: set-up, the measured window, the trace, the check
against the reference, and the result line.

A driver (`drivers/<name>.py`, named by the traffic file) defines
`Cell(cell, seed, device)`, whose construction is the program's set-up
(weights from the seed, inputs, warm-up of exactly the cell's shapes), and
which then gives:

  * `request(i) -> units`: the i-th request of the closed loop, returned
    once its answer is complete on the device;
  * `count() -> counting.Counter`: the work of one unit (an image) at the
    cell's shapes, counted on the meta device;
  * `readings()`: what the timed path produced that the check compares
    (the requests the window finished, or a sample of them drawn from the
    seed), read before `finish()`;
  * `finish()`: drops the program's state;
  * `reference(precision)`: the reference's answers to the same inputs,
    in `precision` ("f32" for the check; a lower one is the control);
  * `gaps(got, want) -> {name: number}`: the compared numbers;
  * `unit`, `dtype` and `tracer` (set here; its spans mark the trace).
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Dict, Optional

from portbench import bench, counting, program
from portbench.trace import Tracer, TraceSummary
from portbench.window import Window, run_window

__all__ = ["Outcome", "start_cell", "run_cell", "verdict"]


@dataclasses.dataclass
class Outcome:
    """What the metric readers read."""
    dtype: str
    unit: str
    setup_s: float
    window: Window
    counts: Optional[counting.Counter]
    trace: Optional[TraceSummary]
    traced_requests: int  # the window's first requests, which the trace covers
    traced_work: int      # units they completed


def start_cell(cell: bench.Cell, seed: int, device):
    """The driver's cell object: the program set up for `cell`."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = bench.load_module(bench.driver_path(cell.traffic),
                            "portbench_driver_" + cell.traffic["driver"])
    return drv.Cell(cell, seed=seed, device=device)


def verdict(checks: Dict[str, float], limits: dict) -> Dict[str, Dict[str, float]]:
    """Each compared number (those the cell's limits file names) beside
    its limit."""
    return {k: {"value": checks[k], "limit": v["limit"]} for k, v in limits.items()
            if isinstance(v, dict) and "limit" in v}


def _correct(table: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(x["value"]) and x["value"] <= x["limit"] for x in table.values())


def run_cell(cell: bench.Cell, *, seed: int, seconds: float, trace: bool, t_start: float,
             device, kind: str = "cpu", count: int = 1) -> dict:
    """The result line's object for one run."""
    state = start_cell(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    tracer = Tracer(trace)
    state.tracer = tracer
    n_traced, traced_work = cell.traffic["trace_requests"], [0]

    def request(i: int) -> int:
        units = state.request(i)
        if i < n_traced:
            traced_work[0] += units
            if i + 1 == n_traced:
                tracer.stop()
        return units

    tracer.start()
    win = run_window(request, seconds)
    program.sync(device)
    tracer.stop()
    peak = program.peak_bytes(device)
    summary = tracer.summary()
    counts = state.count() if trace else None
    got = state.readings()
    state.finish()
    table = verdict(state.gaps(got, state.reference("f32")), cell.limits)
    t, parts = t_start, []
    for name, at in getattr(state, "marks", []):
        parts.append(f"{name} {at - t:.3f}")
        t = at
    print(f"portbench: setup {setup_s:.3f} s ({', '.join(parts)}); window {win.seconds:.3f} s, "
          f"{win.requests} requests of {[round(x, 4) for x in win.request_s]} s", file=sys.stderr)

    out = Outcome(state.dtype, state.unit, setup_s, win, counts, summary,
                  min(n_traced, win.requests) if trace else 0, traced_work[0])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        path = bench.reader_path(m["name"])
        if path is None:
            raise FileNotFoundError(f"no reader for metric {m['name']!r} under metrics/")
        value = bench.load_module(path, "portbench_metric_" + m["name"].replace(".", "_")).read(out)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": _correct(table), "attempted": win.requests, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
                         "count": count, "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                               "idle_gaps": [list(x) for x in summary.idle_gaps]}
    result["checks"] = table
    return result
