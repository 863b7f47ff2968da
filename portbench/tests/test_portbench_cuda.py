"""On the card, at each cell's own size: a short run is correct and
reports its metrics, and the control (the reference one precision below
the cell's, put in the program's place) comes out not correct under the
cell's limits while the program comes out correct."""
import time

import pytest

from portbench import bench, harness

CELLS = [w["name"] for w in bench.load().data["workloads"]]
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def _correct(table):
    return all(x["value"] <= x["limit"] for x in table.values())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(cuda_device, workload):
    cell = bench.load().cell(workload)
    state = harness.start_cell(cell, 2 ** 31 + 77, cuda_device)
    state.request(0)
    got = state.readings()
    state.finish()
    want = state.reference("f32")
    program = harness.verdict(state.gaps(got, want), cell.limits)
    gaps = state.gaps(state.reference(CONTROL[cell.traffic["dtype"]]), want)
    # the control has no run of its own: only the numbers it reads are held
    control = harness.verdict(gaps, {k: v for k, v in cell.limits.items() if k in gaps})
    assert _correct(program), program
    assert not _correct(control), control


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_short_run(cuda_device, workload, trace):
    import torch

    cell = bench.load().cell(workload)
    # traced: one traced request, then untraced ones (which mfu reads)
    cell.traffic["trace_requests"] = 1
    result = harness.run_cell(cell, seed=2 ** 31 + 78, seconds=12.0 if trace else 1.0, trace=trace,
                              t_start=time.perf_counter(), device=cuda_device,
                              kind=torch.cuda.get_device_name(0))
    assert result["correct"] is True, result["checks"]
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) == want
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
