"""At a tiny width on the CPU, each cell's control (the reference one
precision below the cell's, put in the program's place) reads at least
three times what the program reads on one of the cell's compared
numbers. At the cells' own sizes on the card, `test_portbench_cuda.py`
holds the control to the cells' limits."""
import pytest

from portbench import harness
from portbench.tests.tiny import cells, tiny_cell

CELLS = cells()
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_above_the_program(workload):
    cell = tiny_cell(workload, steps=12, batch=2)
    state = harness.start_cell(cell, 21, "cpu")
    state.request(0)
    got = state.readings()
    state.finish()
    want = state.reference("f32")
    program = state.gaps(got, want)
    control = state.gaps(state.reference(CONTROL[cell.traffic["dtype"]]), want)
    compared = [k for k in control if k in cell.limits]
    assert any(control[k] > 3 * program[k] for k in compared), (program, control)
