"""The readings that a cell's limits are set from, at the cell's own size,
on the card:

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 [--control-seeds 3]

For each seed, in one process: the program set up as a run sets it up,
one request of the cell's own size (the check's sample is then drawn from
its images), and the compared numbers of the program against the f32
reference (the lower readings). For the first `--control-seeds` seeds
also the control: the reference computed one precision below the cell's
(TF32 operands for an f32 cell, fp8 for a bf16 one) put in the program's
place, against the f32 reference (the upper readings). One JSON line per
seed on standard output.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import bench, harness, program

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = bench.load(ROOT).cell(a.workload)
    for i, seed in enumerate(a.seeds):
        t0 = time.perf_counter()
        state = harness.start_cell(cell, seed, "cuda:0")
        t1 = time.perf_counter()
        state.request(0)
        program.sync("cuda:0")
        t2 = time.perf_counter()
        got = state.readings()
        state.finish()
        want = state.reference("f32")
        t3 = time.perf_counter()
        row = {"workload": a.workload, "seed": seed, "setup_s": t1 - t0,
               "request_s": t2 - t1, "reference_s": t3 - t2,
               "program": state.gaps(got, want)}
        if i < a.control_seeds:
            ctrl = CONTROL[cell.traffic["dtype"]]
            row["control"] = {"precision": ctrl,
                              "gaps": state.gaps(state.reference(ctrl), want)}
        print(json.dumps(row), flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
