"""Run one cell of the benchmark of `asyrp_official_torch` on this
machine's GPU and print its result as the last line of standard output:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its
per-layer metrics from a profiled window. Every run checks what the timed
path produced against the plain reference (`portbench/reference/`) and
prints each compared number beside its limit, last on standard error and
under "checks" in the result. The run fails, and prints no result, without
a CUDA device, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "asyrp_official_tpu")


def loaded_forbidden(modules=None):
    """The top-level names among `modules` (default: the loaded ones) that
    are JAX or the JAX package, each compared as a whole name."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi unavailable)"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    # every cache of the run inside the checkout, at fixed paths (the
    # kernels' nvcc build goes to asyrp_official_torch/csrc/build/)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "portbench_cache", "triton"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    from portbench import bench, harness

    cell = bench.load(ROOT).cell(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    kind = torch.cuda.get_device_name(0)
    result = harness.run_cell(cell, seed=a.seed, seconds=a.seconds, trace=bool(a.trace),
                              t_start=T_START, device="cuda:0", kind=kind, count=cell.chips)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {bad}; the benchmark runs the PyTorch port only",
              file=sys.stderr)
        return 4
    print(f"card: {_card()}", file=sys.stderr)
    for name, x in result["checks"].items():
        print(f"check {name}: {x['value']!r} (limit {x['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
