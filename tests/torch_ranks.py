"""Run a worker script on N gloo ranks on the CPU, one process each.

Each rank runs `PROLOGUE + code` as `python -c` with its rank on the
command line: one torch thread (the suite runs several pytest workers on a
few cores), a gloo process group over localhost, and `ARGS` (the caller's
extra arguments). The ranks share one time limit: a deadlocked collective
kills them all and fails the one test, not the suite."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROLOGUE = r'''
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
PORT, RANK, WORLD = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
ARGS = sys.argv[4:]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}", world_size=WORLD,
                        rank=RANK)
'''
EPILOGUE = r'''
dist.barrier()
dist.destroy_process_group()
'''


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(code: str, world: int, args: Sequence[str] = (), timeout: float = 180.0,
              cwd: str = None) -> None:
    """Run `code` on `world` ranks; raises with the failing ranks' output if
    any rank exits non-zero or the ranks outlive `timeout` seconds."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, "-c", PROLOGUE + code + EPILOGUE, str(port),
                               str(r), str(world), *map(str, args)], env=env, cwd=cwd,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{world} ranks did not finish within {timeout:.0f} s")
    bad = [(r, p.returncode, out) for r, (p, out) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    if bad:
        raise AssertionError("\n".join(f"rank {r} exited {rc}:\n{out[-4000:]}"
                                       for r, rc, out in bad))
