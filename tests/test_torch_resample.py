"""The port's timestep samplers (`core/resample.py`) against the JAX
package's: the same draws from the same RandomState, the same loss
histories and importance weights, and the cross-process update on a
2-process gloo group with ragged batches against `update_with_all_losses`
of the concatenated batches."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from asyrp_official_torch.core import resample as P
from asyrp_official_tpu.core import resample as J

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["uniform", "loss-second-moment"])
def test_samplers_draw_and_update_as_the_jax_package(name):
    p, j = P.create_named_schedule_sampler(name, 20), J.create_named_schedule_sampler(name, 20)
    if name == "loss-second-moment":
        p.history_per_term = j.history_per_term = 2
        p._loss_history, j._loss_history = np.zeros((20, 2)), np.zeros((20, 2))
    rng = np.random.RandomState(0)
    for step in range(30):
        ts_p, w_p = p.sample(6, np.random.RandomState(step))
        ts_j, w_j = j.sample(6, np.random.RandomState(step))
        np.testing.assert_array_equal(ts_p, ts_j)
        np.testing.assert_array_equal(w_p, w_j)
        if name == "loss-second-moment":
            losses = rng.rand(6) * (1 + ts_p)
            p.update_with_local_losses(ts_p, losses)
            j.update_with_local_losses(ts_j, losses)
            np.testing.assert_array_equal(p._loss_history, j._loss_history)
    np.testing.assert_array_equal(p.weights(), j.weights())
    if name == "loss-second-moment":  # warmed up: the weights are no longer uniform
        assert p._warmed_up() and np.ptp(p.weights()) > 0
    with pytest.raises(NotImplementedError):
        P.create_named_schedule_sampler("nope", 4)


WORKER = r'''
import json, sys
import numpy as np
import torch.distributed as dist
from asyrp_official_torch.core.resample import LossSecondMomentResampler

port, rank, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
batches = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
s = LossSecondMomentResampler(8, history_per_term=3)
for ts, losses in batches[rank]:
    s.update_with_local_losses(ts, losses)
dist.barrier()
dist.destroy_process_group()
np.savez(out, history=s._loss_history, counts=s._loss_counts)
'''


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_update_with_local_losses_on_two_gloo_processes(tmp_path):
    rng = np.random.RandomState(1)
    # per rank, per step: (ts, losses); the ranks' batches are ragged
    sizes = [(3, 5), (4, 1), (2, 2)]
    batches = [[], []]
    for a, b in sizes:
        for rank, n in enumerate((a, b)):
            batches[rank].append((rng.randint(0, 8, n).tolist(), rng.rand(n).tolist()))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(port), str(r),
                               str(tmp_path / f"r{r}.npz"), json.dumps(batches)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out
    want = P.LossSecondMomentResampler(8, history_per_term=3)
    for step in range(len(sizes)):
        want.update_with_all_losses(
            np.concatenate([batches[r][step][0] for r in range(2)]),
            np.concatenate([batches[r][step][1] for r in range(2)]))
    for r in range(2):
        got = np.load(tmp_path / f"r{r}.npz")
        np.testing.assert_array_equal(got["history"], want._loss_history)
        np.testing.assert_array_equal(got["counts"], want._loss_counts)
