"""Timestep schedule samplers for VLB/MSE training — the port's copy of the
JAX package's `core/resample.py` (numpy host state; `tests/test_torch_boundary.py`
holds it equal to the original): `UniformSampler` and the importance
sampler `LossSecondMomentResampler`.

`update_with_local_losses` exchanges the per-sample losses of every
process with `torch.distributed.all_gather` when a process group of more
than one process is initialized, and updates locally otherwise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "create_named_schedule_sampler",
    "UniformSampler",
    "LossSecondMomentResampler",
]


def create_named_schedule_sampler(name: str, num_timesteps: int):
    """resample.py:8-20."""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class _ScheduleSampler:
    """sample(): importance-sample timesteps and the 1/(N·p) loss
    reweighting that keeps the objective unbiased (resample.py:42-58)."""

    num_timesteps: int

    def weights(self) -> np.ndarray:
        raise NotImplementedError

    def sample(
        self, batch_size: int, rng: np.random.RandomState
    ) -> Tuple[np.ndarray, np.ndarray]:
        w = self.weights()
        p = w / np.sum(w)
        indices = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[indices])
        return indices.astype(np.int64), weights.astype(np.float32)


class UniformSampler(_ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps
        self._weights = np.ones([num_timesteps], np.float64)

    def weights(self) -> np.ndarray:
        return self._weights


class LossSecondMomentResampler(_ScheduleSampler):
    """Importance-sample t ∝ sqrt(E[loss²]) over a rolling per-timestep
    history, with a uniform floor; uniform until every term has a full
    history (resample.py:124-153)."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros(
            [num_timesteps, history_per_term], np.float64
        )
        self._loss_counts = np.zeros([num_timesteps], np.int64)

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones([self.num_timesteps], np.float64)
        w = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        w /= np.sum(w)
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_all_losses(self, ts, losses) -> None:
        for t, loss in zip(ts, losses):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def update_with_local_losses(self, local_ts, local_losses) -> None:
        """Every process sees every process's losses, so the histories stay
        identical. Batch sizes are gathered first and each batch padded to
        the largest: `all_gather` needs one shape per process, and the last
        step of an epoch can leave processes with ragged batches."""
        import torch
        import torch.distributed as dist

        local_ts = np.asarray(local_ts, np.int64).reshape(-1)
        local_losses = np.asarray(local_losses, np.float64).reshape(-1)
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            self.update_with_all_losses(local_ts, local_losses)
            return
        world = dist.get_world_size()
        # the backend's device: the CPU for gloo, the process's card for nccl
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        sizes = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(world)]
        dist.all_gather(sizes, torch.tensor([local_ts.shape[0]], dtype=torch.int64, device=dev))
        batch_sizes = [int(s.item()) for s in sizes]
        pad = max(batch_sizes) - local_ts.shape[0]

        def gather(a, dtype):
            out = [torch.zeros(max(batch_sizes), dtype=dtype, device=dev) for _ in range(world)]
            dist.all_gather(out, torch.as_tensor(np.pad(a, (0, pad)), dtype=dtype, device=dev))
            return [o.cpu().numpy() for o in out]

        ts_all = gather(local_ts, torch.int64)
        losses_all = gather(local_losses, torch.float64)
        ts = np.concatenate([ts_all[p][: batch_sizes[p]] for p in range(world)])
        losses = np.concatenate([losses_all[p][: batch_sizes[p]] for p in range(world)])
        self.update_with_all_losses(ts, losses)

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())
