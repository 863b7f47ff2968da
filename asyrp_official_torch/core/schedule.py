"""Diffusion noise schedules and skip-step grids — the port's copy of the
JAX package's `core/schedule.py` (pure numpy; the functions the port calls,
under the same names; `tests/test_torch_boundary.py` holds them equal to
the originals).

  * betas are built in float64 then truncated to float32;
  * `alphas_cumprod` is the float32 cumulative product of (1 - betas_f32);
  * the posterior log-variance table is computed in float64;
  * skip grids truncate `linspace(0, 1, n) * t_0` with `int(s + 1e-6)`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "Schedule",
    "linear_beta_schedule",
    "make_schedule",
    "uniform_seq",
    "prev_seq",
    "train_seq",
]


def linear_beta_schedule(
    beta_start: float, beta_end: float, num_diffusion_timesteps: int
) -> np.ndarray:
    """Linear beta schedule in float64."""
    return np.linspace(beta_start, beta_end, num_diffusion_timesteps, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Immutable host-side schedule tables.

    betas: float32 [T]; alphas_cumprod: float32 [T]; alphas_cumprod_ext:
    float32 [T+1] = [1.0, alphas_cumprod...], so that a lookup at `t + 1`
    reads alpha = 1 for `t_next == -1`; logvar: float32 [T] posterior
    log-variance; num_timesteps: T.
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_ext: np.ndarray
    logvar: np.ndarray
    num_timesteps: int

    @property
    def T(self) -> int:  # noqa: N802 — conventional diffusion notation
        return self.num_timesteps


def make_schedule(
    *,
    num_timesteps: int = 1000,
    beta_start: float = 1e-4,
    beta_end: float = 0.02,
    var_type: str = "fixedsmall",
) -> Schedule:
    betas64 = linear_beta_schedule(beta_start, beta_end, num_timesteps)
    betas32 = betas64.astype(np.float32)
    acp32 = np.cumprod((1.0 - betas32).astype(np.float32), dtype=np.float32)

    alphas64 = 1.0 - betas64
    acp64 = np.cumprod(alphas64, axis=0)
    acp64_prev = np.append(1.0, acp64[:-1])
    posterior_variance = betas64 * (1.0 - acp64_prev) / (1.0 - acp64)
    if var_type == "fixedlarge":
        logvar = np.log(np.append(posterior_variance[1], betas64[1:]))
    elif var_type == "fixedsmall":
        logvar = np.log(np.maximum(posterior_variance, 1e-20))
    else:
        raise ValueError(f"unknown var_type: {var_type}")

    return Schedule(
        betas=betas32,
        alphas_cumprod=acp32,
        alphas_cumprod_ext=np.concatenate([np.ones((1,), np.float32), acp32]).astype(np.float32),
        logvar=logvar.astype(np.float32),
        num_timesteps=num_timesteps,
    )


def uniform_seq(n_steps: int, t_0: int) -> List[int]:
    """Uniform skip grid: `int(s+1e-6) for s in linspace(0,1,n)*t_0`."""
    if n_steps == 0:
        raise ValueError("n_steps == 0 means 'no skip'; build range(t_edit, t_0) instead")
    seq = np.linspace(0, 1, n_steps) * t_0
    return [int(s + 1e-6) for s in seq]


def prev_seq(seq: Sequence[int]) -> List[int]:
    """The `[-1] + seq[:-1]` companion grid."""
    return [-1] + list(seq[:-1])


def train_seq(n_train_step: int, t_0: int, t_edit: int) -> Tuple[List[int], List[int]]:
    """Training grid: the uniform grid filtered to `>= t_edit`. Returns
    (seq_train, seq_train_next)."""
    if n_train_step != 0:
        seq = np.linspace(0, 1, n_train_step) * t_0
        seq = seq[seq >= t_edit]
        seq = [int(s + 1e-6) for s in seq]
    else:
        seq = list(range(t_edit, t_0))
    return seq, prev_seq(seq)
