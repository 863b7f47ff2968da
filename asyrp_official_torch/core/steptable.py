"""Static step tables — the port's copy of the JAX package's
`core/steptable.py`. Each trajectory step's control flow (edit injected
where t >= t_edit, eta = 1 below t_addnoise, which Δ row) is a host-built
array indexed by the step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from asyrp_official_torch.core.schedule import prev_seq

__all__ = ["StepTable", "generation_table", "inversion_table"]


@dataclasses.dataclass(frozen=True)
class StepTable:
    """t[i] / t_next[i]: integer timesteps of step i (t_next may be -1);
    eta[i]: stochasticity (1.0 inside the noise window); use_delta[i]: 1.0
    where the edit is injected; delta_idx[i]: row into a stacked [K, ...]
    Δh parameter."""

    t: np.ndarray
    t_next: np.ndarray
    eta: np.ndarray
    use_delta: np.ndarray
    delta_idx: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.t.shape[0])

    def edit_prefix_len(self) -> Optional[int]:
        """Length of the leading use_delta == 1 run, or None if the mask is
        not a contiguous prefix."""
        use = np.asarray(self.use_delta)
        k = int(use.sum())
        if np.all(use[:k] == 1.0) and np.all(use[k:] == 0.0):
            return k
        return None


def _delta_index_map(
    ts: Sequence[int],
    delta_times: Optional[Sequence[int]],
    ignore_timesteps: bool,
) -> np.ndarray:
    if delta_times is None or ignore_timesteps:
        return np.zeros((len(ts),), np.int32)
    lookup = {int(t): i for i, t in enumerate(delta_times)}
    return np.array([lookup.get(int(t), 0) for t in ts], np.int32)


def generation_table(
    seq: Sequence[int],
    *,
    t_edit: int = 0,
    t_addnoise: int = -1,
    delta_times: Optional[Sequence[int]] = None,
    ignore_timesteps: bool = False,
    eta_base: float = 0.0,
) -> StepTable:
    """Reverse-process table over `reversed(seq)` pairs. `t_addnoise = -1`
    disables the noise window; `eta_base` is the eta outside it."""
    seq = list(seq)
    nxt = prev_seq(seq)
    ts = list(reversed(seq))
    tn = list(reversed(nxt))
    eta = np.array([1.0 if t < t_addnoise else eta_base for t in ts], np.float32)
    use_delta = np.array([1.0 if t >= t_edit else 0.0 for t in ts], np.float32)
    if delta_times is not None and not ignore_timesteps:
        # a step with no Δ row gets no injection
        have = {int(t) for t in delta_times}
        use_delta *= np.array([1.0 if int(t) in have else 0.0 for t in ts], np.float32)
    return StepTable(
        t=np.array(ts, np.int32),
        t_next=np.array(tn, np.int32),
        eta=eta,
        use_delta=use_delta,
        delta_idx=_delta_index_map(ts, delta_times, ignore_timesteps),
    )


def inversion_table(seq: Sequence[int]) -> StepTable:
    """DDIM-inversion table: ascending (t, t_next) = (seq[k], seq[k+1])
    pairs, eta 0, no edit."""
    seq = list(seq)
    ts = seq[:-1]
    tn = seq[1:]
    n = len(ts)
    return StepTable(
        t=np.array(ts, np.int32),
        t_next=np.array(tn, np.int32),
        eta=np.zeros((n,), np.float32),
        use_delta=np.zeros((n,), np.float32),
        delta_idx=np.zeros((n,), np.int32),
    )
