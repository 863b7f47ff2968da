"""Trajectory loop — the port of the JAX `core/sampler.py` `sample_chain`
as a Python loop over a `StepTable` (the JAX package's one `lax.scan`).

Model callback contract (as in the JAX package):

    eps_fn(x, t, aux) -> (eps_raw, eps_mod_raw | None[, extras])

`x` is the [B, H, W, C] NHWC carry, `t` a [B] float32 timestep tensor and
`aux` holds the step's `use_delta` (float), `delta_idx` (int, the row of a
stacked Δh) and `step` (the step's index in the table). A name in
`collect` that the step's `extras` dict holds (the edited eps function's
"delta_h") is stacked like "x" and "x0_t".

`learn_sigma`: the raw outputs carry 2C channels, split on the NHWC last
axis; eps (and eps_mod) are the first C, as strided views that the step
kernels read in place, the learned log-variance the last C.

`sample_type`: "ddim" takes the asymmetric DDIM step (kernel K3), "ddpm" the
ancestral step (`ops/ddpm_step.py`) from eps, with the learned log-variance
under `learn_sigma`, else the schedule's per-timestep one.

Noise: a step draws a standard normal of x's shape from `generator` (a
`torch.Generator` on x's device), in step order, where eta != 0 and at every
step of a "ddpm" chain (as the JAX sampler draws); the other steps draw
nothing. `noise_fn(step, shape)` replaces the generator, so a test can feed
both packages the same draws.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from asyrp_official_torch.ops import ddim_step as k3, ddpm_step as kddpm
from asyrp_official_torch.core.schedule import Schedule
from asyrp_official_torch.core.steptable import StepTable
from asyrp_official_torch.utils import profiling as prof

__all__ = ["sample_chain"]


def sample_chain(
    eps_fn: Callable,
    schedule: Schedule,
    table: StepTable,
    x_init: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    sample_type: str = "ddim",
    learn_sigma: bool = False,
    dt_lambda: float = 1.0,
    dt_end: int = 999,
    collect: Tuple[str, ...] = (),
    noise_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the trajectory; returns (x_final, {name: [S, B, ...]}) for each
    of "x", "x0_t" and the eps function's extras in `collect`."""
    if sample_type not in ("ddim", "ddpm"):
        raise ValueError(f"unknown sample_type: {sample_type}")
    stochastic = (np.asarray(table.eta) != 0.0) | (sample_type == "ddpm")
    if stochastic.any() and generator is None and noise_fn is None:
        raise ValueError("a generator (or noise_fn) is required when any step is stochastic")
    dev, bsz = x_init.device, x_init.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    acp = np.asarray(schedule.alphas_cumprod_ext)
    # per-step scalars go to the device once, not once per step
    ts = torch.as_tensor(np.asarray(table.t, np.float32), **f32)
    at = torch.as_tensor(acp[np.asarray(table.t) + 1], **f32)
    at_next = torch.as_tensor(acp[np.asarray(table.t_next) + 1], **f32)
    eta = torch.as_tensor(np.asarray(table.eta, np.float32), **f32)
    if sample_type == "ddpm":
        t_idx = np.asarray(table.t)
        beta = torch.as_tensor(np.asarray(schedule.betas)[t_idx], **f32)
        logvar_tab = torch.as_tensor(np.asarray(schedule.logvar)[t_idx], **f32)
    use_dt = None
    if dt_lambda != 1.0:
        use_dt = torch.as_tensor((np.asarray(table.t) >= dt_end).astype(np.float32), **f32)

    def step(i, x):
        """Step i from state x: the eval, the noise, the step kernel."""
        aux = {"use_delta": float(table.use_delta[i]), "delta_idx": int(table.delta_idx[i]),
               "step": i}
        out = eps_fn(x, ts[i].expand(bsz), aux)
        eps, eps_mod = out[:2]
        extras = out[2] if len(out) > 2 else {}
        if learn_sigma:
            c = eps.shape[-1] // 2
            eps, logvar = eps[..., :c], eps[..., c:]
            eps_mod = None if eps_mod is None else eps_mod[..., :c]
        if eps_mod is None:
            eps_mod = eps
        noise = None
        if stochastic[i]:
            if noise_fn is not None:
                noise = torch.as_tensor(noise_fn(i, tuple(x.shape))).to(device=dev, dtype=x.dtype)
            else:
                noise = torch.randn(x.shape, generator=generator, device=dev, dtype=x.dtype)
        x0_t = None
        if sample_type == "ddim":
            x, x0_t = k3.ddim_step(
                x, eps, eps_mod, at[i:i + 1], at_next[i:i + 1], eta[i:i + 1], noise,
                dt_lambda=dt_lambda, apply_dt=None if use_dt is None else use_dt[i:i + 1],
            )
        else:  # the ancestral step reads eps, not eps_mod, as the JAX sampler does
            if "x0_t" in ys:
                x0_t = (x.float() - eps.float() * torch.sqrt(1.0 - at[i])) / torch.sqrt(at[i])
            x = kddpm.ddpm_step(x, eps, logvar if learn_sigma else logvar_tab[i:i + 1],
                                beta[i:i + 1], at[i:i + 1], ts[i:i + 1], noise)
        return x, x0_t, extras

    x = x_init
    ys = {k: [] for k in collect}
    with prof.span(prof.CHAIN):
        for i in range(table.num_steps):
            with prof.span(prof.STEP):
                x, x0_t, extras = step(i, x)
            if "x" in ys:
                ys["x"].append(x)
            if "x0_t" in ys:
                ys["x0_t"].append(x0_t)
            for k in extras:
                if k in ys:
                    ys[k].append(extras[k])
    return x, {k: torch.stack(v) for k, v in ys.items() if v}
