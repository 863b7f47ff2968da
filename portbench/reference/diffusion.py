"""Asyrp's chains over the reference UNets (Kwon et al., "Diffusion Models
Already Have a Semantic Latent Space", ICLR 2023; the official code's
`diffusion_latent.py`):

  * the linear beta schedule, float64 then float32, and its float32
    cumulative product;
  * the uniform skip grid `int(s + 1e-6) for s in linspace(0, 1, n) t_0`;
  * DDIM inversion x0 -> x_T (eta 0) and the asymmetric edited generation
    x_T -> x0: where t >= t_edit the UNet decodes twice, eps from h and
    eps_mod from h + Δh (DeltaBlock, coefficients 1 and 1), x0_t from
    eps_mod and the direction from eps; eta = 1 noise where t < t_addnoise.

Images are NHWC [B, H, W, 3] in and out, as the program takes them; the
UNets run NCHW.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["alphas_cumprod", "uniform_seq", "inversion_steps", "generation_steps", "alpha",
           "ddim_step", "eps_at", "invert_edit"]


def alphas_cumprod(beta_start: float, beta_end: float, n: int) -> np.ndarray:
    betas = np.linspace(beta_start, beta_end, n, dtype=np.float64).astype(np.float32)
    return np.cumprod((1.0 - betas).astype(np.float32), dtype=np.float32)


def uniform_seq(n_steps: int, t_0: int) -> List[int]:
    return [int(s + 1e-6) for s in np.linspace(0, 1, n_steps) * t_0]


def inversion_steps(seq: Sequence[int]):
    """(t, t_next) ascending."""
    return list(zip(seq[:-1], seq[1:]))


def generation_steps(seq: Sequence[int]):
    """(t, t_next) descending; the last goes to t_next = -1 (alpha 1)."""
    seq = list(seq)
    return list(zip(reversed(seq), reversed([-1] + seq[:-1])))


def alpha(acp: np.ndarray, t: int, device) -> torch.Tensor:
    return torch.tensor(1.0 if t < 0 else float(acp[t]), dtype=torch.float32, device=device)


def ddim_step(x, eps, eps_mod, a, a_next, eta: float, noise=None):
    """(x_next, x0_t): x0_t = (x - sqrt(1 - a) eps_mod) / sqrt(a); x_next =
    sqrt(a') x0_t + c2 eps + c1 noise, c1 = eta sqrt((1 - a/a')(1 - a') /
    (1 - a)), c2 = sqrt(1 - a' - c1^2)."""
    x0_t = (x - eps_mod * torch.sqrt(1.0 - a)) / torch.sqrt(a)
    c1 = eta * torch.sqrt(torch.clamp((1.0 - a / a_next) * (1.0 - a_next) / (1.0 - a), min=0.0))
    c2 = torch.sqrt(torch.clamp(1.0 - a_next - c1 * c1, min=0.0))
    x_next = torch.sqrt(a_next) * x0_t + c2 * eps
    if noise is not None:
        x_next = x_next + c1 * noise
    return x_next, x0_t


def _nchw(x):
    # contiguous: some of the CPU's channels-last backward kernels fault
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def eps_at(unet, x_nhwc, t: int, block: Optional[Dict] = None):
    """(eps, eps_mod) NHWC, the first 3 channels of a learn_sigma output;
    eps_mod only with a block."""
    tt = torch.full((x_nhwc.shape[0],), float(t), device=x_nhwc.device)
    h, hs, temb = unet.encode(_nchw(x_nhwc), tt)
    eps = _nhwc(unet.decode(h, hs, temb))[..., :3]
    if block is None:
        return eps, None
    h2 = h + unet.delta(h, temb, block)
    return eps, _nhwc(unet.decode(h2, hs, temb))[..., :3]


def invert_edit(unet, block, acp, x0, *, n_inv_step: int, n_test_step: int, t_0: int,
                t_edit: int, t_addnoise: int, noise: Callable[[int], torch.Tensor]):
    """One request: DDIM inversion over `n_inv_step`, then the edited
    generation over `n_test_step`; `noise(k)` is the eta noise of the k-th
    generation step that draws one (t < t_addnoise)."""
    dev = x0.device
    x = x0
    with torch.no_grad():
        for t, tn in inversion_steps(uniform_seq(n_inv_step, t_0)):
            eps, _ = eps_at(unet, x, t)
            x, _ = ddim_step(x, eps, eps, alpha(acp, t, dev), alpha(acp, tn, dev), 0.0)
        k = 0
        for t, tn in generation_steps(uniform_seq(n_test_step, t_0)):
            eps, eps_mod = eps_at(unet, x, t, block if t >= t_edit else None)
            stochastic = t < t_addnoise
            x, _ = ddim_step(x, eps, eps if eps_mod is None else eps_mod, alpha(acp, t, dev),
                             alpha(acp, tn, dev), 1.0 if stochastic else 0.0,
                             noise(k) if stochastic else None)
            k += int(stochastic)
    return x

