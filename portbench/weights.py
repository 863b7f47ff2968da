"""Weights and inputs made from the seed, on the device.

Each purpose (the UNet, the DeltaBlock, the images, the noise) draws
from a `torch.Generator` of its own on the run's device, seeded from the
run's seed and the purpose, so that a later draw never depends on an
earlier one and the reference can make the same weights again. A state
dict is drawn in one call: one standard normal vector for all its
parameters, then every parameter a view of it, scaled in place by
`torch._foreach_mul_` and shifted by `torch._foreach_add_`.

Scales: a weight of two or more dims N(0, 1/fan_in), but the last
convolution of each residual branch (a resblock's `conv2` or
`out_layers.3`, an attention block's `proj_out`, the DeltaBlock's output)
a tenth of that; a bias 0.1 N(0, 1); a norm's weight 1 + 0.1 N(0, 1).
No parameter is zero: improved-diffusion initialises exactly those branch
outputs (and the output conv) to zero, which would give eps = 0 and an
edit that compares nothing. Small branch outputs keep the network near
the identity on its residual stream, as trained UNets are: with every
branch at full scale a random UNet's eps is so sensitive to its input that
the 99-eval chain amplifies rounding until f32, bf16 and fp8 runs of the
same chain all disagree by the image's own size, and no comparison could
tell a lower precision from the stated one.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

__all__ = ["generator", "draw_state", "uniform_images", "normals"]

_PURPOSES = {"unet": 1, "delta": 2, "images": 4, "latents": 5, "noise": 6}


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A generator on `device` for one purpose of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + _PURPOSES[purpose]) % (2 ** 63))
    return g


def _scale(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(std, mean) of the parameter `name`."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) >= 2:
        branch_out = leaf == "weight" and name.rsplit(".", 2)[-2] in ("conv2", "3", "proj_out")
        return math.prod(shape[1:]) ** -0.5 * (0.1 if branch_out else 1.0), 0.0
    if leaf == "weight":  # GroupNorm / LayerNorm
        return 0.1, 1.0
    return 0.1, 0.0


def draw_state(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, purpose: str,
               device) -> Dict[str, torch.Tensor]:
    """A float32 state dict {name: tensor of shape} drawn from the seed."""
    shapes = [(n, tuple(int(s) for s in shp)) for n, shp in shapes]
    sizes = [math.prod(shp) for _, shp in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, purpose, device), device=device)
    views = [v.view(shp) for v, (_, shp) in zip(flat.split(sizes), shapes)]
    stds, means = zip(*(_scale(n, shp) for n, shp in shapes))
    torch._foreach_mul_(views, list(stds))
    torch._foreach_add_(views, list(means))
    return {n: v for (n, _), v in zip(shapes, views)}


def uniform_images(shape, seed: int, device) -> torch.Tensor:
    """Images in [-1, 1] (float32) drawn from the seed."""
    x = torch.rand(shape, generator=generator(seed, "images", device), device=device)
    return x.mul_(2.0).sub_(1.0)


def normals(shape, seed: int, purpose: str, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator(seed, purpose, device), device=device)
