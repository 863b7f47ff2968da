"""LPIPS with the AlexNet backbone — the port of the JAX package's
`losses/lpips_jax.py`: the perceptual metric of the interval-calibration
stage (`--lpips`) and of the fidelity gate (`--run_fidelity`).

The `lpips` package's pipeline: the ScalingLayer, torchvision AlexNet's
`features` with a tap after each of its five ReLUs, unit-normalisation over
channels, the squared difference times the per-channel lin weight, a channel
sum, a spatial mean, and the sum over the taps. Inputs are NCHW in [-1, 1].

The convolutions go to cuDNN (`F.conv2d`); the head is plain torch. Weights
come from the `--lpips_ckpt` npz (the JAX tree of `params_from_torch`),
bridged by `compat.from_jax.lpips_state_dict_from_jax`; random weights are a
plumbing check, not a calibrated metric.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LPIPS", "ALEX_CONVS", "ALEX_TAPS", "params_from_torch"]

# (cout, kernel, stride, pad) per conv; a tap after each ReLU
ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
ALEX_TAPS = 5
# the lpips ScalingLayer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """`forward(x0, x1)` → [B] distances; `taps(x)` → the unit-normalised
    AlexNet taps of one side, which `distance(taps0, x1)` reuses (one side's
    taps computed once for many comparisons give the same values)."""

    def __init__(self):
        super().__init__()
        cin, convs, lins = 3, [], []
        for cout, k, s, p in ALEX_CONVS:
            convs.append(nn.Conv2d(cin, cout, k, stride=s, padding=p))
            lins.append(nn.Parameter(torch.zeros(cout)))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList(lins)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = (x - self.shift) / self.scale
        out = []
        for i, conv in enumerate(self.convs):
            h = F.relu(conv(h))
            # eps added to the norm, not inside the square root
            out.append(h / (torch.linalg.vector_norm(h, dim=1, keepdim=True) + 1e-10))
            if i in (0, 1):
                h = F.max_pool2d(h, 3, 2)
        return out

    def distance(self, taps0: List[torch.Tensor], x1: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for lin, f0, f1 in zip(self.lins, taps0, self.taps(x1)):
            d = (f0 - f1).square() * lin.view(1, -1, 1, 1)
            total = total + d.sum(dim=1).mean(dim=(1, 2))
        return total

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        return self.distance(self.taps(x0), x1)


def params_from_torch(alex_sd: Dict[str, np.ndarray], lin_sd: Dict[str, np.ndarray]):
    """alex_sd: torchvision AlexNet `features` state dict (features.{0,3,6,8,10});
    lin_sd: the lpips lin heads (lin{i}.model.1.weight [1, C, 1, 1]) → the
    JAX-layout tree that `--lpips_ckpt` stores (HWIO convs, [C] lins)."""
    idx = [0, 3, 6, 8, 10]
    convs = [
        {
            "w": np.transpose(np.asarray(alex_sd[f"features.{j}.weight"], np.float32), (2, 3, 1, 0)),
            "b": np.asarray(alex_sd[f"features.{j}.bias"], np.float32),
        }
        for j in idx
    ]
    lins = [
        {"w": np.asarray(lin_sd[f"lin{i}.model.1.weight"], np.float32)[0, :, 0, 0]}
        for i in range(ALEX_TAPS)
    ]
    return {"convs": convs, "lins": lins}
