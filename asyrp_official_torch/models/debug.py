"""Shape debugging — the port of the JAX package's `models/debug.py` (the
reference's `forward_layer_check` printed every tensor shape, then dropped
into pdb): the shape at each boundary of a UNet's forward, for any
family and config, from a forward of fake tensors (`FakeTensorMode`: CPU
tensors whose storage is on the meta device, so no memory and no FLOPs; the
kernels' wrappers take their plain versions for them, which compute only
shapes there).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

__all__ = ["forward_shape_report"]


def forward_shape_report(spec, batch: int = 1) -> List[Tuple[str, tuple]]:
    """(stage, shape) rows of one forward of `spec`'s UNet, also printed.
    Shapes are NCHW, the UNets' layout inside (`apply` itself takes and
    returns NHWC; the JAX package reports NHWC throughout)."""
    cfg = spec.config
    res = cfg.resolution if spec.family == "ddpmpp" else cfg.image_size
    cin = cfg.in_channels
    rows: List[Tuple[str, tuple]] = [("input", (batch, cin, res, res))]
    with FakeTensorMode(), torch.no_grad():
        model = spec.build()
        rows.append(("params (count)", (sum(p.numel() for p in model.parameters()),)))
        eps, _, _, mid = spec.apply(model, torch.empty(batch, res, res, cin), torch.empty(batch))
    rows.append(("middle_h (h-space)", tuple(mid.permute(0, 3, 1, 2).shape)))
    rows.append(("eps output", tuple(eps.permute(0, 3, 1, 2).shape)))
    for name, shape in rows:
        print(f"{name:24s} {shape}")
    return rows
