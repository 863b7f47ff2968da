"""DeltaBlock (DDPM++ flavor), `EditState` and `apply_edit` — the port of
the JAX `models/delta.py` for the `deltablock` edit mode.

The DeltaBlock keeps the reference's key names (conv1 / temb_proj / norm2 /
conv2), so a released Δ `.pth` block loads with `load_state_dict`. Its
GroupNorm+SiLU is kernel K1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from asyrp_official_torch.compat.from_jax import delta_block_state_dict_from_jax
from asyrp_official_torch.models import common as cm
from asyrp_official_torch.models import hostinit
from asyrp_official_torch.utils import hostrng

__all__ = ["DeltaBlock", "EditState", "apply_edit", "delta_block_init", "init_delta_blocks"]

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1, M2/M8)"


class DeltaBlock(nn.Module):
    """conv1 (1x1) → (+ temb) → GroupNorm → SiLU → conv2 (1x1) on the
    bottleneck h (JAX `delta_block_apply`, flavor 'ddpm')."""

    def __init__(self, ch: int, temb_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 1)
        self.temb_proj = nn.Linear(temb_ch, ch)
        self.norm2 = cm.GroupNorm(ch)
        self.conv2 = nn.Conv2d(ch, ch, 1)

    def forward(self, x, temb=None):
        h = cm.mat1x1(self.conv1, x)
        if temb is not None:
            h = h + cm.linear(self.temb_proj, F.silu(temb))[:, :, None, None]
        return cm.mat1x1(self.conv2, self.norm2(h, silu=True))


def delta_block_init(key: np.ndarray, ch: int, temb_ch: int, *, flavor: str = "ddpm") -> Dict[str, Any]:
    """The JAX `delta_block_init` tree (JAX layout) for a numpy key."""
    if flavor != "ddpm":
        raise NotImplementedError(f"the {flavor!r} DeltaBlock flavor {_NOT_PORTED}")
    ks = hostrng.split(key, 4)
    return {
        "conv1": hostinit.linear_init(ks[0], ch, ch),
        "temb_proj": hostinit.linear_init(ks[1], temb_ch, ch),
        "norm2": hostinit.norm_init(ch),
        "conv2": hostinit.linear_init(ks[2], ch, ch),
    }


def init_delta_blocks(seed: int, n: int, ch: int, temb_ch: int, *,
                      flavor: str = "ddpm") -> Tuple[DeltaBlock, ...]:
    """`n` DeltaBlocks, block i drawn from `hostrng.PRNGKey(seed + i)`: the
    same weights, bit for bit, as the JAX runner's `delta_block_init` for
    `--train_delta_block --get_h_num n`."""
    if n < 1:
        raise ValueError(f"need at least one DeltaBlock, got {n} (--get_h_num)")
    blocks = []
    for i in range(n):
        block = DeltaBlock(ch, temb_ch)
        block.load_state_dict(delta_block_state_dict_from_jax(
            delta_block_init(hostrng.PRNGKey(seed + i), ch, temb_ch, flavor=flavor)))
        blocks.append(block)
    return tuple(blocks)


@dataclasses.dataclass
class EditState:
    """The per-forward edit: `blocks` (DeltaBlocks), `hs_coeff` ([k+1] or
    per-sample [B, k+1]; hs_coeff[0] scales the original h), and the per-step
    gate `use_delta` (1.0 where t >= t_edit)."""

    blocks: Tuple[DeltaBlock, ...] = ()
    hs_coeff: Optional[torch.Tensor] = None
    use_delta: float = 1.0
    mode: str = "deltablock"
    flavor: str = "ddpm"
    ignore_timestep: bool = False

    def at_step(self, aux) -> "EditState":
        return dataclasses.replace(self, use_delta=aux["use_delta"])


def apply_edit(edit: EditState, h, temb):
    """The edited bottleneck h2 and the Δh used (the last block's), gated by
    `edit.use_delta`. h is NCHW."""
    if edit.mode != "deltablock":
        raise NotImplementedError(f"edit mode {edit.mode!r} {_NOT_PORTED}")
    if edit.flavor != "ddpm":
        raise NotImplementedError(f"the {edit.flavor!r} DeltaBlock flavor {_NOT_PORTED}")
    hs_coeff = edit.hs_coeff
    if hs_coeff is None:
        hs_coeff = torch.ones(len(edit.blocks) + 1)
    # coefficients arrive f32; without the cast a bf16 h would be promoted
    hs_coeff = torch.as_tensor(hs_coeff).to(device=h.device, dtype=h.dtype)
    per_sample = hs_coeff.dim() == 2
    n_coeff = hs_coeff.shape[-1]
    if n_coeff < len(edit.blocks) + 1:
        raise ValueError(f"hs_coeff needs {len(edit.blocks) + 1} entries (original h + one per "
                         f"block), got {n_coeff}")

    def c(i):
        return hs_coeff[:, i].reshape(-1, 1, 1, 1) if per_sample else hs_coeff[i]

    temb_in = None if edit.ignore_timestep else temb
    h2 = h * c(0)
    delta_h = None
    for i, block in enumerate(edit.blocks):
        delta_h = block(h, temb_in)
        h2 = h2 + delta_h * c(i + 1)
    use = float(edit.use_delta)
    return use * h2 + (1.0 - use) * h, delta_h
