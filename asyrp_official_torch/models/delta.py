"""DeltaBlocks (DDPM++ and OpenAI flavors), `EditState` and `apply_edit` —
the port of the JAX `models/delta.py` for the `deltablock` edit mode.

Each DeltaBlock keeps the reference's key names (DDPM++: conv1 / temb_proj /
norm2 / conv2; OpenAI: in_layers.{0,2} / emb_layers.1 / out_layers.{0,3}),
so a released Δ `.pth` block loads with `load_state_dict`. Its
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

__all__ = ["DeltaBlock", "OpenAIDeltaBlock", "EditState", "apply_edit", "delta_block_init",
           "delta_block_from_tree", "init_delta_blocks"]

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1, M2)"


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
        t = None if temb is None else cm.linear(self.temb_proj, F.silu(temb))
        return cm.mat1x1(self.conv2, self.norm2(h, silu=True, pre_add=t))


class OpenAIDeltaBlock(nn.Module):
    """GN32+SiLU → 1x1 → (+ emb) → GN32+SiLU → 1x1 on the bottleneck h (JAX
    `delta_block_apply`, flavor 'openai'; the reference's ResBlock layout
    without scale-shift). The parameterless slots keep the reference's key
    indices."""

    def __init__(self, ch: int, temb_ch: int):
        super().__init__()
        self.in_layers = nn.ModuleList([cm.GroupNorm(ch, eps=1e-5), nn.Identity(),
                                        nn.Conv2d(ch, ch, 1)])
        self.emb_layers = nn.ModuleList([nn.Identity(), nn.Linear(temb_ch, ch)])
        self.out_layers = nn.ModuleList([cm.GroupNorm(ch, eps=1e-5), nn.Identity(),
                                         nn.Identity(), nn.Conv2d(ch, ch, 1)])

    def forward(self, x, temb=None):
        h = cm.mat1x1(self.in_layers[2], self.in_layers[0](x, silu=True))
        t = None if temb is None else cm.linear(self.emb_layers[1], F.silu(temb))
        return cm.mat1x1(self.out_layers[3], self.out_layers[0](h, silu=True, pre_add=t))


_BLOCKS = {"ddpm": DeltaBlock, "openai": OpenAIDeltaBlock}


def delta_block_init(key: np.ndarray, ch: int, temb_ch: int, *, flavor: str = "ddpm") -> Dict[str, Any]:
    """The JAX `delta_block_init` tree (JAX layout) for a numpy key."""
    ks = hostrng.split(key, 4)
    if flavor == "ddpm":
        return {
            "conv1": hostinit.linear_init(ks[0], ch, ch),
            "temb_proj": hostinit.linear_init(ks[1], temb_ch, ch),
            "norm2": hostinit.norm_init(ch),
            "conv2": hostinit.linear_init(ks[2], ch, ch),
        }
    if flavor == "openai":
        return {
            "in_norm": hostinit.norm_init(ch),
            "in_conv": hostinit.linear_init(ks[0], ch, ch),
            "emb": hostinit.linear_init(ks[1], temb_ch, ch),
            "out_norm": hostinit.norm_init(ch),
            "out_conv": hostinit.linear_init(ks[2], ch, ch),
        }
    raise ValueError(f"unknown DeltaBlock flavor: {flavor}")


def delta_block_from_tree(tree: Dict[str, Any], ch: int, temb_ch: int, *,
                          flavor: str = "ddpm") -> nn.Module:
    """A JAX-layout block tree → the flavor's DeltaBlock module."""
    block = _BLOCKS[flavor](ch, temb_ch)
    block.load_state_dict(delta_block_state_dict_from_jax(tree, flavor))
    return block


def init_delta_blocks(seed: int, n: int, ch: int, temb_ch: int, *,
                      flavor: str = "ddpm") -> Tuple[nn.Module, ...]:
    """`n` DeltaBlocks, block i drawn from `hostrng.PRNGKey(seed + i)`: the
    same weights, bit for bit, as the JAX runner's `delta_block_init` for
    `--train_delta_block --get_h_num n`."""
    if n < 1:
        raise ValueError(f"need at least one DeltaBlock, got {n} (--get_h_num)")
    return tuple(delta_block_from_tree(delta_block_init(hostrng.PRNGKey(seed + i), ch, temb_ch,
                                                        flavor=flavor), ch, temb_ch, flavor=flavor)
                 for i in range(n))


@dataclasses.dataclass
class EditState:
    """The per-forward edit: `blocks` (DeltaBlocks), `hs_coeff` ([k+1] or
    per-sample [B, k+1]; hs_coeff[0] scales the original h), and the per-step
    gate `use_delta` (1.0 where t >= t_edit)."""

    blocks: Tuple[nn.Module, ...] = ()
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
