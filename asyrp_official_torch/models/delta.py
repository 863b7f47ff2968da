"""DeltaBlocks (DDPM++ and OpenAI flavors), `EditState`, `slerp` and
`apply_edit` — the port of the JAX `models/delta.py` for the `deltablock`
edit mode and the `input` mode (the per-timestep Δh rows of
`--train_delta_h`, injected by `add` or by the norm-matched `slerp`, the
latter optionally inside the `--masked_h` region).

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
           "delta_block_from_tree", "init_delta_blocks", "rows_to_nchw", "rows_to_nhwc", "slerp"]

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


def rows_to_nchw(rows) -> torch.Tensor:
    """Stacked Δh rows [K, h, w, C] (the checkpoint's NHWC) → the
    [K, C, h, w] f32 tensor `EditState.delta_rows` holds."""
    return torch.as_tensor(np.asarray(rows, np.float32)).permute(0, 3, 1, 2).contiguous()


def rows_to_nhwc(rows: torch.Tensor) -> np.ndarray:
    """`EditState.delta_rows` [K, C, h, w] → NHWC numpy [K, h, w, C]."""
    return rows.detach().float().permute(0, 2, 3, 1).cpu().numpy()


def slerp(t, v0: torch.Tensor, v1: torch.Tensor, *, eps: float = 1e-7) -> torch.Tensor:
    """Per-sample spherical interpolation of v0 toward v1 by t (JAX
    `models/delta.py` `slerp`). A zero vector or a colinear pair falls back
    to linear interpolation, as there.

    The angle's coefficients are f32 and are written so that the backward
    stays finite and exact: at a pole (dot = ±1) the angle is a constant,
    so arccos' infinite slope never meets a zero cotangent; and
    s0 = cos(tθ) - sin(tθ)·cot θ (the same value as sin((1-t)θ) / sin θ)
    makes t = 0 give s0 = 1, s1 = 0 and a gradient of exactly 0 to v1."""
    b = v0.shape[0]
    v0f = v0.reshape(b, -1).float()
    v1f = v1.reshape(b, -1).float()
    n0 = torch.linalg.vector_norm(v0f, dim=1, keepdim=True).clamp_min(eps)
    n1 = torch.linalg.vector_norm(v1f, dim=1, keepdim=True).clamp_min(eps)
    dot = ((v0f / n0) * (v1f / n1)).sum(dim=1).clamp(-1.0, 1.0)
    pole = dot.abs() >= 1.0
    theta = torch.where(pole, (1.0 - dot.detach()) * (np.pi / 2),
                        torch.arccos(torch.where(pole, torch.zeros_like(dot), dot)))
    sin_theta = torch.sin(theta)
    degenerate = sin_theta.abs() < eps
    sin_safe = torch.where(degenerate, torch.ones_like(sin_theta), sin_theta)
    t = torch.as_tensor(t, dtype=torch.float32, device=v0.device)
    theta_t = theta * t
    s0 = torch.where(degenerate, 1.0 - t,
                     torch.cos(theta_t) - torch.sin(theta_t) * torch.cos(theta) / sin_safe)
    s1 = torch.where(degenerate, t.expand_as(theta), torch.sin(theta_t) / sin_safe)
    shape = (b,) + (1,) * (v0.dim() - 1)
    return (s0.reshape(shape).to(v0.dtype) * v0 + s1.reshape(shape).to(v1.dtype) * v1)


@dataclasses.dataclass
class EditState:
    """The per-forward edit.

    `deltablock` mode: `blocks` (DeltaBlocks); `hs_coeff` is [k+1] or
    per-sample [B, k+1], hs_coeff[0] scaling the original h.

    `input` mode: `delta_rows`, the stacked Δh rows [K, C, h, w] f32
    (`rows_to_nchw` of the checkpoint's NHWC rows), one picked per step by
    `delta_idx`; `input_style` "add" (h·c0 + row·c1, [B, 2] coefficients
    too) or "slerp" (norm-matched, toward the row by 1 - c0), inside the
    DiffStyle mask region with `use_mask`; `times`, the timesteps of the
    rows (None when one row serves every step).

    The sampler binds the step's gate `use_delta` (1.0 where the edit is
    injected) and row `delta_idx` through `at_step`."""

    blocks: Tuple[nn.Module, ...] = ()
    hs_coeff: Optional[torch.Tensor] = None
    use_delta: float = 1.0
    mode: str = "deltablock"
    flavor: str = "ddpm"
    ignore_timestep: bool = False
    delta_rows: Optional[torch.Tensor] = None
    delta_idx: int = 0
    input_style: str = "slerp"
    use_mask: bool = False
    times: Optional[Tuple[int, ...]] = None

    def at_step(self, aux) -> "EditState":
        return dataclasses.replace(self, use_delta=aux["use_delta"],
                                   delta_idx=int(aux.get("delta_idx", 0)))


def _input_edit(edit: EditState, h, hs_coeff, c):
    """The `input` mode's h2 and Δh (JAX `apply_edit`, mode "input")."""
    rows = edit.delta_rows
    # clamped as jnp.take(mode="clip"): a wrong index gives a wrong row, never NaN
    idx = min(max(int(edit.delta_idx), 0), rows.shape[0] - 1)
    delta_h = rows[idx].to(device=h.device, dtype=h.dtype).unsqueeze(0).expand_as(h)
    if edit.input_style == "add":
        if hs_coeff.shape[-1] < 2:
            raise ValueError(f"'add' injection needs hs_coeff = (c_h, c_delta), got "
                             f"{hs_coeff.shape[-1]} entries")
        return h * c(0) + delta_h * c(1), delta_h
    if edit.input_style != "slerp":
        raise ValueError(f"unknown input_style: {edit.input_style!r}")
    if hs_coeff.dim() == 2:
        raise ValueError("per-sample hs_coeff ([B, K]) is only supported for the linear "
                         "injections (deltablock, input/add)")
    t = 1.0 - hs_coeff[0].float()
    if edit.use_mask:
        # the DiffStyle region, NCHW [:, :, 4:-1, 3:5]
        mask = torch.zeros_like(h)
        mask[:, :, 4:-1, 3:5] = 1.0
        return slerp(t, h * mask, delta_h * mask) + (1.0 - mask) * h, delta_h
    # norm-matched; the floor makes a zero row (the delta_idx 0 placeholder
    # of a gated-off step) give 0, not NaN, which the gate would keep (0·NaN)
    b = h.shape[0]
    h_norm = torch.linalg.vector_norm(h.reshape(b, -1).float(), dim=1)
    d_norm = torch.linalg.vector_norm(delta_h.reshape(b, -1).float(), dim=1).clamp_min(1e-12)
    normalized = (h_norm / d_norm).reshape(b, 1, 1, 1).to(h.dtype) * delta_h
    return slerp(t, h, normalized), delta_h


def apply_edit(edit: EditState, h, temb):
    """The edited bottleneck h2 and the Δh used (the last block's, or the
    step's row), gated by `edit.use_delta`. h is NCHW."""
    if edit.mode not in ("deltablock", "input"):
        raise NotImplementedError(f"edit mode {edit.mode!r} {_NOT_PORTED}")
    hs_coeff = edit.hs_coeff
    if hs_coeff is None:
        hs_coeff = torch.ones(len(edit.blocks) + 1)
    # coefficients arrive f32; without the cast a bf16 h would be promoted
    hs_coeff = torch.as_tensor(hs_coeff).to(device=h.device, dtype=h.dtype)
    per_sample = hs_coeff.dim() == 2

    def c(i):
        return hs_coeff[:, i].reshape(-1, 1, 1, 1) if per_sample else hs_coeff[i]

    if edit.mode == "input":
        h2, delta_h = _input_edit(edit, h, hs_coeff, c)
    else:
        if hs_coeff.shape[-1] < len(edit.blocks) + 1:
            raise ValueError(f"hs_coeff needs {len(edit.blocks) + 1} entries (original h + one "
                             f"per block), got {hs_coeff.shape[-1]}")
        temb_in = None if edit.ignore_timestep else temb
        h2 = h * c(0)
        delta_h = None
        for i, block in enumerate(edit.blocks):
            delta_h = block(h, temb_in)
            h2 = h2 + delta_h * c(i + 1)
    use = float(edit.use_delta)
    return use * h2 + (1.0 - use) * h, delta_h
