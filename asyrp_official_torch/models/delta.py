"""DeltaBlocks (DDPM++ and OpenAI flavors, and the CLIP-conditioned
`DeltaBlockGlobal`), `EditState`, `slerp` and `apply_edit` — the port of the
JAX `models/delta.py`. Edit modes: `deltablock`; `input` (the per-timestep
Δh rows of `--train_delta_h` and DiffStyle, injected by `add` or by the
norm-matched `slerp`, the latter optionally inside the DiffStyle mask);
`global` (h + DeltaBlockGlobal(h, temb, clip_direction)); `interp_batch`
(every sample the interpolation of the batch's end points).

Each DeltaBlock keeps the reference's key names (DDPM++: conv1 / temb_proj /
norm2 / conv2; OpenAI: in_layers.{0,2} / emb_layers.1 / out_layers.{0,3}),
so a released Δ `.pth` block loads with `load_state_dict`. Its
GroupNorm+SiLU is kernel K1.

On a row block of h (`parallel.spatial.sharded`) the edits reduce over the
whole of h: the slerp's norms and dot product and the norm match sum over
the ranks (`spatial.all_reduce_sum`, whose gradient is the same sum); the
Δh rows, the DiffStyle mask and the global block's CLIP map are sliced to
the rank's rows, so a trained rows leaf gets its gradient on this rank's
rows only (the ranks' parts are summed by `parallel.mesh.Mesh.sync_grads`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from asyrp_official_torch.compat.from_jax import (delta_block_global_state_dict_from_jax,
                                                  delta_block_state_dict_from_jax)
from asyrp_official_torch.models import common as cm
from asyrp_official_torch.models import hostinit
from asyrp_official_torch.parallel import spatial
from asyrp_official_torch.utils import hostrng

__all__ = ["DeltaBlock", "OpenAIDeltaBlock", "DeltaBlockGlobal", "EditState", "apply_edit",
           "delta_block_init", "delta_block_global_init", "delta_block_from_tree",
           "delta_block_global_from_tree", "init_delta_blocks", "rows_to_nchw", "rows_to_nhwc",
           "slerp"]


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


class DeltaBlockGlobal(nn.Module):
    """The reference's DeltaBlock_global, conditioned on a CLIP direction
    [1|B, clip_ch]: conv1 (3x3) → (+ temb + clip_proj) → GN → SiLU → conv2
    → (+ clip_proj_2 as a [1, C, h, w] map) → GN → SiLU → conv3 → GN → SiLU
    → conv4 (1x1 each). Its GroupNorm+SiLU calls are K1 (eps 1e-6)."""

    def __init__(self, ch: int, temb_ch: int, clip_ch: int = 512, hw: int = 8):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.temb_proj = nn.Linear(temb_ch, ch)
        self.clip_proj = nn.Linear(clip_ch, ch)
        self.clip_proj_2 = nn.Linear(clip_ch, ch * hw * hw)
        self.norm2, self.norm3, self.norm4 = cm.GroupNorm(ch), cm.GroupNorm(ch), cm.GroupNorm(ch)
        self.conv2, self.conv3, self.conv4 = (nn.Conv2d(ch, ch, 1) for _ in range(3))

    def forward(self, x, temb, clip_direction):
        b, c, hh, ww = x.shape
        d = torch.as_tensor(clip_direction).to(device=x.device, dtype=x.dtype)
        h = cm.conv2d(self.conv1, x)
        add = cm.linear(self.temb_proj, F.silu(temb)) + cm.linear(self.clip_proj, d)
        h = cm.mat1x1(self.conv2, self.norm2(h, silu=True, pre_add=add.expand(b, c).contiguous()))
        # the reference reshapes to NCHW (1, C, h, w): the port's own layout
        sg = spatial.active()
        clip_map = cm.linear(self.clip_proj_2, d).reshape(1, c, -1, ww)
        h = h + (clip_map if sg is None else spatial.local_rows(clip_map, 2, sg))
        h = cm.mat1x1(self.conv3, self.norm3(h, silu=True))
        return cm.mat1x1(self.conv4, self.norm4(h, silu=True))


_BLOCKS = {"ddpm": DeltaBlock, "openai": OpenAIDeltaBlock}


def delta_block_global_init(key: np.ndarray, ch: int, temb_ch: int, clip_ch: int = 512,
                            hw: int = 8) -> Dict[str, Any]:
    """The JAX `delta_block_global_init` tree (JAX layout) for a numpy key."""
    ks = hostrng.split(key, 8)
    return {
        "conv1": hostinit.conv_init(ks[0], 3, 3, ch, ch),
        "temb_proj": hostinit.linear_init(ks[1], temb_ch, ch),
        "clip_proj": hostinit.linear_init(ks[2], clip_ch, ch),
        "clip_proj_2": hostinit.linear_init(ks[3], clip_ch, ch * hw * hw),
        "norm2": hostinit.norm_init(ch),
        "conv2": hostinit.linear_init(ks[4], ch, ch),
        "norm3": hostinit.norm_init(ch),
        "conv3": hostinit.linear_init(ks[5], ch, ch),
        "norm4": hostinit.norm_init(ch),
        "conv4": hostinit.linear_init(ks[6], ch, ch),
    }


def delta_block_global_from_tree(tree: Dict[str, Any]) -> DeltaBlockGlobal:
    """A JAX-layout `delta_block_global_init` tree → DeltaBlockGlobal (the
    sizes read off the tree)."""
    ch, temb_ch = tree["temb_proj"]["w"].shape[::-1]
    clip_ch = tree["clip_proj"]["w"].shape[0]
    hw = int(round((tree["clip_proj_2"]["w"].shape[1] // ch) ** 0.5))
    block = DeltaBlockGlobal(ch, temb_ch, clip_ch, hw)
    block.load_state_dict(delta_block_global_state_dict_from_jax(tree))
    return block


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
    sg = spatial.active()
    if sg is None:
        n0 = torch.linalg.vector_norm(v0f, dim=1, keepdim=True).clamp_min(eps)
        n1 = torch.linalg.vector_norm(v1f, dim=1, keepdim=True).clamp_min(eps)
        dot = ((v0f / n0) * (v1f / n1)).sum(dim=1).clamp(-1.0, 1.0)
    else:  # row blocks: the squares and the products summed over the ranks
        s00, s11, s01 = spatial.all_reduce_sum(
            torch.stack([v0f.square().sum(1), v1f.square().sum(1), (v0f * v1f).sum(1)]), sg)
        n0, n1 = s00.sqrt().clamp_min(eps), s11.sqrt().clamp_min(eps)
        dot = (s01 / (n0 * n1)).clamp(-1.0, 1.0)
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

    `global` mode: `blocks[0]` a DeltaBlockGlobal and `clip_direction`
    [1|B, clip_ch]; h2 = h + block(h, temb, clip_direction) (`hs_coeff`
    and `ignore_timestep` unused). `interp_batch` mode: `alpha` [B]; every
    sample becomes (1 - alpha)·h[0] + alpha·h[-1], with no Δh.

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
    clip_direction: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None

    def at_step(self, aux) -> "EditState":
        return dataclasses.replace(self, use_delta=aux["use_delta"],
                                   delta_idx=int(aux.get("delta_idx", 0)))


def _input_edit(edit: EditState, h, hs_coeff, c):
    """The `input` mode's h2 and Δh (JAX `apply_edit`, mode "input")."""
    rows = edit.delta_rows
    sg = spatial.active()
    # clamped as jnp.take(mode="clip"): a wrong index gives a wrong row, never NaN
    idx = min(max(int(edit.delta_idx), 0), rows.shape[0] - 1)
    row = rows[idx] if sg is None else spatial.local_rows(rows[idx], 1, sg)
    delta_h = row.to(device=h.device, dtype=h.dtype).unsqueeze(0).expand_as(h)
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
        # the DiffStyle region, NCHW [:, :, 4:-1, 3:5] of the whole h
        shape = h.shape if sg is None else h.shape[:2] + rows.shape[2:]
        mask = torch.zeros(shape, dtype=h.dtype, device=h.device)
        mask[:, :, 4:-1, 3:5] = 1.0
        if sg is not None:
            mask = spatial.local_rows(mask, 2, sg)
        return slerp(t, h * mask, delta_h * mask) + (1.0 - mask) * h, delta_h
    # norm-matched; the floor makes a zero row (the delta_idx 0 placeholder
    # of a gated-off step) give 0, not NaN, which the gate would keep (0·NaN)
    b = h.shape[0]
    if sg is None:
        h_norm = torch.linalg.vector_norm(h.reshape(b, -1).float(), dim=1)
        d_norm = torch.linalg.vector_norm(delta_h.reshape(b, -1).float(), dim=1).clamp_min(1e-12)
    else:  # row blocks: the squares summed over the ranks
        hs, ds = spatial.all_reduce_sum(torch.stack(
            [a.reshape(b, -1).float().square().sum(1) for a in (h, delta_h)]), sg)
        h_norm, d_norm = hs.sqrt(), ds.sqrt().clamp_min(1e-12)
    normalized = (h_norm / d_norm).reshape(b, 1, 1, 1).to(h.dtype) * delta_h
    return slerp(t, h, normalized), delta_h


def apply_edit(edit: EditState, h, temb):
    """The edited bottleneck h2 and the Δh used (the last block's, or the
    step's row), gated by `edit.use_delta`. h is NCHW."""
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
    elif edit.mode == "global":
        delta_h = edit.blocks[0](h, temb, edit.clip_direction)
        h2 = h + delta_h
    elif edit.mode == "interp_batch":
        a = torch.as_tensor(edit.alpha).to(device=h.device, dtype=h.dtype).reshape(-1, 1, 1, 1)
        h2, delta_h = (1.0 - a) * h[:1] + a * h[-1:], None
    elif edit.mode == "deltablock":
        if hs_coeff.shape[-1] < len(edit.blocks) + 1:
            raise ValueError(f"hs_coeff needs {len(edit.blocks) + 1} entries (original h + one "
                             f"per block), got {hs_coeff.shape[-1]}")
        temb_in = None if edit.ignore_timestep else temb
        h2 = h * c(0)
        delta_h = None
        for i, block in enumerate(edit.blocks):
            delta_h = block(h, temb_in)
            h2 = h2 + delta_h * c(i + 1)
    else:
        raise ValueError(f"unknown edit mode: {edit.mode}")
    use = float(edit.use_delta)
    return use * h2 + (1.0 - use) * h, delta_h
