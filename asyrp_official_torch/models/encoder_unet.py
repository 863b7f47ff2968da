"""EncoderUNetModel (the ADM classifier half-UNet) and SuperResModel — the
port of the JAX `models/encoder_unet.py`, built from the layers of
`models/openai_unet.py` (the encoder is the UNet's input and middle stems).

`EncoderUNet` keeps the reference's state-dict key names (`time_embed.*`,
`input_blocks.*`, `middle_block.*`, and per pool head `out.*`), so a
guided-diffusion classifier `.pt` loads with `load_state_dict`; its
`apply` is the JAX `encoder_apply`: NHWC images in, [B, K] logits out.
Pool heads:

  * 'adaptive'   — GN → SiLU → global mean → 1x1 conv (zero init) → [B, K]
  * 'attention'  — GN → SiLU → AttentionPool2d: the mean token prepended,
                   a positional embedding added, one attention of
                   `num_head_channels`-wide heads (kernel K2 with the legacy
                   scale), token 0
  * 'spatial'    — every input block's and the middle block's spatial means
                   concatenated → Linear → ReLU → Linear
  * 'spatial_v2' — the same with GN32 + SiLU (kernel K1 on [B, 2048, 1, 1])
                   in place of the ReLU

`encoder_init` draws the JAX `encoder_init` tree bit for bit (numpy, JAX
layout); `compat.from_jax.encoder_state_dict_from_jax` turns it into the
module's state dict. `superres_apply` runs an `OpenAIUNet` built on
`superres_config(cfg)` on [x ; bilinear upsample of low_res].
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from asyrp_official_torch.models import common as cm
from asyrp_official_torch.models import hostinit
from asyrp_official_torch.models.openai_unet import (_EPS, OpenAIUNetConfig, _layer, _layer_init,
                                                     _slot, build_plan)
from asyrp_official_torch.ops import attention as _k2
from asyrp_official_torch.utils import hostrng

__all__ = ["EncoderUNetConfig", "encoder_plan", "encoder_init", "EncoderUNet", "superres_config",
           "superres_apply"]

_POOLS = ("adaptive", "attention", "spatial", "spatial_v2")
_SPATIAL_WIDTH = 2048  # the spatial heads' hidden width (unet.py:1041-1060)


@dataclasses.dataclass(frozen=True)
class EncoderUNetConfig(OpenAIUNetConfig):
    pool: str = "adaptive"  # adaptive | attention | spatial | spatial_v2


def encoder_plan(cfg: EncoderUNetConfig) -> Dict[str, Any]:
    """The input and middle stems of the UNet plan, and the spatial heads'
    feature size (the reference's running `_feature_size`)."""
    plan = build_plan(cfg)

    def block_out_ch(block):
        for spec in reversed(block):
            if "cout" in spec:
                return spec["cout"]
            if "ch" in spec:
                return spec["ch"]
        raise ValueError(block)

    feature_size = sum(block_out_ch(b) for b in plan["input"]) + cfg.bottleneck_ch
    return {"input": plan["input"], "middle": plan["middle"], "feature_size": feature_size}


def _pool_tokens(cfg: EncoderUNetConfig) -> int:
    """T of the attention pool: the bottleneck's pixels."""
    return (cfg.image_size // 2 ** (len(cfg.channel_mult) - 1)) ** 2


def encoder_init(key: np.ndarray, cfg: EncoderUNetConfig) -> Dict[str, Any]:
    """The JAX `encoder_init(key, cfg)` tree for a numpy (hostrng) key: the
    same draws in the same order, the attention pool's positional
    embedding ([T+1, C], N(0, 1) / sqrt(C)) included."""
    if cfg.pool not in _POOLS:
        raise ValueError(f"Unexpected {cfg.pool} pooling")
    plan = encoder_plan(cfg)
    keys = iter(hostrng.split(key, 4096))
    nxt = lambda: next(keys)
    params: Dict[str, Any] = {
        "time_embed": {
            "dense0": hostinit.linear_init(nxt(), cfg.model_channels, cfg.temb_ch),
            "dense1": hostinit.linear_init(nxt(), cfg.temb_ch, cfg.temb_ch),
        },
        "input_blocks": [[_layer_init(nxt(), s, cfg) for s in block] for block in plan["input"]],
        "middle_block": [_layer_init(nxt(), s, cfg) for s in plan["middle"]],
    }
    ch = cfg.bottleneck_ch
    if cfg.pool == "adaptive":
        params["out"] = {"norm": hostinit.norm_init(ch),
                         "conv": hostinit.linear_init(nxt(), ch, cfg.out_channels, zero=True)}
    elif cfg.pool == "attention":
        if cfg.num_head_channels == -1:
            raise ValueError("the attention pool needs num_head_channels")
        t = _pool_tokens(cfg)
        params["out"] = {
            "norm": hostinit.norm_init(ch),
            "pool": {
                "positional_embedding": hostrng.normal(nxt(), (t + 1, ch)) / np.float32(ch ** 0.5),
                "qkv": hostinit.linear_init(nxt(), ch, 3 * ch),
                "c_proj": hostinit.linear_init(nxt(), ch, cfg.out_channels),
            },
        }
    else:
        params["out"] = {"lin1": hostinit.linear_init(nxt(), plan["feature_size"], _SPATIAL_WIDTH),
                         "lin2": hostinit.linear_init(nxt(), _SPATIAL_WIDTH, cfg.out_channels)}
        if cfg.pool == "spatial_v2":
            params["out"]["norm"] = hostinit.norm_init(_SPATIAL_WIDTH)
    return params


class AttentionPool2d(nn.Module):
    """The CLIP-style pool (unet.py:64-93) with the reference's keys:
    `positional_embedding` [C, T+1], `qkv_proj` and `c_proj` as 1-D convs."""

    def __init__(self, tokens: int, ch: int, head_channels: int, out_channels: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.zeros(ch, tokens + 1))
        self.qkv_proj = nn.Conv1d(ch, 3 * ch, 1)
        self.c_proj = nn.Conv1d(ch, out_channels, 1)
        self.heads = ch // head_channels

    def forward(self, h):
        b, c = h.shape[:2]
        flat = h.flatten(2)  # [B, C, T]
        flat = torch.cat([flat.mean(dim=2, keepdim=True), flat], dim=2)
        flat = (flat + self.positional_embedding.to(flat.dtype)[None]).transpose(1, 2)
        t, d = flat.shape[1], c // self.heads
        qkv = F.linear(flat, self.qkv_proj.weight[:, :, 0].to(flat.dtype),
                       self.qkv_proj.bias.to(flat.dtype))
        # the conv's 3C channels in QKVAttention's order, [3][H][d]; its
        # scale is the legacy one, d^-1/4 on q and k
        q, k, v = (a.reshape(b, t, c).contiguous() for a in qkv.reshape(b, t, 3, c).unbind(2))
        out = _k2.attention(q, k, v, num_heads=self.heads, legacy_scale=True)
        out = F.linear(out[:, 0], self.c_proj.weight[:, :, 0].to(out.dtype),
                       self.c_proj.bias.to(out.dtype))
        return out


class EncoderUNet(nn.Module):
    def __init__(self, cfg: EncoderUNetConfig):
        super().__init__()
        if cfg.pool not in _POOLS:
            raise ValueError(f"Unexpected {cfg.pool} pooling")
        self.cfg = cfg
        plan = encoder_plan(cfg)
        mc, temb = cfg.model_channels, cfg.temb_ch
        self.time_embed = nn.ModuleList([nn.Linear(mc, temb), _slot(), nn.Linear(temb, temb)])
        self.input_blocks = nn.ModuleList(
            nn.ModuleList(_layer(s, cfg) for s in block) for block in plan["input"])
        self.middle_block = nn.ModuleList(_layer(s, cfg) for s in plan["middle"])
        ch, k = cfg.bottleneck_ch, cfg.out_channels
        if cfg.pool == "adaptive":  # norm, SiLU, pool, the 1x1 conv, flatten
            out = [cm.GroupNorm(ch, eps=_EPS), _slot(), _slot(), nn.Conv2d(ch, k, 1)]
        elif cfg.pool == "attention":
            out = [cm.GroupNorm(ch, eps=_EPS), _slot(),
                   AttentionPool2d(_pool_tokens(cfg), ch, cfg.num_head_channels, k)]
        elif cfg.pool == "spatial":  # Linear, ReLU, Linear
            out = [nn.Linear(plan["feature_size"], _SPATIAL_WIDTH), _slot(),
                   nn.Linear(_SPATIAL_WIDTH, k)]
        else:  # Linear, GN32, SiLU, Linear
            out = [nn.Linear(plan["feature_size"], _SPATIAL_WIDTH),
                   cm.GroupNorm(_SPATIAL_WIDTH, eps=_EPS), _slot(), nn.Linear(_SPATIAL_WIDTH, k)]
        self.out = nn.ModuleList(out)

    def apply(self, x_nhwc, t):
        """[B, H, W, C] images and [B] timesteps -> [B, K] logits
        (unet.py:1063-1088)."""
        emb = cm.timestep_embedding_openai(t, self.cfg.model_channels)
        emb = cm.linear(self.time_embed[2], F.silu(cm.linear(self.time_embed[0], emb)))
        h = x_nhwc.permute(0, 3, 1, 2).contiguous()
        emb = emb.to(h.dtype)
        spatial = self.cfg.pool.startswith("spatial")
        means = []
        for block in self.input_blocks:
            for layer in block:
                h = layer(h, emb)
            if spatial:
                means.append(h.mean(dim=(2, 3)))
        for layer in self.middle_block:
            h = layer(h, emb)
        if spatial:
            means.append(h.mean(dim=(2, 3)))
            y = cm.linear(self.out[0], torch.cat(means, dim=-1))
            if self.cfg.pool == "spatial_v2":
                y = self.out[1](y[:, :, None, None], silu=True)[:, :, 0, 0]
            else:
                y = F.relu(y)
            return cm.linear(self.out[-1], y)
        h = self.out[0](h, silu=True)
        if self.cfg.pool == "adaptive":
            conv = self.out[3]
            return F.linear(h.mean(dim=(2, 3)), conv.weight[:, :, 0, 0].to(h.dtype),
                            conv.bias.to(h.dtype))
        return self.out[2](h)

    forward = apply


def superres_config(cfg: OpenAIUNetConfig) -> OpenAIUNetConfig:
    """The SuperRes constructor doubles in_channels (unet.py:867-868); build
    the `OpenAIUNet` and its init on this config."""
    return dataclasses.replace(cfg, in_channels=cfg.in_channels * 2)


def superres_apply(model, x_nhwc, t, low_res_nhwc, **kw):
    """forward(x, t, low_res) (unet.py:870-875): `low_res` upsampled to x's
    size, concatenated on the channels, through `model.apply`.

    The JAX function resizes with `jax.image.resize(..., "bilinear")`: a
    triangle kernel at half-pixel centers, antialiased, whose taps that fall
    outside the image are dropped and the rest renormalised. For an upsample
    the kernel keeps its unit width (antialiasing widens it only when
    shrinking), and at the borders the one remaining tap is the edge pixel,
    which is what `align_corners=False` bilinear clamps to. So it equals
    `F.interpolate(mode="bilinear", align_corners=False, antialias=False)`
    here, and only because this is an upsample: a smaller x raises."""
    h, w = x_nhwc.shape[1:3]
    if low_res_nhwc.shape[1] > h or low_res_nhwc.shape[2] > w:
        raise ValueError(f"superres: low_res {tuple(low_res_nhwc.shape)} is larger than x "
                         f"{tuple(x_nhwc.shape)}; the bilinear resize is an upsample only")
    up = F.interpolate(low_res_nhwc.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                       align_corners=False, antialias=False).permute(0, 2, 3, 1)
    return model.apply(torch.cat([x_nhwc, up.to(x_nhwc.dtype)], dim=-1), t, **kw)
