"""The two UNets and their DeltaBlocks, written out from the published
models over a state dict under the released checkpoints' key names.

  * DDPM++ (`family: ddpmpp`): the DDPM UNet of ermongroup/ddim
    `models/diffusion.py`, as SDEdit's CelebA-HQ checkpoint and Asyrp load
    it. GroupNorm eps 1e-6, attention one head with d^-0.5 on the logits,
    downsample a right/bottom-padded stride-2 conv, upsample nearest then
    a conv. Asyrp's DeltaBlock: 1x1 conv, + temb_proj(SiLU(temb)),
    GroupNorm, SiLU, 1x1 conv.
  * The improved-DDPM UNet (`family: openai`) of openai/improved-diffusion
    `unet.py`: GroupNorm32 eps 1e-5, scale-shift norm, resblock up/down
    (2x2 average pool, nearest upsample), legacy attention (heads of
    `num_head_channels`, q and k scaled by d^-0.25), `learn_sigma` (6
    output channels). Asyrp's DeltaBlock for it: GN, SiLU, 1x1 conv,
    + Linear(SiLU(emb)), GN, SiLU, 1x1 conv.

`RefUNet(sd, config, ops)` holds the weights (a dict of tensors) and
gives `encode(x, t) -> (h, skips, temb)` through the middle block,
`decode(h, skips, temb) -> eps_raw` and `delta(h, temb, block_sd)`. All
maps are NCHW f32.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.ops import RefOps

__all__ = ["RefUNet"]


def _emb_ddpm(t, dim: int):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


def _emb_openai(t, dim: int):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


def _up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class RefUNet:
    def __init__(self, sd: Dict[str, torch.Tensor], config: dict, ops: RefOps):
        self.sd, self.ops = sd, ops
        m, d = config["model"], config["data"]
        self.family = m.get("family", "ddpmpp")
        self.ch, self.mult = m["ch"], tuple(m["ch_mult"])
        self.n_res, self.res = m["num_res_blocks"], d["image_size"]
        self.attn_res = tuple(m["attn_resolutions"])
        self.head_ch = m.get("num_head_channels", 64)
        self.eps = 1e-6 if self.family == "ddpmpp" else 1e-5

    # -- shared pieces ------------------------------------------------------
    def _w(self, name):
        return self.sd[name]

    def _conv(self, p, x, stride=1, padding=1):
        return self.ops.conv2d(x, self._w(p + ".weight"), self._w(p + ".bias"), stride, padding)

    def _lin(self, p, x):
        w = self._w(p + ".weight")
        return self.ops.linear(x, w.reshape(w.shape[0], -1), self._w(p + ".bias"))

    def _gn(self, p, x, **kw):
        return self.ops.group_norm(x, self._w(p + ".weight"), self._w(p + ".bias"), self.eps, **kw)

    def _has(self, p):
        return p + ".weight" in self.sd

    # -- DDPM++ ---------------------------------------------------------------
    def _d_res(self, p, x, temb):
        h = self._conv(p + ".conv1", self._gn(p + ".norm1", x, silu=True))
        h = self._gn(p + ".norm2", h, silu=True, pre_add=self._lin(p + ".temb_proj", F.silu(temb)))
        h = self._conv(p + ".conv2", h)
        if self._has(p + ".nin_shortcut"):
            x = self._conv(p + ".nin_shortcut", x, padding=0)
        return x + h

    def _d_attn(self, p, x):
        b, c, hh, ww = x.shape
        tok = self._gn(p + ".norm", x).flatten(2).transpose(1, 2)
        q, k, v = (self._lin(p + "." + n, tok) for n in ("q", "k", "v"))
        out = self._lin(p + ".proj_out", self.ops.attention(q, k, v, 1, legacy_scale=False))
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)

    def _d_encode(self, x, t):
        temb = self._lin("temb.dense.0", _emb_ddpm(t, self.ch))
        temb = self._lin("temb.dense.1", F.silu(temb))
        hs, res = [self._conv("conv_in", x)], self.res
        for i in range(len(self.mult)):
            for j in range(self.n_res):
                h = self._d_res(f"down.{i}.block.{j}", hs[-1], temb)
                if res in self.attn_res:
                    h = self._d_attn(f"down.{i}.attn.{j}", h)
                hs.append(h)
            if i != len(self.mult) - 1:
                hs.append(self._conv(f"down.{i}.downsample.conv", F.pad(hs[-1], (0, 1, 0, 1)),
                                     stride=2, padding=0))
                res //= 2
        h = self._d_res("mid.block_1", hs[-1], temb)
        h = self._d_attn("mid.attn_1", h)
        return self._d_res("mid.block_2", h, temb), hs, temb

    def _d_decode(self, h, hs, temb):
        hs, res = list(hs), self.res // 2 ** (len(self.mult) - 1)
        for i in reversed(range(len(self.mult))):
            for j in range(self.n_res + 1):
                h = self._d_res(f"up.{i}.block.{j}", torch.cat([h, hs.pop()], dim=1), temb)
                if res in self.attn_res:
                    h = self._d_attn(f"up.{i}.attn.{j}", h)
            if i != 0:
                h = self._conv(f"up.{i}.upsample.conv", _up2(h))
                res *= 2
        return self._conv("conv_out", self._gn("norm_out", h, silu=True))

    # -- improved DDPM ----------------------------------------------------------
    def _o_res(self, p, x, emb, updown=None):
        h = self._gn(p + ".in_layers.0", x, silu=True)
        if updown == "down":
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        elif updown == "up":
            h, x = _up2(h), _up2(x)
        h = self._conv(p + ".in_layers.2", h)
        film = self._lin(p + ".emb_layers.1", F.silu(emb))
        h = self._gn(p + ".out_layers.0", h, silu=True, scale_shift=film)
        h = self._conv(p + ".out_layers.3", h)
        if self._has(p + ".skip_connection"):
            x = self._conv(p + ".skip_connection", x, padding=0)
        return x + h

    def _o_attn(self, p, x):
        b, c, hh, ww = x.shape
        heads, t = c // self.head_ch, hh * ww
        tok = self._gn(p + ".norm", x).flatten(2).transpose(1, 2)
        qkv = self._lin(p + ".qkv", tok).reshape(b, t, heads, 3, self.head_ch)
        q, k, v = (qkv[:, :, :, i].reshape(b, t, c) for i in range(3))
        out = self._lin(p + ".proj_out", self.ops.attention(q, k, v, heads, legacy_scale=True))
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)

    def _o_plan(self):
        """The improved-diffusion UNetModel's layers in key order: input
        blocks, then output blocks, each a list of (kind, prefix)."""
        ds, inputs = 1, [[("conv", "input_blocks.0.0")]]
        for level in range(len(self.mult)):
            for _ in range(self.n_res):
                i = len(inputs)
                blk = [("res", f"input_blocks.{i}.0")]
                if self.res // ds in self.attn_res:
                    blk.append(("attn", f"input_blocks.{i}.1"))
                inputs.append(blk)
            if level != len(self.mult) - 1:
                inputs.append([("down", f"input_blocks.{len(inputs)}.0")])
                ds *= 2
        outputs = []
        for level in reversed(range(len(self.mult))):
            for j in range(self.n_res + 1):
                i = len(outputs)
                blk = [("res", f"output_blocks.{i}.0")]
                if self.res // ds in self.attn_res:
                    blk.append(("attn", f"output_blocks.{i}.{len(blk)}"))
                if level and j == self.n_res:
                    blk.append(("up", f"output_blocks.{i}.{len(blk)}"))
                    ds //= 2
                outputs.append(blk)
        return inputs, outputs

    def _o_layer(self, kind, p, h, emb):
        if kind == "conv":
            return self._conv(p, h)
        if kind == "attn":
            return self._o_attn(p, h)
        return self._o_res(p, h, emb, updown={"down": "down", "up": "up"}.get(kind))

    def _o_encode(self, x, t):
        emb = self._lin("time_embed.0", _emb_openai(t, self.ch))
        emb = self._lin("time_embed.2", F.silu(emb))
        inputs, _ = self._o_plan()
        hs, h = [], x
        for blk in inputs:
            for kind, p in blk:
                h = self._o_layer(kind, p, h, emb)
            hs.append(h)
        h = self._o_res("middle_block.0", h, emb)
        h = self._o_attn("middle_block.1", h)
        return self._o_res("middle_block.2", h, emb), hs, emb

    def _o_decode(self, h, hs, emb):
        _, outputs = self._o_plan()
        hs = list(hs)
        for blk in outputs:
            h = torch.cat([h, hs.pop()], dim=1)
            for kind, p in blk:
                h = self._o_layer(kind, p, h, emb)
        return self._conv("out.2", self._gn("out.0", h, silu=True))

    # -- public -------------------------------------------------------------------
    def encode(self, x, t):
        return (self._d_encode if self.family == "ddpmpp" else self._o_encode)(x, t)

    def decode(self, h, hs, temb):
        return (self._d_decode if self.family == "ddpmpp" else self._o_decode)(h, hs, temb)

    def delta(self, h, temb, block: Dict[str, torch.Tensor]):
        """Asyrp's DeltaBlock of this family on the bottleneck h."""
        sub = RefUNet.__new__(RefUNet)
        sub.sd, sub.ops, sub.eps = block, self.ops, self.eps
        if self.family == "ddpmpp":
            x = sub._conv("conv1", h, padding=0)
            x = sub._gn("norm2", x, silu=True, pre_add=sub._lin("temb_proj", F.silu(temb)))
            return sub._conv("conv2", x, padding=0)
        x = sub._conv("in_layers.2", sub._gn("in_layers.0", h, silu=True), padding=0)
        x = sub._gn("out_layers.0", x, silu=True, pre_add=sub._lin("emb_layers.1", F.silu(temb)))
        return sub._conv("out_layers.3", x, padding=0)
