"""DDPM++ UNet (CelebA-HQ / LSUN / CUSTOM) — the port of the JAX
`models/ddpmpp.py`.

An `nn.Module` with the reference's state-dict key names
(`down.{i}.block.{j}.norm1.weight`, ...), so a released `.ckpt` loads with
`load_state_dict`, and `compat/torch_convert.convert_ddpmpp` maps its
`state_dict()` to the JAX params. Inside it is NCHW; the public boundary of
`apply` is NHWC like the JAX function's. Every GroupNorm(+SiLU) is kernel K1
and every attention kernel K2.

    apply(x_nhwc, t, edit=None, decode_mode="auto"|"split")
        -> (eps, eps_mod | None, delta_h | None, middle_h)   all NHWC

With an edit, the encoder runs once and the decoder twice (on h and on the
edited h2): stacked into one 2B decode, or as two B decodes at batch 1 or
with `decode_mode="split"` — the same math either way. The split decode is
the training mode: the encoder, the middle block and the plain decode run
under `torch.no_grad()`, and only the edited decode carries a graph.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from asyrp_official_torch.models import common as cm
from asyrp_official_torch.models import hostinit
from asyrp_official_torch.models.delta import EditState, apply_edit
from asyrp_official_torch.ops import attention as _k2
from asyrp_official_torch.parallel import spatial
from asyrp_official_torch.utils import hostrng
from asyrp_official_torch.utils import profiling as prof

__all__ = ["DDPMppConfig", "CELEBA_CONFIG", "DDPMpp", "init_params"]


@dataclasses.dataclass(frozen=True)
class DDPMppConfig:
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.0
    in_channels: int = 3
    resolution: int = 256
    resamp_with_conv: bool = True
    # recompute the encoder's and decoder's resblocks in the backward
    # (`common.remat`): activation memory for FLOPs when training Δ
    remat: bool = False

    @property
    def temb_ch(self) -> int:
        return self.ch * 4

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def bottleneck_ch(self) -> int:
        return self.ch * self.ch_mult[-1]

    def level_resolutions(self) -> List[int]:
        res = [self.resolution]
        for _ in range(self.num_resolutions - 1):
            res.append(res[-1] // 2)
        return res


CELEBA_CONFIG = DDPMppConfig()


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _lin1x1(conv: nn.Conv2d, flat):
    """A 1x1 conv applied to [B, T, C] tokens."""
    return F.linear(flat, cm._cast(conv.weight[:, :, 0, 0], flat.dtype),
                    cm._cast(conv.bias, flat.dtype))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_ch: int):
        super().__init__()
        self.norm1 = cm.GroupNorm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.temb_proj = nn.Linear(temb_ch, cout)
        self.norm2 = cm.GroupNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb):
        h = cm.conv2d(self.conv1, self.norm1(x, silu=True))
        # h + temb_proj(temb), then GroupNorm+SiLU: one K1 launch when serving
        h = self.norm2(h, silu=True, pre_add=cm.linear(self.temb_proj, F.silu(temb)))
        h = cm.conv2d(self.conv2, h)
        if hasattr(self, "nin_shortcut"):
            x = cm.mat1x1(self.nin_shortcut, x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.norm = cm.GroupNorm(ch)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        with prof.span(prof.ATTN):
            b, c, hh, ww = x.shape
            flat = self.norm(x).flatten(2).transpose(1, 2)  # [B, T, C]
            q, k, v = (_lin1x1(conv, flat) for conv in (self.q, self.k, self.v))
            sg = spatial.active()
            if sg is not None:  # this rank's query rows against the whole image's keys
                k, v = spatial.gather(k, 1, sg), spatial.gather(v, 1, sg)
            out = _k2.attention(q, k, v)
            out = _lin1x1(self.proj_out, out)
            return x + out.transpose(1, 2).reshape(b, c, hh, ww)


class _Resample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class _Temb(nn.Module):
    def __init__(self, ch: int, temb_ch: int):
        super().__init__()
        self.dense = nn.ModuleList([nn.Linear(ch, temb_ch), nn.Linear(temb_ch, temb_ch)])


class DDPMpp(nn.Module):
    def __init__(self, cfg: DDPMppConfig):
        super().__init__()
        self.cfg = cfg
        level_res = cfg.level_resolutions()
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        self.temb = _Temb(cfg.ch, cfg.temb_ch)
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)

        self.down = nn.ModuleList()
        block_in = cfg.ch
        for i_level in range(cfg.num_resolutions):
            block_in = cfg.ch * in_ch_mult[i_level]
            block_out = cfg.ch * cfg.ch_mult[i_level]
            lvl = _Level()
            for _ in range(cfg.num_res_blocks):
                lvl.block.append(ResnetBlock(block_in, block_out, cfg.temb_ch))
                block_in = block_out
                if level_res[i_level] in cfg.attn_resolutions:
                    lvl.attn.append(AttnBlock(block_in))
            if i_level != cfg.num_resolutions - 1 and cfg.resamp_with_conv:
                lvl.downsample = _Resample(block_in)
            self.down.append(lvl)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, cfg.temb_ch)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, cfg.temb_ch)

        up: List[Optional[_Level]] = [None] * cfg.num_resolutions
        curr_res = level_res[-1]
        for i_level in reversed(range(cfg.num_resolutions)):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            skip_in = cfg.ch * cfg.ch_mult[i_level]
            lvl = _Level()
            for i_block in range(cfg.num_res_blocks + 1):
                if i_block == cfg.num_res_blocks:
                    skip_in = cfg.ch * in_ch_mult[i_level]
                lvl.block.append(ResnetBlock(block_in + skip_in, block_out, cfg.temb_ch))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    lvl.attn.append(AttnBlock(block_in))
            if i_level != 0:
                if cfg.resamp_with_conv:
                    lvl.upsample = _Resample(block_in)
                curr_res *= 2
            up[i_level] = lvl
        self.up = nn.ModuleList(up)
        self.norm_out = cm.GroupNorm(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)

    # -- forward pieces (JAX ddpmpp.py get_temb / _encode / _middle / _decode)
    def get_temb(self, t):
        temb = cm.timestep_embedding_ddpm(t, self.cfg.ch)
        temb = cm.linear(self.temb.dense[0], temb)
        return cm.linear(self.temb.dense[1], F.silu(temb))

    def _resblock(self, block, x, temb):
        """An encoder or decoder resblock, recomputed in the backward under
        `cfg.remat` (the JAX `_block_fn`; the middle blocks, where Δh
        enters, are never wrapped)."""
        with prof.span(prof.RES):
            return cm.remat(block, x, temb) if self.cfg.remat else block(x, temb)

    def _encode(self, x, temb):
        cfg = self.cfg
        with prof.span(prof.CONV):
            hs = [cm.conv2d(self.conv_in, x)]
        for i_level in range(cfg.num_resolutions):
            lvl = self.down[i_level]
            for i_block in range(cfg.num_res_blocks):
                h = self._resblock(lvl.block[i_block], hs[-1], temb)
                if len(lvl.attn):
                    h = lvl.attn[i_block](h)
                hs.append(h)
            if i_level != cfg.num_resolutions - 1:
                with prof.span(prof.RESAMPLE):
                    hs.append(
                        cm.downsample_pad_conv(lvl.downsample.conv, hs[-1])
                        if cfg.resamp_with_conv
                        else cm.avg_pool_2x(hs[-1])
                    )
        return hs

    def _middle(self, h, temb):
        with prof.span(prof.RES):
            h = self.mid.block_1(h, temb)
        h = self.mid.attn_1(h)
        with prof.span(prof.RES):
            return self.mid.block_2(h, temb)

    def _decode(self, h, hs, temb):
        cfg = self.cfg
        hs = list(hs)
        with prof.span(prof.DECODE):
            for i_level in reversed(range(cfg.num_resolutions)):
                lvl = self.up[i_level]
                for i_block in range(cfg.num_res_blocks + 1):
                    h = self._resblock(lvl.block[i_block], torch.cat([h, hs.pop()], dim=1), temb)
                    if len(lvl.attn):
                        h = lvl.attn[i_block](h)
                if i_level != 0:
                    with prof.span(prof.RESAMPLE):
                        h = cm.upsample_nearest_2x(h)
                        if cfg.resamp_with_conv:
                            h = cm.conv2d(lvl.upsample.conv, h)
            with prof.span(prof.CONV):
                return cm.conv2d(self.conv_out, self.norm_out(h, silu=True))

    def apply(self, x_nhwc, t, edit: Optional[EditState] = None, decode_mode: str = "auto"):
        if decode_mode not in ("auto", "split"):
            raise ValueError(f"decode_mode must be 'auto'|'split', got {decode_mode!r}")
        if (x_nhwc.shape[1] != spatial.local_height(self.cfg.resolution)
                or x_nhwc.shape[2] != self.cfg.resolution):
            raise ValueError(f"expected {self.cfg.resolution}^2 input, got {tuple(x_nhwc.shape)}")
        x = x_nhwc.permute(0, 3, 1, 2).contiguous()
        split = edit is not None and (x.shape[0] == 1 or decode_mode == "split")
        # split: only the edited decode, from h + Δh, carries a graph (what
        # the DeltaBlock's gradient needs); the rest of the frozen network
        # runs without one
        with torch.no_grad() if split else contextlib.nullcontext():
            # the embedding MLP runs in f32; cast so a bf16 network stays bf16
            temb = self.get_temb(t).to(x.dtype)
            with prof.span(prof.ENCODE):
                hs = self._encode(x, temb)
                h = self._middle(hs[-1], temb)
            eps = self._decode(h, hs, temb) if split else None
        if edit is None:
            return _nhwc(self._decode(h, hs, temb)), None, None, _nhwc(h)
        h2, delta_h = apply_edit(edit, h, temb)
        if split:
            eps_mod = self._decode(h2, hs, temb)
        else:
            out = self._decode(
                torch.cat([h, h2]), [torch.cat([s, s]) for s in hs], torch.cat([temb, temb])
            )
            eps, eps_mod = out.chunk(2)
        return (_nhwc(eps), _nhwc(eps_mod),
                None if delta_h is None else _nhwc(delta_h), _nhwc(h))

    forward = apply


# ---------------------------------------------------------------------------
# random init in the JAX layout, bit-identical to the JAX `ddpmpp.init`
# ---------------------------------------------------------------------------


def _resblock_init(key, cin, cout, temb_ch):
    ks = hostrng.split(key, 4)
    p = {
        "norm1": hostinit.norm_init(cin),
        "conv1": hostinit.conv_init(ks[0], 3, 3, cin, cout),
        "temb_proj": hostinit.linear_init(ks[1], temb_ch, cout),
        "norm2": hostinit.norm_init(cout),
        "conv2": hostinit.conv_init(ks[2], 3, 3, cout, cout),
    }
    if cin != cout:
        p["nin_shortcut"] = hostinit.linear_init(ks[3], cin, cout)
    return p


def _attn_init(key, ch):
    ks = hostrng.split(key, 4)
    return {
        "norm": hostinit.norm_init(ch),
        "q": hostinit.linear_init(ks[0], ch, ch),
        "k": hostinit.linear_init(ks[1], ch, ch),
        "v": hostinit.linear_init(ks[2], ch, ch),
        "proj_out": hostinit.linear_init(ks[3], ch, ch),
    }


def init_params(key: np.ndarray, cfg: DDPMppConfig) -> Dict[str, Any]:
    """The JAX `ddpmpp.init(key, cfg)` tree for a numpy (hostrng) key."""
    keys = iter(hostrng.split(key, 4096))
    nxt = lambda: next(keys)
    params: Dict[str, Any] = {
        "temb": {
            "dense0": hostinit.linear_init(nxt(), cfg.ch, cfg.temb_ch),
            "dense1": hostinit.linear_init(nxt(), cfg.temb_ch, cfg.temb_ch),
        },
        "conv_in": hostinit.conv_init(nxt(), 3, 3, cfg.in_channels, cfg.ch),
    }
    level_res = cfg.level_resolutions()
    in_ch_mult = (1,) + tuple(cfg.ch_mult)
    down = []
    block_in = cfg.ch
    for i_level in range(cfg.num_resolutions):
        block_in = cfg.ch * in_ch_mult[i_level]
        block_out = cfg.ch * cfg.ch_mult[i_level]
        blocks, attns = [], []
        for _ in range(cfg.num_res_blocks):
            blocks.append(_resblock_init(nxt(), block_in, block_out, cfg.temb_ch))
            block_in = block_out
            if level_res[i_level] in cfg.attn_resolutions:
                attns.append(_attn_init(nxt(), block_in))
        lvl = {"block": blocks, "attn": attns}
        if i_level != cfg.num_resolutions - 1 and cfg.resamp_with_conv:
            lvl["downsample"] = hostinit.conv_init(nxt(), 3, 3, block_in, block_in)
        down.append(lvl)
    params["down"] = down
    params["mid"] = {
        "block_1": _resblock_init(nxt(), block_in, block_in, cfg.temb_ch),
        "attn_1": _attn_init(nxt(), block_in),
        "block_2": _resblock_init(nxt(), block_in, block_in, cfg.temb_ch),
    }
    up: List[Optional[dict]] = [None] * cfg.num_resolutions
    curr_res = level_res[-1]
    for i_level in reversed(range(cfg.num_resolutions)):
        block_out = cfg.ch * cfg.ch_mult[i_level]
        skip_in = cfg.ch * cfg.ch_mult[i_level]
        blocks, attns = [], []
        for i_block in range(cfg.num_res_blocks + 1):
            if i_block == cfg.num_res_blocks:
                skip_in = cfg.ch * in_ch_mult[i_level]
            blocks.append(_resblock_init(nxt(), block_in + skip_in, block_out, cfg.temb_ch))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                attns.append(_attn_init(nxt(), block_in))
        lvl = {"block": blocks, "attn": attns}
        if i_level != 0:
            if cfg.resamp_with_conv:
                lvl["upsample"] = hostinit.conv_init(nxt(), 3, 3, block_in, block_in)
            curr_res *= 2
        up[i_level] = lvl
    params["up"] = up
    params["norm_out"] = hostinit.norm_init(block_in)
    params["conv_out"] = hostinit.conv_init(nxt(), 3, 3, block_in, cfg.out_ch)
    return params
