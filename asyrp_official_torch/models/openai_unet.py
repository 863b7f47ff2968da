"""OpenAI-family UNet (iDDPM: AFHQ-dog / FFHQ / IMAGENET; ADM: MetFACE /
CelebA_HQ_P2) — the port of the JAX `models/openai_unet.py`.

An `nn.Module` with the reference's state-dict key names
(`time_embed.{0,2}`, `input_blocks.i.j.{in_layers.{0,2}, emb_layers.1,
out_layers.{0,3}, skip_connection}`, `...qkv` / `...proj_out` as 1-D convs
`[O, I, 1]`, `...op` / `...conv` for the resamplers, `middle_block.*`,
`output_blocks.*`, `out.{0,2}`), so an iDDPM/ADM `.pt` loads with
`load_state_dict`, and `compat/torch_convert.convert_openai_unet` maps its
`state_dict()` to the JAX params. The same static `build_plan` as the JAX
package drives the module, `init_params` and the weight bridge.

Inside it is NCHW; the public boundary of `apply` is NHWC like the JAX
function's. Every GroupNorm (GN32, eps 1e-5, f32 statistics) is kernel K1 —
the attention norm too, since GroupNorm over the flattened [B, T, C] map is
the same function as over the NCHW map — and every attention is kernel K2
with `num_heads` heads and `legacy_scale`.

    apply(x_nhwc, t, edit=None, y=None, decode_mode="auto"|"split")
        -> (eps_raw, eps_mod_raw | None, delta_h | None, middle_h)   all NHWC

The raw outputs keep a `learn_sigma` model's 2C channels; `core/sampler.py`
splits them. The dual decode of an edit is stacked (2B) or split (two B
decodes at batch 1 or with `decode_mode="split"`), as in `models/ddpmpp.py`.
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

__all__ = ["OpenAIUNetConfig", "AFHQ_CONFIG", "METFACE_CONFIG", "IMAGENET_CONFIG", "build_plan",
           "OpenAIUNet", "init_params"]

_EPS = 1e-5  # GroupNorm32 (models/improved_ddpm/nn.py:17-19)


@dataclasses.dataclass(frozen=True)
class OpenAIUNetConfig:
    image_size: int = 256
    in_channels: int = 3
    model_channels: int = 128
    out_channels: int = 6  # learn_sigma
    num_res_blocks: int = 1
    attention_ds: Tuple[int, ...] = (16,)  # downsample rates with attention
    channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    num_classes: Optional[int] = None
    num_heads: int = 4
    num_head_channels: int = 64
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    use_new_attention_order: bool = False
    dropout: float = 0.0
    # recompute every resblock in the backward (`common.remat`): activation
    # memory for FLOPs (the reference's use_checkpoint)
    remat: bool = False

    @property
    def temb_ch(self) -> int:
        return self.model_channels * 4

    @property
    def bottleneck_ch(self) -> int:
        return int(self.channel_mult[-1] * self.model_channels)

    def heads_for(self, ch: int, upsample: bool = False) -> int:
        if self.num_head_channels == -1:
            if upsample and self.num_heads_upsample != -1:
                return self.num_heads_upsample
            return self.num_heads
        return ch // self.num_head_channels


# the reference operating points (script_util dicts; attention "16" is the
# downsample rate 16 at 256px)
AFHQ_CONFIG = OpenAIUNetConfig()  # == FFHQ (improved_ddpm/script_util.py:5-22)
METFACE_CONFIG = OpenAIUNetConfig()  # == CelebA_HQ_P2 (guided_diffusion/script_util.py:10-46)
IMAGENET_CONFIG = OpenAIUNetConfig(model_channels=256, num_res_blocks=2, attention_ds=(8, 16, 32),
                                   num_classes=1000)  # improved_ddpm/script_util.py:25-42


def build_plan(cfg: OpenAIUNetConfig) -> Dict[str, Any]:
    """The layer plan, walked as UNetModel.__init__ builds its ModuleLists
    (the JAX `build_plan`)."""
    mc = cfg.model_channels
    ch = input_ch = int(cfg.channel_mult[0] * mc)
    input_plan: List[List[dict]] = [[{"kind": "conv", "cin": cfg.in_channels, "cout": ch}]]
    chans = [ch]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [{"kind": "res", "cin": ch, "cout": int(mult * mc), "updown": None}]
            ch = int(mult * mc)
            if ds in cfg.attention_ds:
                layers.append({"kind": "attn", "ch": ch, "heads": cfg.heads_for(ch)})
            input_plan.append(layers)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                layers = [{"kind": "res", "cin": ch, "cout": ch, "updown": "down"}]
            else:
                layers = [{"kind": "downsample", "cin": ch, "cout": ch}]
            input_plan.append(layers)
            chans.append(ch)
            ds *= 2

    middle_plan = [
        {"kind": "res", "cin": ch, "cout": ch, "updown": None},
        {"kind": "attn", "ch": ch, "heads": cfg.heads_for(ch)},
        {"kind": "res", "cin": ch, "cout": ch, "updown": None},
    ]

    output_plan: List[List[dict]] = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            layers = [{"kind": "res", "cin": ch + ich, "cout": int(mc * mult), "updown": None}]
            ch = int(mc * mult)
            if ds in cfg.attention_ds:
                layers.append({"kind": "attn", "ch": ch, "heads": cfg.heads_for(ch, upsample=True)})
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    layers.append({"kind": "res", "cin": ch, "cout": ch, "updown": "up"})
                else:
                    layers.append({"kind": "upsample", "cin": ch, "cout": ch})
                ds //= 2
            output_plan.append(layers)

    return {"input": input_plan, "middle": middle_plan, "output": output_plan,
            "out_ch_final": input_ch}


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _slot():
    """A parameterless slot (SiLU, Dropout) of the reference's Sequentials,
    kept so the weights sit at the reference's key indices."""
    return nn.Identity()


class ResBlock(nn.Module):
    """GN+SiLU → (avg-pool | nearest-up of h and x) → 3x3 conv; + emb
    (scale-shift: GN, then h * (1 + scale) + shift) → SiLU → 3x3 conv; the
    1x1 skip when cin != cout (improved_ddpm/unet.py:278-298)."""
    SPAN = prof.RES

    def __init__(self, spec: dict, cfg: OpenAIUNetConfig):
        super().__init__()
        cin, cout = spec["cin"], spec["cout"]
        self.updown, self.scale_shift = spec["updown"], cfg.use_scale_shift_norm
        self.in_layers = nn.ModuleList([cm.GroupNorm(cin, eps=_EPS), _slot(),
                                        nn.Conv2d(cin, cout, 3, padding=1)])
        self.emb_layers = nn.ModuleList([_slot(), nn.Linear(cfg.temb_ch,
                                                            2 * cout if self.scale_shift else cout)])
        self.out_layers = nn.ModuleList([cm.GroupNorm(cout, eps=_EPS), _slot(), _slot(),
                                         nn.Conv2d(cout, cout, 3, padding=1)])
        if cin != cout:
            self.skip_connection = nn.Conv2d(cin, cout, 1)

    def forward(self, x, emb):
        h = self.in_layers[0](x, silu=True)
        if self.updown == "down":
            h, x = cm.avg_pool_2x(h), cm.avg_pool_2x(x)
        elif self.updown == "up":
            h, x = cm.upsample_nearest_2x(h), cm.upsample_nearest_2x(x)
        h = cm.conv2d(self.in_layers[2], h)
        emb_out = cm.linear(self.emb_layers[1], F.silu(emb))  # [B, 2C] or [B, C]
        if self.scale_shift:
            # GN, h * (1 + scale) + shift, SiLU: each step rounded in the
            # activation dtype, as the JAX order rounds; one K1 launch when serving
            h = self.out_layers[0](h, silu=True, scale_shift=emb_out)
        else:
            h = self.out_layers[0](h, silu=True, pre_add=emb_out)
        h = cm.conv2d(self.out_layers[3], h)
        if hasattr(self, "skip_connection"):
            x = cm.mat1x1(self.skip_connection, x)
        return x + h


class AttentionBlock(nn.Module):
    """GN → qkv (1-D 1x1 conv) → multi-head attention with the legacy scale
    → proj_out, residual (improved_ddpm/unet.py:301-347). The qkv channels
    are [H][3][d] (legacy order) or [3][H][d] (`use_new_attention_order`)."""
    SPAN = prof.ATTN

    def __init__(self, spec: dict, cfg: OpenAIUNetConfig):
        super().__init__()
        ch = spec["ch"]
        self.heads, self.new_order = spec["heads"], cfg.use_new_attention_order
        self.norm = cm.GroupNorm(ch, eps=_EPS)
        self.qkv = nn.Conv1d(ch, 3 * ch, 1)
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, x, emb=None):
        b, c, hh, ww = x.shape
        t, d = hh * ww, c // self.heads
        flat = self.norm(x).flatten(2).transpose(1, 2)  # [B, T, C]
        qkv = F.linear(flat, cm._cast(self.qkv.weight[:, :, 0], flat.dtype),
                       cm._cast(self.qkv.bias, flat.dtype))
        if self.new_order:
            q, k, v = qkv.reshape(b, t, 3, self.heads, d).unbind(2)
        else:
            q, k, v = qkv.reshape(b, t, self.heads, 3, d).unbind(3)
        q, k, v = (a.reshape(b, t, c).contiguous() for a in (q, k, v))  # K2 reads [B, T, C]
        sg = spatial.active()
        if sg is not None:  # this rank's query rows against the whole image's keys
            k, v = spatial.gather(k, 1, sg), spatial.gather(v, 1, sg)
        out = _k2.attention(q, k, v, num_heads=self.heads, legacy_scale=True)
        out = F.linear(out, cm._cast(self.proj_out.weight[:, :, 0], out.dtype),
                       cm._cast(self.proj_out.bias, out.dtype))
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


class _InConv(nn.Conv2d):
    """input_blocks.0.0: the bare 3x3 conv."""
    SPAN = prof.CONV

    def forward(self, x, emb=None):
        return cm.conv2d(self, x)


class Downsample(nn.Module):
    """The stride-2 3x3 conv, padded (1, 1) as torch pads it."""
    SPAN = prof.RESAMPLE

    def __init__(self, ch: int):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x, emb=None):
        return cm.conv2d(self.op, x, stride=2, padding=1)


class Upsample(nn.Module):
    SPAN = prof.RESAMPLE

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x, emb=None):
        return cm.conv2d(self.conv, cm.upsample_nearest_2x(x))


def _layer(spec: dict, cfg: OpenAIUNetConfig) -> nn.Module:
    kind = spec["kind"]
    if kind == "res":
        return ResBlock(spec, cfg)
    if kind == "attn":
        return AttentionBlock(spec, cfg)
    if kind == "conv":
        return _InConv(spec["cin"], spec["cout"], 3, padding=1)
    if kind == "downsample":
        return Downsample(spec["cin"])
    if kind == "upsample":
        return Upsample(spec["cin"])
    raise ValueError(kind)


class OpenAIUNet(nn.Module):
    def __init__(self, cfg: OpenAIUNetConfig):
        super().__init__()
        self.cfg = cfg
        plan = build_plan(cfg)
        mc, temb = cfg.model_channels, cfg.temb_ch
        self.time_embed = nn.ModuleList([nn.Linear(mc, temb), _slot(), nn.Linear(temb, temb)])
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, temb)
        self.input_blocks = nn.ModuleList(
            nn.ModuleList(_layer(s, cfg) for s in block) for block in plan["input"])
        self.middle_block = nn.ModuleList(_layer(s, cfg) for s in plan["middle"])
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(_layer(s, cfg) for s in block) for block in plan["output"])
        ch = plan["out_ch_final"]
        self.out = nn.ModuleList([cm.GroupNorm(ch, eps=_EPS), _slot(),
                                  nn.Conv2d(ch, cfg.out_channels, 3, padding=1)])

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """`nn.Module.load_state_dict`, except that a class-conditional
        UNet takes a state dict without `label_emb.weight` (ADM's released
        unconditional checkpoint, which `imagenet.yml` reads under
        `class_cond: true`): the embedding is then dropped, as the JAX tree
        keeps no `label_emb` leaf, and `get_temb` ignores `y`. Any other
        missing or unexpected key still raises under `strict`."""
        if hasattr(self, "label_emb") and "label_emb.weight" not in state_dict:
            del self.label_emb
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    # -- forward pieces (JAX openai_unet.py get_temb / apply / _decode)
    def get_temb(self, t, y=None):
        emb = cm.timestep_embedding_openai(t, self.cfg.model_channels)
        emb = cm.linear(self.time_embed[0], emb)
        emb = cm.linear(self.time_embed[2], F.silu(emb))
        # the reference builds label_emb but never adds it (Asyrp passes no
        # labels); kept behind `y` as in the JAX package
        if y is not None and hasattr(self, "label_emb"):
            emb = emb + self.label_emb.weight[y]
        return emb

    def _layer(self, layer, h, emb):
        """One layer, in its span; a resblock recomputed in the backward
        under `cfg.remat` (the JAX `_apply_layer`)."""
        with prof.span(layer.SPAN):
            if self.cfg.remat and isinstance(layer, ResBlock):
                return cm.remat(layer, h, emb)
            return layer(h, emb)

    def _encode(self, x, emb):
        hs, h = [], x
        with prof.span(prof.ENCODE):
            for block in self.input_blocks:
                for layer in block:
                    h = self._layer(layer, h, emb)
                hs.append(h)
            for layer in self.middle_block:
                h = self._layer(layer, h, emb)
        return h, hs

    def _decode(self, h, hs, emb):
        hs = list(hs)
        with prof.span(prof.DECODE):
            for block in self.output_blocks:
                h = torch.cat([h, hs.pop()], dim=1)
                for layer in block:
                    h = self._layer(layer, h, emb)
            with prof.span(prof.CONV):
                return cm.conv2d(self.out[2], self.out[0](h, silu=True))

    def apply(self, x_nhwc, t, edit: Optional[EditState] = None, y=None,
              decode_mode: str = "auto"):
        if decode_mode not in ("auto", "split"):
            raise ValueError(f"decode_mode must be 'auto'|'split', got {decode_mode!r}")
        size = self.cfg.image_size
        if x_nhwc.shape[1] != spatial.local_height(size) or x_nhwc.shape[2] != size:
            raise ValueError(f"expected {size}^2 input, got {tuple(x_nhwc.shape)}")
        x = x_nhwc.permute(0, 3, 1, 2).contiguous()
        split = edit is not None and (x.shape[0] == 1 or decode_mode == "split")
        # split: only the edited decode, from h + Δh, carries a graph
        with torch.no_grad() if split else contextlib.nullcontext():
            # the embedding MLP runs in f32; cast so a bf16 network stays bf16
            emb = self.get_temb(t, y).to(x.dtype)
            h, hs = self._encode(x, emb)
            eps = self._decode(h, hs, emb) if split else None
        if edit is None:
            return _nhwc(self._decode(h, hs, emb)), None, None, _nhwc(h)
        h2, delta_h = apply_edit(edit, h, emb)
        if split:
            eps_mod = self._decode(h2, hs, emb)
        else:
            out = self._decode(torch.cat([h, h2]), [torch.cat([s, s]) for s in hs],
                               torch.cat([emb, emb]))
            eps, eps_mod = out.chunk(2)
        return (_nhwc(eps), _nhwc(eps_mod),
                None if delta_h is None else _nhwc(delta_h), _nhwc(h))

    forward = apply


# ---------------------------------------------------------------------------
# random init in the JAX layout, bit-identical to the JAX `openai_unet.init`
# ---------------------------------------------------------------------------


def _res_init(key, spec, cfg):
    ks = hostrng.split(key, 4)
    cin, cout = spec["cin"], spec["cout"]
    emb_out = 2 * cout if cfg.use_scale_shift_norm else cout
    p = {
        "in_norm": hostinit.norm_init(cin),
        "in_conv": hostinit.conv_init(ks[0], 3, 3, cin, cout),
        "emb": hostinit.linear_init(ks[1], cfg.temb_ch, emb_out),
        "out_norm": hostinit.norm_init(cout),
        "out_conv": hostinit.conv_init(ks[2], 3, 3, cout, cout, zero=True),
    }
    if cin != cout:
        p["skip_mat"] = hostinit.linear_init(ks[3], cin, cout)
    return p


def _attn_init(key, spec):
    ks = hostrng.split(key, 2)
    ch = spec["ch"]
    return {
        "norm": hostinit.norm_init(ch),
        "qkv": hostinit.linear_init(ks[0], ch, ch * 3),
        "proj_out": hostinit.linear_init(ks[1], ch, ch, zero=True),
    }


def _layer_init(key, spec, cfg):
    if spec["kind"] == "res":
        return _res_init(key, spec, cfg)
    if spec["kind"] == "attn":
        return _attn_init(key, spec)
    return hostinit.conv_init(key, 3, 3, spec["cin"], spec["cout"])


def init_params(key: np.ndarray, cfg: OpenAIUNetConfig) -> Dict[str, Any]:
    """The JAX `openai_unet.init(key, cfg)` tree for a numpy (hostrng) key,
    zero leaves (the resblocks' and the final `out_conv`, the attention
    `proj_out`) included. A class-conditional config draws `label_emb`
    (0.02 N(0, 1)) from the third key of the split, between `time_embed`
    and the input blocks, as the JAX init does."""
    plan = build_plan(cfg)
    keys = iter(hostrng.split(key, 4096))
    nxt = lambda: next(keys)
    params: Dict[str, Any] = {
        "time_embed": {
            "dense0": hostinit.linear_init(nxt(), cfg.model_channels, cfg.temb_ch),
            "dense1": hostinit.linear_init(nxt(), cfg.temb_ch, cfg.temb_ch),
        }
    }
    if cfg.num_classes is not None:
        params["label_emb"] = {
            "w": hostrng.normal(nxt(), (cfg.num_classes, cfg.temb_ch)) * np.float32(0.02)}
    params["input_blocks"] = [[_layer_init(nxt(), s, cfg) for s in block] for block in plan["input"]]
    params["middle_block"] = [_layer_init(nxt(), s, cfg) for s in plan["middle"]]
    params["output_blocks"] = [[_layer_init(nxt(), s, cfg) for s in block]
                               for block in plan["output"]]
    params["out_norm"] = hostinit.norm_init(plan["out_ch_final"])
    params["out_conv"] = hostinit.conv_init(nxt(), 3, 3, plan["out_ch_final"], cfg.out_channels,
                                            zero=True)
    return params
