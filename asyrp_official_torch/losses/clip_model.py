"""CLIP ViT — the port of the JAX package's `losses/clip_model.py`: the
vision transformer and the text transformer of OpenAI CLIP as an
`nn.Module` whose state-dict keys are OpenAI's, so an OpenAI `clip`
checkpoint loads with `load_state_dict` and the JAX package's
`clip_model.params_from_torch` reads this module's `state_dict()`.

  * QuickGELU (x * sigmoid(1.702 x)), pre-LN residual attention blocks with
    a packed `in_proj`;
  * vision: patch conv (no bias) → [CLS] + positional embedding → `ln_pre` →
    transformer → `ln_post` on [CLS] → `proj`;
  * text: token + positional embedding → causal transformer → `ln_final` →
    the features at each row's EOT (argmax token id) → `text_projection`.

This attention was never a Pallas kernel: it is plain `torch.matmul` and
softmax. Images enter NHWC, CLIP-normalized (`clip_loss.clip_preprocess`).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["CLIPConfig", "VIT_B16", "VIT_B32", "CLIP", "config_from_torch", "from_state_dict"]

# scalars an OpenAI TorchScript archive keeps beside the weights
_META_KEYS = ("input_resolution", "context_length", "vocab_size")


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 16
    # text
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64

    @property
    def grid(self) -> int:
        return self.image_resolution // self.vision_patch_size


VIT_B16 = CLIPConfig(vision_patch_size=16)
VIT_B32 = CLIPConfig(vision_patch_size=32)


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class MultiheadAttention(nn.Module):
    """`nn.MultiheadAttention`'s parameters (packed `in_proj`, `out_proj`)
    with the attention written out."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask=None):
        b, t, c = x.shape
        ch = c // self.heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (z.reshape(b, t, self.heads, ch).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
        logits = torch.matmul(q, k.transpose(-1, -2)) * (ch ** -0.5)
        if mask is not None:
            logits = logits + mask
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, c))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = MultiheadAttention(width, heads)
        self.ln_1 = nn.LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(4 * width, width)),
        ]))
        self.ln_2 = nn.LayerNorm(width)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads) for _ in range(layers)])

    def forward(self, x, mask=None):
        for blk in self.resblocks:
            x = blk(x, mask)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w, p = cfg.vision_width, cfg.vision_patch_size
        self.conv1 = nn.Conv2d(3, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.grid * cfg.grid + 1, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads)
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, images_nhwc):
        x = self.conv1(images_nhwc.permute(0, 3, 1, 2))  # [B, W, g, g]
        x = x.flatten(2).transpose(1, 2)  # [B, g*g, W]
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0, :]) @ self.proj


class CLIP(nn.Module):
    """The two towers with OpenAI's state-dict keys. `seed` draws a random
    init (normal, the JAX package's `clip_model.init` scales) from a CPU
    `torch.Generator`; `seed=None` leaves the weights to `load_state_dict`."""

    def __init__(self, cfg: CLIPConfig, seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        tw = cfg.transformer_width
        self.visual = VisionTransformer(cfg)
        self.token_embedding = nn.Embedding(cfg.vocab_size, tw)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, tw))
        self.transformer = Transformer(tw, cfg.transformer_layers, cfg.transformer_heads)
        self.ln_final = nn.LayerNorm(tw)
        self.text_projection = nn.Parameter(torch.empty(tw, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))
        if seed is not None:
            self._random_init(seed)

    @torch.no_grad()
    def _random_init(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        vw, tw = self.cfg.vision_width, self.cfg.transformer_width

        def normal_(p, std):
            p.copy_(torch.randn(p.shape, generator=gen) * std)

        for tower, width in ((self.visual.transformer, vw), (self.transformer, tw)):
            for blk in tower.resblocks:
                normal_(blk.attn.in_proj_weight, width ** -0.5)
                normal_(blk.attn.out_proj.weight, width ** -0.5)
                normal_(blk.mlp.c_fc.weight, width ** -0.5)
                normal_(blk.mlp.c_proj.weight, width ** -0.5)
                for lin in (blk.attn.out_proj, blk.mlp.c_fc, blk.mlp.c_proj):
                    lin.bias.zero_()
        normal_(self.visual.conv1.weight, vw ** -0.5)
        normal_(self.visual.class_embedding, vw ** -0.5)
        normal_(self.visual.positional_embedding, vw ** -0.5)
        normal_(self.visual.proj, vw ** -0.5)
        normal_(self.token_embedding.weight, 0.02)
        normal_(self.positional_embedding, 0.01)
        normal_(self.text_projection, tw ** -0.5)

    def encode_image(self, images_nhwc):
        """images: [B, H, W, 3] NHWC, already CLIP-normalized."""
        return self.visual(images_nhwc)

    def encode_text(self, tokens):
        """tokens: [B, context_length] int. EOT = argmax token id per row."""
        x = self.token_embedding(tokens) + self.positional_embedding
        t = self.cfg.context_length
        mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)
        x = self.ln_final(self.transformer(x, mask))
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection


def config_from_torch(sd: Dict[str, np.ndarray]) -> CLIPConfig:
    """The CLIPConfig of an OpenAI state dict (as `clip.model.build_model`
    infers it)."""
    vision_width = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    vision_layers = len(
        {k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")})
    tw = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=grid * patch,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=patch,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=tw,
        transformer_heads=tw // 64,
        transformer_layers=len(
            {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}),
    )


def from_state_dict(sd: Dict[str, np.ndarray]) -> CLIP:
    """A CLIP module holding an OpenAI state dict (fp16 or fp32 values) in f32."""
    sd = {k: v for k, v in sd.items() if k not in _META_KEYS}
    model = CLIP(config_from_torch(sd), seed=None)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()})
    return model
