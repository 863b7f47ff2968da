"""CLIP's ModifiedResNet visual tower (RN50) — the port of the JAX
`losses/clip_resnet.py`, the CNN tower of the texture loss.

OpenAI's ModifiedResNet differs from torchvision's ResNet: a 3-conv stem
ending in a 2x2 average pool, anti-aliased bottlenecks (a stride-s block
average-pools before its last 1x1 conv, and its shortcut pools before its
1x1 conv), and an attention pool instead of GAP + fc: the mean token plus a
positional embedding, one query (the mean) over the HW + 1 tokens.

Inference only: BatchNorm from its running statistics (eps 1e-5); the
output is differentiable with respect to the image. The state-dict keys are
those of OpenAI's `visual.*` (without the prefix), so `from_state_dict`
reads the layout the JAX package's `clip_resnet.params_from_torch` reads.
The pool's attention was never a Pallas kernel: plain torch ops.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["RN50Config", "RN50", "ModifiedResNet", "from_state_dict"]


@dataclasses.dataclass(frozen=True)
class RN50Config:
    layers: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    embed_dim: int = 1024
    heads: int = 32
    image_resolution: int = 224

    @property
    def spacial_dim(self) -> int:
        return self.image_resolution // 32


RN50 = RN50Config()


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            # OpenAI's Sequential("-1": AvgPool2d, "0": conv, "1": bn): the
            # pool holds no parameters, so the keys are downsample.0 and .1
            self.downsample = nn.Sequential()
            self.downsample.add_module("0", nn.Conv2d(inplanes, planes * 4, 1, bias=False))
            self.downsample.add_module("1", _bn(planes * 4))

    def _pool(self, x):
        return F.avg_pool2d(x, self.stride) if self.stride > 1 else x

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self._pool(out)))
        if self.downsample is not None:
            x = self.downsample(self._pool(x))
        return F.relu(out + x)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial_dim: int, embed_dim: int, heads: int, output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)
        self.heads = heads

    def forward(self, x):
        b, c = x.shape[:2]
        flat = x.flatten(2).transpose(1, 2)                      # [B, HW, C]
        flat = torch.cat([flat.mean(dim=1, keepdim=True), flat], dim=1)
        flat = flat + self.positional_embedding.to(flat.dtype)
        t, ch = flat.shape[1], c // self.heads
        q = self.q_proj(flat[:, :1]).reshape(b, 1, self.heads, ch).transpose(1, 2)
        k = self.k_proj(flat).reshape(b, t, self.heads, ch).transpose(1, 2)
        v = self.v_proj(flat).reshape(b, t, self.heads, ch).transpose(1, 2)
        wgt = torch.softmax(q @ k.transpose(-1, -2) * ch ** -0.5, dim=-1)
        return self.c_proj((wgt @ v).transpose(1, 2).reshape(b, c))


class ModifiedResNet(nn.Module):
    """The RN50 tower of `cfg`. `seed` draws a random init (convs and the
    pool's matrices normal with std fan_in^-½, BatchNorm at identity
    statistics) from a CPU `torch.Generator`; `seed=None` leaves the weights
    to `load_state_dict`."""

    def __init__(self, cfg: RN50Config = RN50, seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = nn.Conv2d(3, w // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = _bn(w // 2)
        self.conv2 = nn.Conv2d(w // 2, w // 2, 3, padding=1, bias=False)
        self.bn2 = _bn(w // 2)
        self.conv3 = nn.Conv2d(w // 2, w, 3, padding=1, bias=False)
        self.bn3 = _bn(w)
        inplanes = w
        for li, n in enumerate(cfg.layers):
            planes = w * 2 ** li
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(inplanes, planes, 2 if li > 0 and bi == 0 else 1))
                inplanes = planes * 4
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(cfg.spacial_dim, w * 32, cfg.heads, cfg.embed_dim)
        self.eval()
        if seed is not None:
            self._random_init(seed)

    @torch.no_grad()
    def _random_init(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * fan ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
        pos = self.attnpool.positional_embedding
        pos.copy_(torch.randn(pos.shape, generator=gen) * pos.shape[1] ** -0.5)

    def train(self, mode: bool = True):
        """Inference only: the BatchNorms always read their running
        statistics."""
        return super().train(False)

    def encode_image(self, images_nhwc):
        """images: [B, H, W, 3] NHWC, CLIP-normalized → [B, embed_dim]."""
        x = images_nhwc.permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.avg_pool2d(x, 2)
        for li in range(len(self.cfg.layers)):
            x = getattr(self, f"layer{li + 1}")(x)
        return self.attnpool(x)

    forward = encode_image


def from_state_dict(sd: Dict[str, np.ndarray], cfg: RN50Config = RN50) -> ModifiedResNet:
    """An RN50 tower holding the `visual.*` entries of an OpenAI RN50 CLIP
    state dict (fp16 or fp32 values) in f32; the text tower's entries are
    ignored."""
    pre = "visual."
    model = ModifiedResNet(cfg, seed=None)
    own = model.state_dict()
    model.load_state_dict({k: (torch.as_tensor(np.asarray(sd[pre + k], np.float32))
                               if pre + k in sd else own[k])
                           for k in own if pre + k in sd or k.endswith("num_batches_tracked")})
    return model
