"""ArcFace ID loss — the port of the JAX package's `losses/id_loss.py`:
IR-SE50 and the reference's IDLoss (its `losses/id_loss.py:7-35`,
`models/insight_face/model_irse.py:49-124`, `helpers.py`).

`IRSE50` carries the reference `Backbone(112, 50, 'ir_se')`'s parameter
names (`input_layer.*`, `body.{i}.res_layer.*`, `body.{i}.shortcut_layer.*`,
`output_layer.*`), so `ir_se50.pth` loads into it with a strict
`load_state_dict`. It runs in inference mode (BatchNorm on its running
statistics, dropout off) and is frozen: the gradient reaches the input
image only. Images are NCHW in [-1, 1]; convolutions and GEMMs go to cuDNN
and cuBLAS.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["IRSE50_BLOCKS", "IRSE50"]

# (in_channel, depth, stride) per bottleneck — get_blocks(50) (helpers.py:88-95)
IRSE50_BLOCKS: List[Tuple[int, int, int]] = (
    [(64, 64, 2)] + [(64, 64, 1)] * 2
    + [(64, 128, 2)] + [(128, 128, 1)] * 3
    + [(128, 256, 2)] + [(256, 256, 1)] * 13
    + [(256, 512, 2)] + [(512, 512, 1)] * 2
)


class SEModule(nn.Module):
    """Squeeze-excite (helpers.py:115-131); the 1x1 convs have no bias."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class BottleneckIRSE(nn.Module):
    """bottleneck_IR_SE: the stride sits on the residual branch's second
    conv; the shortcut is `MaxPool2d(1, stride)` (a strided slice) where the
    depth is kept, else a strided 1x1 conv and BatchNorm."""

    def __init__(self, cin: int, depth: int, stride: int):
        super().__init__()
        self.stride = stride
        if cin == depth:
            self.shortcut_layer = nn.MaxPool2d(1, stride)
        else:
            self.shortcut_layer = nn.Sequential(nn.Conv2d(cin, depth, 1, stride, bias=False),
                                                nn.BatchNorm2d(depth))
        self.res_layer = nn.Sequential(
            nn.BatchNorm2d(cin),
            nn.Conv2d(cin, depth, 3, 1, 1, bias=False),
            nn.PReLU(depth),
            nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
            nn.BatchNorm2d(depth),
            SEModule(depth, 16),
        )

    def forward(self, x):
        return self.res_layer(x) + self.shortcut_layer(x)


class IRSE50(nn.Module):
    """The IR-SE50 embedding net and the ID loss on it."""

    def __init__(self):
        super().__init__()
        self.input_layer = nn.Sequential(nn.Conv2d(3, 64, 3, 1, 1, bias=False),
                                         nn.BatchNorm2d(64), nn.PReLU(64))
        self.body = nn.Sequential(*[BottleneckIRSE(*b) for b in IRSE50_BLOCKS])
        # the reference IDLoss builds Backbone with the default affine=True
        self.output_layer = nn.Sequential(nn.BatchNorm2d(512), nn.Dropout(), nn.Flatten(),
                                          nn.Linear(512 * 7 * 7, 512), nn.BatchNorm1d(512))
        self.eval().requires_grad_(False)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, 112, 112] → l2-normalised [B, 512]; the flatten is in
        NCHW order, as the reference's Linear reads it."""
        h = self.output_layer(self.body(self.input_layer(x)))
        return h / torch.linalg.vector_norm(h, dim=1, keepdim=True)

    def extract_feats(self, img: torch.Tensor) -> torch.Tensor:
        """IDLoss.extract_feats: the face crop of a 256² image, adaptive
        average pooling to 112, the embedding."""
        x = img[:, :, 35:223, 32:220]
        return self.embed(F.adaptive_avg_pool2d(x, 112))

    def id_loss(self, x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
        """1 − ⟨feat(x), feat(x_hat)⟩ per sample; x's features are detached,
        as in the reference."""
        with torch.no_grad():
            f = self.extract_feats(x)
        return 1.0 - (f * self.extract_feats(x_hat)).sum(dim=1)
