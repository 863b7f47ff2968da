"""BiSeNet-style ResNet-18 feature extractor — the port of the JAX
package's `losses/resnet18.py` (the reference's orphan `losses/resnet.py`,
the backbone of a removed semantic-consistency loss).

`ResNet18` holds torchvision's resnet18 key layout (conv1 / bn1 /
layer{1-4}.{0,1}, the fc head dropped), so `load_state_dict` takes a
torchvision state dict (strict, fc keys removed first). BatchNorm always
runs on its running statistics, whatever `train()` says: the reference
only runs this net frozen, and the JAX package folds each BN into a scale
and shift. `resnet18_features` returns the (feat8, feat16, feat32) pyramid
at 1/8, 1/16, 1/32 resolution, NCHW (the JAX package's is NHWC).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ResNet18", "resnet18_features", "init"]

# (out_chan, stride) of the first block per layer; 2 BasicBlocks each
_LAYERS = [(64, 1), (128, 2), (256, 2), (512, 2)]


def _bn(bn: nn.BatchNorm2d, x):
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        bn.eps)


class _BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout))
        else:
            self.downsample = None

    def forward(self, x):
        r = F.relu(_bn(self.bn1, self.conv1(x)))
        r = _bn(self.bn2, self.conv2(r))
        s = x if self.downsample is None else _bn(self.downsample[1], self.downsample[0](x))
        return F.relu(s + r)


class ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for li, (cout, stride) in enumerate(_LAYERS):
            setattr(self, f"layer{li + 1}", nn.Sequential(_BasicBlock(cin, cout, stride),
                                                          _BasicBlock(cout, cout, 1)))
            cin = cout

    def forward(self, x):
        return resnet18_features(self, x)


def resnet18_features(model: ResNet18, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, 3, H, W] → (feat8, feat16, feat32), NCHW."""
    h = F.relu(_bn(model.bn1, model.conv1(x)))
    h = F.max_pool2d(h, 3, 2, 1)
    feats = []
    for li in range(len(_LAYERS)):
        h = getattr(model, f"layer{li + 1}")(h)
        if li > 0:
            feats.append(h)
    return tuple(feats)


def init(seed: int) -> ResNet18:
    """Random weights from `seed` (plumbing tests; real use loads
    torchvision's weights): convs N(0, 1/fan_in), BN the identity."""
    gen = torch.Generator().manual_seed(seed)
    model = ResNet18()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * fan ** -0.5)
    return model.eval()
