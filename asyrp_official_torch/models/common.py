"""NCHW primitives of the UNets — the port of the JAX `models/common.py`
layers (`conv2d`, `mat1x1`, `linear`, the DDPM++ and OpenAI timestep
embeddings, nearest 2x upsample, the right/bottom-padded downsample conv and
2x2 average pool).

Weights are held in the reference's torch layouts (OIHW convs, [out, in]
linears) and cast to the activation dtype at use, as the JAX layers cast
their params. Convolutions and plain GEMMs go to `F.conv2d` / `F.linear`;
GroupNorm and attention go to the kernels in `asyrp_official_torch.ops`.

Activations may also be channels-last (`torch.channels_last`: NCHW shapes,
NHWC in memory; the OpenAI UNet's bf16 serving route): a convolution handed
one takes its weight cast to channels-last in the same cast and is counted
(`channels_last_convs`); the upsample, the pooling and `cat` work on the
NHWC view, where torch's own ops would give NCHW (`repeat_interleave`) or
take a kernel 1.5-3.4x slower on the card (`avg_pool2d`, `torch.cat` along
the channels); the other ops keep the layout by themselves.

Inside a `parallel.spatial.sharded` block the activations are row blocks
of the image: a 3x3 convolution takes its neighbours' halo rows, the
downsample convolutions the one row they reach across the block's edge,
and GroupNorm combines the ranks' statistics (K1 across ranks); 1x1
convolutions, the pooling and the upsample stay local. Each exchange is
differentiable (`parallel/spatial.py`'s rule 1): under autograd the halos
send their gradients back to the rows' owners and GroupNorm's backward is
K1-bwd across ranks.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from asyrp_official_torch.ops import channels_last
from asyrp_official_torch.ops import groupnorm as _k1
from asyrp_official_torch.parallel import spatial
from asyrp_official_torch.utils import profiling as prof

__all__ = [
    "GroupNorm",
    "remat",
    "conv2d",
    "linear",
    "mat1x1",
    "timestep_embedding_ddpm",
    "timestep_embedding_openai",
    "upsample_nearest_2x",
    "downsample_pad_conv",
    "avg_pool_2x",
    "cat",
]


class GroupNorm(nn.Module):
    """32-group GroupNorm with the reference's `weight`/`bias` keys; the
    forward is kernel K1, optionally fused with SiLU, a per-channel
    `pre_add` [B, C] before it and the FiLM `scale_shift` [B, 2C] after it
    (`ops.groupnorm.group_norm`)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, silu: bool = False, pre_add=None, scale_shift=None):
        sg = spatial.active()
        if sg is not None:
            return _k1.group_norm_across(
                x, self.weight, self.bias,
                lambda parts: spatial.all_gather_slots(parts, sg.group, sg.size),
                reduce=lambda sums: spatial.all_reduce_sum(sums, sg),
                groups=self.groups, eps=self.eps, silu=silu, pre_add=pre_add,
                scale_shift=scale_shift)
        return _k1.group_norm(x, self.weight, self.bias, groups=self.groups, eps=self.eps, silu=silu,
                              pre_add=pre_add, scale_shift=scale_shift)


def remat(block: nn.Module, *args):
    """`block(*args)` with its activations recomputed in the backward
    (the JAX `jax.checkpoint` of a resblock, `cfg.remat`): non-reentrant
    `torch.utils.checkpoint`, under grad only, so serving, export and the
    launch counts stay as they are without it.

    The recompute runs inside the backward, on the autograd engine's thread
    for CUDA tensors, where this thread's `spatial.sharded` context is not
    set: it re-enters the group the forward ran under, so a row block
    recomputes with the same halos, gathers and K1 across ranks. Those
    exchanges then run a second time, and every rank must issue them in the
    same order. The recompute's early stop (it ends once the last tensor the
    backward saved is recomputed) cannot split them: which tensors a block
    saves depends on its ops, not on a rank's rows, so every rank stops
    after the same op, and a collective after that op is skipped on every
    rank alike."""
    if not torch.is_grad_enabled():
        return block(*args)
    sg = spatial.active()

    def run(*a):
        with spatial.sharded(sg):
            return block(*a)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def _cast(p, dtype, nhwc: bool = False):
    """A weight in the activation dtype: converted at each use (and counted
    while a profiler records) where the dtypes differ; with `nhwc` a conv
    filter is written channels-last by that same conversion, so cuDNN takes
    it as it is."""
    if p.dtype == dtype:
        return p
    prof.count(prof.WEIGHT_CASTS)
    if nhwc and p.dim() == 4:
        return p.to(dtype, memory_format=torch.channels_last)
    return p.to(dtype)


def _conv_weights(conv, x):
    """The conv's weight and bias in x's dtype, the weight channels-last
    where x is (such a conv counted while a profiler records)."""
    nhwc = channels_last(x)
    if nhwc:
        prof.count(prof.CHANNELS_LAST_CONVS)
    return _cast(conv.weight, x.dtype, nhwc), _cast(conv.bias, x.dtype)


def conv2d(conv: nn.Conv2d, x, *, stride: int = 1, padding=1):
    """Conv with the weight and bias cast to x's dtype (JAX `common.conv2d`).
    On a row block (spatial sharding) a 3x3 conv with padding 1 takes the
    neighbours' halo rows (stride 2, the OpenAI Downsample: only the row
    above reaches across the block)."""
    w, b = _conv_weights(conv, x)
    sg = spatial.active()
    if sg is None or w.shape[-2] == 1:
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    if padding != 1 or stride not in (1, 2):
        raise NotImplementedError(f"a {tuple(w.shape[-2:])} conv with stride {stride} and "
                                  f"padding {padding} on a row block")
    return F.conv2d(spatial.pad_rows(x, sg, bottom=stride == 1), w, b, stride=stride,
                    padding=(0, 1))


def mat1x1(conv: nn.Conv2d, x):
    """1x1 conv as a channel matmul (JAX `common.mat1x1`)."""
    return F.conv2d(x, *_conv_weights(conv, x))


def linear(lin: nn.Linear, x):
    return F.linear(x, _cast(lin.weight, x.dtype), _cast(lin.bias, x.dtype))


def timestep_embedding_ddpm(t, dim: int):
    """DDPM++ sinusoidal embedding: exponent /(half-1), concat(sin, cos)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def timestep_embedding_openai(t, dim: int, max_period: int = 10000):
    """OpenAI (iDDPM/ADM) embedding: exponent /half, concat(cos, sin)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def upsample_nearest_2x(x):
    """Each pixel repeated 2x2; a channels-last x gives a channels-last
    result (`repeat_interleave` would give NCHW), the same values."""
    if channels_last(x):
        b, c, h, w = x.shape
        up = x.permute(0, 2, 3, 1)[:, :, None, :, None].expand(b, h, 2, w, 2, c)
        return up.reshape(b, 2 * h, 2 * w, c).permute(0, 3, 1, 2)
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def downsample_pad_conv(conv: nn.Conv2d, x):
    """DDPM++ Downsample: zero-pad right and bottom by 1, then a 3x3
    stride-2 valid conv. On a row block the bottom row is the next rank's
    first (zero at the image's bottom edge)."""
    sg = spatial.active()
    if sg is None:
        return conv2d(conv, F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)
    x = F.pad(spatial.pad_rows(x, sg, top=False), (0, 1, 0, 0))
    return F.conv2d(x, _cast(conv.weight, x.dtype), _cast(conv.bias, x.dtype), stride=2)


def avg_pool_2x(x):
    """2x2 average pooling; a channels-last x as the mean over each window
    of its NHWC view, channels-last (in bf16 the same bits; in f32 the four
    terms may be summed in another order)."""
    if channels_last(x):
        b, c, h, w = x.shape
        return x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c).mean((2, 4)).permute(
            0, 3, 1, 2)
    return F.avg_pool2d(x, 2)


def cat(tensors, dim: int = 1):
    """`torch.cat(tensors, dim)`; channels-last 4-D tensors joined as their
    NHWC views (the same values, channels-last)."""
    if all(channels_last(t) for t in tensors):
        nhwc = [t.permute(0, 2, 3, 1) for t in tensors]
        return torch.cat(nhwc, (0, 3, 1, 2)[dim]).permute(0, 3, 1, 2)
    return torch.cat(tensors, dim)
