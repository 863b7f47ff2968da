"""The reference's primitives: convolution, linear, matrix product,
GroupNorm (optionally with SiLU, a per-channel pre-add or a FiLM scale and
shift) and multi-head attention, in plain PyTorch and float32.

`RefOps(precision)` rounds both operands of every convolution and matrix
product to `precision` before an f32 product: "f32" (nothing), "tf32"
(10 mantissa bits, round to nearest even, as the tensor cores read f32
with TF32 on), "bf16", or "fp8" (e4m3 with one scale per tensor, its
largest magnitude at 448). The lower ones are the controls of `correct`:
the reference put in the program's place one precision below the cell's.
With a `counting.Counter` it records each call's operations and bytes
instead of relying on any run: on the meta device it computes nothing.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from portbench import counting

__all__ = ["RefOps", "round_to", "full_f32"]

PRECISIONS = ("f32", "tf32", "bf16", "fp8")


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return t
    if precision == "bf16":
        return t.to(torch.bfloat16).float()
    if precision == "tf32":
        bits = t.contiguous().view(torch.int32)
        # drop 13 of 23 mantissa bits, rounding to nearest even
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)
    if precision == "fp8":
        scale = (t.detach().abs().amax().float() / 448.0).clamp_min(1e-30)
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


def round_to(t: torch.Tensor, precision: str) -> torch.Tensor:
    """`t` (f32) rounded to `precision` and returned in f32."""
    return _round(t, precision)


@contextlib.contextmanager
def full_f32():
    """Full-f32 products on the card (TF32 off), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class RefOps:
    def __init__(self, precision: str = "f32", counter: Optional[counting.Counter] = None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision = precision
        self.counter = counter

    def _r(self, t):
        return round_to(t, self.precision)

    # -- products ---------------------------------------------------------
    def conv2d(self, x, w, b=None, stride: int = 1, padding: int = 0):
        out = F.conv2d(self._r(x), self._r(w), b, stride=stride, padding=padding)
        c = self.counter
        if c is not None:
            flops, nbytes = counting.conv_counts(x.shape, w.shape, out.shape, c.itemsize)
            c.add("gemm", flops, nbytes)
        return out

    def linear(self, x, w, b=None):
        out = F.linear(self._r(x), self._r(w), b)
        self._count_matmul(x, w.t(), out)
        return out

    def matmul(self, a, b):
        out = torch.matmul(self._r(a), self._r(b))
        self._count_matmul(a, b, out)
        return out

    def _count_matmul(self, a, b, out):
        c = self.counter
        if c is None:
            return
        flops, nbytes = counting.matmul_counts(a.shape, b.shape, out.shape, c.itemsize)
        c.add("gemm", flops, nbytes)

    # -- GroupNorm (K1's mathematics) ---------------------------------------
    def group_norm(self, x, w, b, eps: float, *, silu: bool = False, pre_add=None,
                   scale_shift=None, groups: int = 32):
        """NCHW (or [B, C, T]) x: GroupNorm(x + pre_add) in f32, then
        y * (1 + scale) + shift, then SiLU."""
        extra = 0
        if pre_add is not None:
            x = x + pre_add.reshape(pre_add.shape + (1,) * (x.dim() - 2))
            extra = pre_add.numel()
        y = F.group_norm(x, groups, w, b, eps)
        if scale_shift is not None:
            scale, shift = scale_shift.chunk(2, dim=1)
            view = scale.shape + (1,) * (x.dim() - 2)
            y = y * (1.0 + scale.reshape(view)) + shift.reshape(view)
            extra = scale_shift.numel()
        if silu:
            y = F.silu(y)
        c = self.counter
        if c is not None:
            c.add("k1", 0, counting.gn_bytes(x.numel(), extra, c.itemsize))
        return y

    # -- attention (K2's mathematics) ---------------------------------------
    def attention(self, q, k, v, heads: int, legacy_scale: bool):
        """q, k, v [B, T, C]; head h owns channels [h d, (h+1) d). The
        DDPM++ flavor scales the logits by d^-0.5, the OpenAI one scales q
        and k by d^-0.25 each; softmax over the keys in f32."""
        bsz, t, ch = q.shape
        d = ch // heads

        def split(a):
            return a.reshape(bsz, a.shape[1], heads, d).transpose(1, 2)

        qh, kh, vh = split(q), split(k), split(v)
        if legacy_scale:
            s = d ** -0.25
            logits = torch.matmul(self._r(qh * s), self._r(kh * s).transpose(-1, -2))
        else:
            logits = torch.matmul(self._r(qh), self._r(kh).transpose(-1, -2)) * d ** -0.5
        w = torch.softmax(logits, dim=-1)
        out = torch.matmul(self._r(w), self._r(vh)).transpose(1, 2).reshape(bsz, t, ch)
        c = self.counter
        if c is not None:
            flops, nbytes = counting.attention_counts(bsz, t, k.shape[1], ch, c.itemsize)
            c.add("k2", flops, nbytes)
        return out
