"""K1: GroupNorm (+ optional SiLU), forward and backward — the hand-written
CUDA kernels of `csrc/groupnorm.cu` and their plain PyTorch versions.

Stands for the JAX `models/common.py` `group_norm` (with `models/ddpmpp.py`
`_gn_silu` when `silu=True`) and the gradient XLA derives for it. Tensors
are NCHW (any trailing spatial rank): `[B, C, *spatial]`. Statistics,
affine and gradients run in f32 whatever the I/O dtype, and each result is
cast back once.

`group_norm` dispatches on the tensor's device: a CPU tensor takes the plain
versions, a CUDA tensor launches the kernels, anything else raises. When a
gradient is needed it goes through `torch.autograd.Function`: the forward
also keeps each group's mean and rstd (f32), and the backward computes dx,
and dweight/dbias when the weight is trained, from them — `group_norm_
backward_plain` on the CPU, kernel K1-bwd on CUDA. `group_norm.launches` and
`group_norm.bwd_launches` count the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from asyrp_official_torch.ops import _build

__all__ = ["group_norm", "group_norm_plain", "group_norm_backward", "group_norm_backward_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# each slice of a group holds at least this many elements (see the .cu note)
_MIN_SLICE = 8192
_MAX_SPLITS = 64


def _bshape(x):
    return (1, x.shape[1]) + (1,) * (x.dim() - 2)


def _plain_with_stats(x, weight, bias, groups, eps, silu):
    b = x.shape[0]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    var = (xf - mean).square().mean(dim=2, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mean) * rstd).reshape(x.shape)
    y = y * weight.float().reshape(_bshape(x)) + bias.float().reshape(_bshape(x))
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype), mean.reshape(b, groups), rstd.reshape(b, groups)


def group_norm_plain(x, weight, bias, *, groups: int = 32, eps: float = 1e-6, silu: bool = False):
    """The reference math on any device, in plain PyTorch."""
    return _plain_with_stats(x, weight, bias, groups, eps, silu)[0]


def group_norm_backward_plain(x, dy, weight, bias, mean, rstd, *, groups: int = 32,
                              silu: bool = False, weight_grad: bool = True):
    """The hand-derived backward from the forward's per-group `mean` and
    `rstd` ([B, G], f32), per group:

        xhat = (x - mean) * rstd,  z = xhat * w + b
        dz   = dy * s * (1 + z * (1 - s)), s = sigmoid(z)   (with SiLU; else dy)
        g    = dz * w
        dx   = rstd * (g - mean(g) - xhat * mean(g * xhat))
        dw   = sum over (B, HW) of dz * xhat;  db = sum over (B, HW) of dz

    Returns (dx in x's dtype, dw, db in f32, or None without `weight_grad`)."""
    b, c = x.shape[:2]
    w = weight.float().reshape(_bshape(x))
    xhat = ((x.float().reshape(b, groups, -1) - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    dz = dy.float()
    if silu:
        z = xhat * w + bias.float().reshape(_bshape(x))
        s = torch.sigmoid(z)
        dz = dz * s * (1.0 + z * (1.0 - s))
    g = (dz * w).reshape(b, groups, -1)
    xg = xhat.reshape(b, groups, -1)
    dx = rstd[..., None] * (g - g.mean(dim=2, keepdim=True)
                            - xg * (g * xg).mean(dim=2, keepdim=True))
    dx = dx.reshape(x.shape).to(x.dtype)
    if not weight_grad:
        return dx, None, None
    sum_dims = [0] + list(range(2, x.dim()))
    return dx, (dz * xhat).sum(dim=sum_dims), dz.sum(dim=sum_dims)


def _splits(group_len: int) -> int:
    want = min(_MAX_SPLITS, max(1, -(-group_len // _MIN_SLICE)))
    slice_len = -(-group_len // want)
    return -(-group_len // slice_len)  # no empty trailing slice


def _fn(name: str, argtypes):
    fn = getattr(_build.load_library("groupnorm"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 7 + [_I, _I, ctypes.c_int64, _I, ctypes.c_float, _I, _I, _I, _P]
_BWD_ARGS = [_P] * 10 + [_I, _I, ctypes.c_int64, _I, _I, _I, _I, _P]


def _check_input(x, weight, bias, groups):
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm kernel needs a contiguous NCHW tensor")
    b, c = x.shape[:2]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    w = weight.detach().float().contiguous()
    bb = bias.detach().float().contiguous()
    if w.device != x.device or bb.device != x.device or w.numel() != c or bb.numel() != c:
        raise ValueError("group_norm weight/bias must be [C] on the input's device")
    return b, c, x.numel() // (b * c), w, bb


def _group_norm_cuda(x, weight, bias, groups, eps, silu, stats: bool):
    b, c, hw, w, bb = _check_input(x, weight, bias, groups)
    splits = _splits((c // groups) * hw)
    partials = torch.empty(b * groups * splits * 3, device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty(b, groups, device=x.device, dtype=torch.float32)
        rstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        code = _fn("asyrp_group_norm", _FWD_ARGS)(
            x.data_ptr(), w.data_ptr(), bb.data_ptr(), y.data_ptr(), partials.data_ptr(),
            mean.data_ptr() if stats else None, rstd.data_ptr() if stats else None,
            b, c, hw, groups, float(eps), int(silu), splits, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "group_norm kernel")
    group_norm.launches += 1
    return y, mean, rstd


def _group_norm_bwd_cuda(x, dy, weight, bias, mean, rstd, groups, silu, weight_grad):
    b, c, hw, w, bb = _check_input(x, weight, bias, groups)
    dy = dy.contiguous()
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"group_norm backward: dy {dy.dtype}{tuple(dy.shape)} does not match "
                         f"x {x.dtype}{tuple(x.shape)}")
    splits = _splits((c // groups) * hw)
    partials = torch.empty(b * groups * splits * 2, device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    dw = db = None
    if weight_grad:
        dw = torch.empty(c, device=x.device, dtype=torch.float32)
        db = torch.empty_like(dw)
    with torch.cuda.device(x.device):
        code = _fn("asyrp_group_norm_bwd", _BWD_ARGS)(
            x.data_ptr(), dy.data_ptr(), w.data_ptr(), bb.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), dw.data_ptr() if weight_grad else None,
            db.data_ptr() if weight_grad else None, partials.data_ptr(), b, c, hw, groups,
            int(silu), splits, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "group_norm backward kernel")
    group_norm.bwd_launches += 1
    return dx, dw, db


def group_norm_backward(x, dy, weight, bias, mean, rstd, *, groups: int = 32,
                        silu: bool = False, weight_grad: bool = True):
    """K1-bwd: (dx, dw, db) from the forward's `mean`/`rstd` — the plain
    version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return group_norm_backward_plain(x, dy, weight, bias, mean, rstd, groups=groups,
                                         silu=silu, weight_grad=weight_grad)
    if x.device.type == "cuda":
        return _group_norm_bwd_cuda(x, dy, weight, bias, mean, rstd, groups, silu, weight_grad)
    raise ValueError(f"group_norm_backward: no kernel for device {x.device}")


class _GroupNorm(torch.autograd.Function):
    """K1 with its gradient; the statistics the backward reads come from
    this forward call."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        if x.device.type == "cuda":
            y, mean, rstd = _group_norm_cuda(x, weight, bias, groups, eps, silu, stats=True)
        else:
            y, mean, rstd = _plain_with_stats(x, weight, bias, groups, eps, silu)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups, ctx.silu = groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        weight_grad = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, dw, db = group_norm_backward(x, dy, weight, bias, mean, rstd, groups=ctx.groups,
                                         silu=ctx.silu, weight_grad=weight_grad)
        if weight_grad:
            dw, db = dw.to(weight.dtype), db.to(bias.dtype)
        return dx if ctx.needs_input_grad[0] else None, dw, db, None, None, None


def group_norm(x, weight, bias, *, groups: int = 32, eps: float = 1e-6, silu: bool = False):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_norm: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNorm.apply(x, weight, bias, groups, eps, silu)
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups=groups, eps=eps, silu=silu)
    return _group_norm_cuda(x, weight, bias, groups, eps, silu, stats=False)[0]


group_norm.launches = 0
group_norm.bwd_launches = 0
