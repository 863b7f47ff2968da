"""K1: GroupNorm (+ optional SiLU) — the hand-written CUDA kernel
`csrc/groupnorm.cu` and its plain PyTorch version.

Stands for the JAX `models/common.py` `group_norm` (with `models/ddpmpp.py`
`_gn_silu` when `silu=True`). Tensors are NCHW (any trailing spatial rank):
`[B, C, *spatial]`. Statistics and affine run in f32 whatever the I/O dtype,
and the result is cast back once.

`group_norm` dispatches on the tensor's device: a CPU tensor takes
`group_norm_plain`, a CUDA tensor launches the kernel (and bumps
`group_norm.launches`), anything else raises.
"""
from __future__ import annotations

import ctypes

import torch

from asyrp_official_torch.ops import _build

__all__ = ["group_norm", "group_norm_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# each slice of a group holds at least this many elements (see the .cu note)
_MIN_SLICE = 8192
_MAX_SPLITS = 64


def group_norm_plain(x, weight, bias, *, groups: int = 32, eps: float = 1e-6, silu: bool = False):
    """The reference math on any device, in plain PyTorch."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    var = (xf - mean).square().mean(dim=2, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    y = y * weight.float().reshape(bshape) + bias.float().reshape(bshape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _splits(group_len: int) -> int:
    want = min(_MAX_SPLITS, max(1, -(-group_len // _MIN_SLICE)))
    slice_len = -(-group_len // want)
    return -(-group_len // slice_len)  # no empty trailing slice


def _lib():
    lib = _build.load_library("groupnorm")
    fn = lib.asyrp_group_norm
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _group_norm_cuda(x, weight, bias, groups, eps, silu):
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm kernel needs a contiguous NCHW tensor")
    b, c = x.shape[:2]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    hw = x.numel() // (b * c)
    w = weight.detach().float().contiguous()
    bb = bias.detach().float().contiguous()
    if w.device != x.device or bb.device != x.device or w.numel() != c or bb.numel() != c:
        raise ValueError("group_norm weight/bias must be [C] on the input's device")
    splits = _splits((c // groups) * hw)
    partials = torch.empty(b * groups * splits * 3, device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        code = _lib()(
            x.data_ptr(), w.data_ptr(), bb.data_ptr(), y.data_ptr(), partials.data_ptr(),
            b, c, hw, groups, float(eps), int(silu), splits, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "group_norm kernel")
    group_norm.launches += 1
    return y


def group_norm(x, weight, bias, *, groups: int = 32, eps: float = 1e-6, silu: bool = False):
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups=groups, eps=eps, silu=silu)
    if x.device.type == "cuda":
        return _group_norm_cuda(x, weight, bias, groups, eps, silu)
    raise ValueError(f"group_norm: no kernel for device {x.device}")


group_norm.launches = 0
