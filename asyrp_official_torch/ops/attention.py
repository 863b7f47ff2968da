"""K2: single-head spatial self-attention — the hand-written CUDA kernel
`csrc/attention.cu` and its plain PyTorch version.

Stands for the JAX `models/common.py` `spatial_attention` with
`num_heads=1, legacy_scale=False` (the DDPM++ flavor): q, k, v are
contiguous `[B, T, C]` maps, the logits are scaled by C^-0.5, the softmax
runs in f32 and its weights are cast to v's dtype before the second product.

`attention` dispatches on the tensor's device: a CPU tensor takes
`attention_plain`, a CUDA tensor launches the kernel (and bumps
`attention.launches`), anything else raises.
"""
from __future__ import annotations

import ctypes

import torch

from asyrp_official_torch.ops import _build

__all__ = ["attention", "attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BM, _BN, _BK = 16, 64, 64  # tile sizes of csrc/attention.cu
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def attention_plain(q, k, v):
    """The reference math on any device, in plain PyTorch."""
    c = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(v.dtype)


def _lib():
    fn = _build.load_library("attention").asyrp_attention
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _attention_cuda(q, k, v):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention kernel takes q, k, v of one [B, T, C] shape, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel needs contiguous q, k, v")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("attention: q, k, v on different devices")
    b, t, c = q.shape
    smem = 4 * (_BM * c + _BN * (_BK + 1) + _BM * t)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"attention kernel: T={t}, C={c} needs {smem} bytes of shared memory")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):  # the launch goes to the current device
        code = _lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, t, c,
            float(c ** -0.5), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "attention kernel")
    attention.launches += 1
    return o


def attention(q, k, v):
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type == "cuda":
        return _attention_cuda(q, k, v)
    raise ValueError(f"attention: no kernel for device {q.device}")


attention.launches = 0
