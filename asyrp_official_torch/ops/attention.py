"""K2: single-head spatial self-attention, forward and backward — the
hand-written CUDA kernels of `csrc/attention.cu` and their plain PyTorch
versions.

Stands for the JAX `models/common.py` `spatial_attention` with
`num_heads=1, legacy_scale=False` (the DDPM++ flavor) and the gradient XLA
derives for it: q, k, v are contiguous `[B, T, C]` maps, the logits are
scaled by C^-0.5, the softmax runs in f32 and its weights are cast to v's
dtype before the second product.

`attention` dispatches on the tensor's device: a CPU tensor takes the plain
versions, a CUDA tensor launches the kernels, anything else raises. When a
gradient is needed it goes through `torch.autograd.Function`: the forward
also keeps each row's log-sum-exp (f32 [B, T]), and the backward recomputes
the weights from it — `attention_backward_plain` on the CPU, kernel K2-bwd
on CUDA. `attention.launches` and `attention.bwd_launches` count the kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from asyrp_official_torch.ops import _build

__all__ = ["attention", "attention_plain", "attention_backward", "attention_backward_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BM, _BN, _BK = 16, 64, 64  # tile sizes of csrc/attention.cu
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def _plain_with_lse(q, k, v):
    c = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(w.float(), v.float()).to(v.dtype)
    return o, torch.logsumexp(logits, dim=-1)


def attention_plain(q, k, v):
    """The reference math on any device, in plain PyTorch."""
    return _plain_with_lse(q, k, v)[0]


def attention_backward_plain(q, k, v, o, d_o, lse):
    """The backward from the forward's output `o` and row log-sum-exp `lse`
    (FlashAttention-2 form), with S = q k^T * C^-0.5:

        P  = exp(S - lse);  D = rowsum(dO * O)
        dP = dO v^T  (rounded to the I/O dtype, the gradient of the weights' cast)
        dS = P * (dP - D)
        dQ = C^-0.5 dS k;  dK = C^-0.5 dS^T q;  dV = P^T dO  (P cast to v's dtype)

    Returns (dq, dk, dv) in the I/O dtype."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), d_o.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(1, 2)) * scale - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(1, 2)).to(v.dtype).float()
    ds = p * (dp - (dof * o.float()).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(1, 2), qf) * scale
    dv = torch.matmul(p.to(v.dtype).float().transpose(1, 2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fn(name: str, argtypes):
    fn = getattr(_build.load_library("attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 5 + [_I, _I, _I, ctypes.c_float, _I, _P]
_BWD_ARGS = [_P] * 10 + [_I, _I, _I, ctypes.c_float, _I, _P]


def _check(q, k, v, n_tiles: int):
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
    # forward: one tile of each kind; backward: two
    smem = 4 * n_tiles * (_BM * c + _BN * (_BK + 1) + _BM * t)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"attention kernel: T={t}, C={c} needs {smem} bytes of shared memory")
    return b, t, c


def _attention_cuda(q, k, v, with_lse: bool):
    b, t, c = _check(q, k, v, 1)
    o = torch.empty_like(q)
    lse = torch.empty(b, t, device=q.device, dtype=torch.float32) if with_lse else None
    with torch.cuda.device(q.device):  # the launch goes to the current device
        code = _fn("asyrp_attention", _FWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None, b, t, c, float(c ** -0.5), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "attention kernel")
    attention.launches += 1
    return o, lse


def _attention_bwd_cuda(q, k, v, o, d_o, lse):
    b, t, c = _check(q, k, v, 2)
    d_o = d_o.contiguous()  # the caller's transposes may leave it strided
    if d_o.dtype != q.dtype or d_o.shape != q.shape:
        raise ValueError(f"attention backward: dO {d_o.dtype}{tuple(d_o.shape)} does not match "
                         f"q {q.dtype}{tuple(q.shape)}")
    d = torch.empty(b, t, device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = _fn("asyrp_attention_bwd", _BWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), d_o.data_ptr(),
            lse.data_ptr(), d.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, c,
            float(c ** -0.5), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "attention backward kernel")
    attention.bwd_launches += 1
    return dq, dk, dv


def attention_backward(q, k, v, o, d_o, lse):
    """K2-bwd: (dq, dk, dv) from the forward's output and `lse` — the plain
    version for a CPU tensor, the kernels for a CUDA tensor."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, o, d_o, lse)
    if q.device.type == "cuda":
        return _attention_bwd_cuda(q, k, v, o, d_o, lse)
    raise ValueError(f"attention_backward: no kernel for device {q.device}")


class _Attention(torch.autograd.Function):
    """K2 with its gradient; the lse the backward reads comes from this
    forward call."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cuda":
            o, lse = _attention_cuda(q, k, v, with_lse=True)
        else:
            o, lse = _plain_with_lse(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, o, lse = ctx.saved_tensors
        return attention_backward(q, k, v, o, d_o, lse)


def attention(q, k, v):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _attention_cuda(q, k, v, with_lse=False)[0]


attention.launches = 0
attention.bwd_launches = 0
