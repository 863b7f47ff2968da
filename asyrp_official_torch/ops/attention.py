"""K2: spatial self-attention, forward (one or several heads) and the
single-head backward — the hand-written CUDA kernels of `csrc/attention.cu`
and their plain PyTorch versions.

Stands for the JAX `models/common.py` `spatial_attention` and the gradient
XLA derives for it. q, k, v are contiguous `[B, T, C]` maps; head h owns
channels [h*d, (h+1)*d), d = C / num_heads. The DDPM++ flavor
(`num_heads=1, legacy_scale=False`) scales the logits by d^-0.5; the OpenAI
flavor (`legacy_scale=True`) multiplies q and k by s = d^-0.25 in the I/O
dtype first. JAX rounds the Python scalar s to a bf16 array's dtype before
that product (weak typing), so both versions here use s rounded to the I/O
dtype, then round q*s and k*s to it. The softmax runs in f32 and its
weights are cast to v's dtype before the second product.

`attention` dispatches on the tensor's device: a CPU tensor takes the plain
versions, a CUDA tensor launches the kernels, anything else raises. When a
gradient is needed it goes through `torch.autograd.Function`: the forward
also keeps each row's log-sum-exp (f32 [B, T]), and the backward recomputes
the weights from it — `attention_backward_plain` on the CPU, kernel K2-bwd
on CUDA. The backward is single-head only: several heads raise
NotImplementedError there (the OpenAI UNets do not train yet).
`attention.launches` counts single-head forward launches,
`attention.mh_launches` multi-head ones and `attention.bwd_launches` K2-bwd.
"""
from __future__ import annotations

import ctypes
import math

import torch

from asyrp_official_torch.ops import _build

__all__ = ["attention", "attention_plain", "attention_backward", "attention_backward_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BM, _BN, _BK = 16, 64, 64  # tile sizes of csrc/attention.cu
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
_MH_TODO = ("the multi-head attention backward is not ported yet (OpenAI-family training, "
            "ROADMAP.md Queue 2)")


def _scales(d: int, legacy_scale: bool, dtype):
    """(logit scale, pre-scale of q and k): (d^-0.5, 1), or (1, d^-0.25
    rounded to the I/O dtype) with `legacy_scale`."""
    if not legacy_scale:
        return d ** -0.5, 1.0
    return 1.0, float(torch.tensor(1.0 / math.sqrt(math.sqrt(d))).to(dtype))


def _plain_with_lse(q, k, v, num_heads: int = 1, legacy_scale: bool = False):
    b, t, c = q.shape
    d = c // num_heads
    scale, pre = _scales(d, legacy_scale, q.dtype)

    def heads(a):  # [B, T, C] -> [B, H, T, d]
        return a.reshape(b, t, num_heads, d).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    if legacy_scale:
        qh, kh = qh * pre, kh * pre
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if not legacy_scale:
        logits = logits * scale
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(w.float(), vh.float()).to(v.dtype)
    return o.transpose(1, 2).reshape(b, t, c), torch.logsumexp(logits, dim=-1).reshape(b, -1)


def attention_plain(q, k, v, *, num_heads: int = 1, legacy_scale: bool = False):
    """The reference math on any device, in plain PyTorch."""
    return _plain_with_lse(q, k, v, num_heads, legacy_scale)[0]


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
_FWD_ARGS = [_P] * 5 + [_I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _P]
_BWD_ARGS = [_P] * 10 + [_I, _I, _I, ctypes.c_float, _I, _P]


def _check(q, k, v, n_tiles: int, num_heads: int = 1):
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
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"attention kernel: {c} channels do not split into {num_heads} heads")
    d = c // num_heads
    # forward: one tile of each kind; backward: two
    smem = 4 * n_tiles * (_BM * d + _BN * (_BK + 1) + _BM * t)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"attention kernel: T={t}, d={d} needs {smem} bytes of shared memory")
    return b, t, c


def _attention_cuda(q, k, v, with_lse: bool, num_heads: int = 1, legacy_scale: bool = False):
    b, t, c = _check(q, k, v, 1, num_heads)
    scale, pre = _scales(c // num_heads, legacy_scale, q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty(b, num_heads * t, device=q.device, dtype=torch.float32) if with_lse else None
    with torch.cuda.device(q.device):  # the launch goes to the current device
        code = _fn("asyrp_attention", _FWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None, b, t, c, num_heads, scale, pre,
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "attention kernel")
    if num_heads == 1:
        attention.launches += 1
    else:
        attention.mh_launches += 1
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
    def forward(ctx, q, k, v, num_heads, legacy_scale):
        if q.device.type == "cuda":
            o, lse = _attention_cuda(q, k, v, True, num_heads, legacy_scale)
        else:
            o, lse = _plain_with_lse(q, k, v, num_heads, legacy_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads = num_heads
        return o

    @staticmethod
    def backward(ctx, d_o):
        if ctx.num_heads != 1:
            raise NotImplementedError(_MH_TODO)
        q, k, v, o, lse = ctx.saved_tensors
        return (*attention_backward(q, k, v, o, d_o, lse), None, None)


def attention(q, k, v, *, num_heads: int = 1, legacy_scale: bool = False):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, num_heads, legacy_scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads=num_heads, legacy_scale=legacy_scale)
    return _attention_cuda(q, k, v, False, num_heads, legacy_scale)[0]


attention.launches = 0
attention.mh_launches = 0
attention.bwd_launches = 0
