"""K2: spatial self-attention, forward and backward, with one or several
heads — the hand-written CUDA kernels of `csrc/attention.cu` and their
plain PyTorch versions.

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
also keeps each (head, row)'s log-sum-exp (f32 [B, H*T]), and the backward
recomputes the weights from it — `attention_backward_plain` on the CPU,
kernel K2-bwd on CUDA. `attention.launches` counts single-head forward
launches, `attention.mh_launches` multi-head ones, `attention.bwd_launches`
single-head backward launches and `attention.mh_bwd_launches` multi-head
ones.

Under spatial sharding (`parallel/spatial.py`) a rank's queries are its own
rows of the image ([B, Tq, C], Tq = T / S) and its keys and values the
whole image's ([B, Tk, C], gathered): the forward kernel's entry
`asyrp_attention_kv` takes the two lengths (one head or several), counted
in `attention.kv_launches`. Its gradient is not ported yet (ROADMAP M10c).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from asyrp_official_torch.ops import _build, traced

__all__ = ["attention", "attention_plain", "attention_backward", "attention_backward_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
# the forward kernel (csrc/attention.cu `fwd::attn_fwd`): bytes of one staged
# chunk of 64 rows x 64 channels, and the stages of its ring, per dtype; a
# head of d channels is a cluster of ceil(d / 64) blocks, at most 8
_CHUNK_BYTES = {torch.float32: 64 * 68 * 4, torch.bfloat16: 64 * 128}
_STAGES = {torch.float32: 4, torch.bfloat16: 8}
_MAX_D = 512
# the backward kernel (csrc/attention.cu `bwd::attn_bwd`): per dtype, whether
# the block's own rows stay resident (2 x ceil(d / 64) chunks), the chunks
# per stage of its ring and the stages
_BWD_RING = {torch.float32: (False, 4, 3), torch.bfloat16: (True, 2, 4)}


@functools.lru_cache(maxsize=None)
def _scales(d: int, legacy_scale: bool, dtype):
    """(logit scale, pre-scale of q and k): (d^-0.5, 1), or (1, d^-0.25
    rounded to the I/O dtype) with `legacy_scale`."""
    if not legacy_scale:
        return d ** -0.5, 1.0
    return 1.0, float(torch.tensor(1.0 / math.sqrt(math.sqrt(d))).to(dtype))


def _acc(dtype):
    """The plain versions' accumulation dtype: f32, or f64 for f64 inputs
    (which only the plain versions take, e.g. under gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _plain_with_lse(q, k, v, num_heads: int = 1, legacy_scale: bool = False):
    """q [B, Tq, C] against k, v [B, Tk, C]: (o [B, Tq, C], lse [B, H*Tq])."""
    b, t, c = q.shape
    acc = _acc(q.dtype)
    d = c // num_heads
    scale, pre = _scales(d, legacy_scale, q.dtype)

    def heads(a):  # [B, T, C] -> [B, H, T, d]
        return a.reshape(b, a.shape[1], num_heads, d).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    if legacy_scale:
        qh, kh = qh * pre, kh * pre
    logits = torch.matmul(qh.to(acc), kh.to(acc).transpose(-1, -2))
    if not legacy_scale:
        logits = logits * scale
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(w.to(acc), vh.to(acc)).to(v.dtype)
    return o.transpose(1, 2).reshape(b, t, c), torch.logsumexp(logits, dim=-1).reshape(b, -1)


def attention_plain(q, k, v, *, num_heads: int = 1, legacy_scale: bool = False):
    """The reference math on any device, in plain PyTorch; the queries [B,
    Tq, C] may be fewer than the keys and values [B, Tk, C]."""
    return _plain_with_lse(q, k, v, num_heads, legacy_scale)[0]


def attention_backward_plain(q, k, v, o, d_o, lse, *, num_heads: int = 1,
                             legacy_scale: bool = False):
    """The backward from the forward's output `o` and log-sum-exp `lse`
    ([B, H*T], head-major), FlashAttention-2 form, per head: with q' = q*s,
    k' = k*s rounded to the I/O dtype (s = d^-0.25 with `legacy_scale`,
    else 1) and S = q' k'^T * scale (scale = 1 with `legacy_scale`, else
    d^-0.5),

        P  = exp(S - lse);  D = rowsum(dO * O) over the head's d columns
        dP = dO v^T  (rounded to the I/O dtype, the gradient of the weights' cast)
        dS = P * (dP - D)
        dQ = s * rnd(scale dS k');  dK = s * rnd(scale dS^T q');  dV = P^T dO
        (P cast to v's dtype)

    where rnd() rounds to the I/O dtype, as JAX's gradient of `q * s` in a
    bf16 q rounds the einsum's cotangent first. Returns (dq, dk, dv) in the
    I/O dtype, [B, T, C]."""
    b, t, c = q.shape
    d = c // num_heads
    scale, pre = _scales(d, legacy_scale, q.dtype)

    def heads(a):  # [B, T, C] -> [B, H, T, d]
        return a.reshape(b, t, num_heads, d).transpose(1, 2)

    def back(a):  # [B, H, T, d] -> [B, T, C]
        return a.transpose(1, 2).reshape(b, t, c)

    acc = _acc(q.dtype)
    qh, kh = heads(q), heads(k)
    if legacy_scale:
        qh, kh = qh * pre, kh * pre
    qf, kf, vf, dof = (a.to(acc) for a in (qh, kh, heads(v), heads(d_o)))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse.reshape(b, num_heads, t)[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2)).to(v.dtype).to(acc)
    ds = p * (dp - (dof * heads(o).to(acc)).sum(dim=-1, keepdim=True))
    dq = (torch.matmul(ds, kf) * scale).to(q.dtype) * pre
    dk = (torch.matmul(ds.transpose(-1, -2), qf) * scale).to(k.dtype) * pre
    dv = torch.matmul(p.to(v.dtype).to(acc).transpose(-1, -2), dof)
    return back(dq), back(dk), back(dv.to(v.dtype))


def _fn(name: str, argtypes):
    fn = getattr(_build.load_library("attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 5 + [_I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _P]
_KV_ARGS = [_P] * 5 + [_I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _P]
_BWD_ARGS = [_P] * 10 + [_I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _P]


def _check_inputs(q, k, v, num_heads: int):
    """What the kernels take: q, k, v of one float32 or bfloat16 dtype, q
    a contiguous [B, Tq, C], k and v one [B, Tk, C] shape, on one device, C
    split into `num_heads` heads. Returns (B, Tq, C)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if (q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or k.shape[0] != q.shape[0]
            or k.shape[2] != q.shape[2]):
        raise ValueError(f"attention kernel takes q [B, Tq, C] and k, v of one [B, Tk, C] shape, "
                         f"got {tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel needs contiguous q, k, v")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("attention: q, k, v on different devices")
    b, t, c = q.shape
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"attention kernel: {c} channels do not split into {num_heads} heads")
    return b, t, c


def _check(q, k, v, num_heads: int = 1):
    """The forward kernel's contract, on any device: `_check_inputs`, B, T
    >= 1, a head width d that is a multiple of 16 up to 512 (a cluster of
    at most 8 blocks), and at most 65535 (sample, head) pairs. Returns (B,
    T, C)."""
    b, t, c = _check_inputs(q, k, v, num_heads)
    if b < 1 or t < 1 or k.shape[1] < 1:
        raise ValueError(f"attention kernel: empty input {tuple(q.shape)}/{tuple(k.shape)}")
    d = c // num_heads
    if d % 16 or d > _MAX_D:
        raise ValueError(f"attention kernel: head width {d} is not a multiple of 16 up to "
                         f"{_MAX_D}")
    if b * num_heads > 65535:
        raise ValueError(f"attention kernel: {b} x {num_heads} (sample, head) pairs exceed the "
                         "grid's 65535")
    if _fwd_smem_bytes(q.dtype) > _SMEM_LIMIT:
        raise ValueError(f"attention kernel: {_fwd_smem_bytes(q.dtype)} bytes of shared memory")
    return b, t, c


def _fwd_smem_bytes(dtype) -> int:
    """The forward kernel's dynamic shared memory, whatever T and d: its q'
    chunk and ring of chunks, the partial and the summed logits of a key
    tile (64 x 64 f32 each), one mbarrier per stage and one for q', and
    1 KB of alignment."""
    stages = _STAGES[dtype]
    return (1 + stages) * _CHUNK_BYTES[dtype] + 2 * 64 * 64 * 4 + 8 * (stages + 1) + 1024


def _bwd_smem_bytes(dtype, d: int) -> int:
    """The backward kernel's dynamic shared memory, whatever T: its ring of
    stages (bf16: the tile's B1, B2 chunks; f32: A1, B1, A2, B2), in bf16
    the block's resident A1, A2 chunks (2 x ceil(d / 64)), one mbarrier per
    stage and one for those, the tile's lse and D (2 x 64 f32), and 1 KB of
    alignment."""
    resident, chunks, stages = _BWD_RING[dtype]
    n_chunks = (2 * -(-d // 64) if resident else 0) + stages * chunks
    return n_chunks * _CHUNK_BYTES[dtype] + 8 * (stages + 1) + 2 * 64 * 4 + 1024


def _check_bwd(q, k, v, num_heads: int):
    """The backward kernel's contract: the forward's (`_check`) with one
    length T for q, k and v, and its shared memory, which does not grow
    with T. Returns (B, T, C)."""
    if k.shape != q.shape:
        raise ValueError(f"attention backward kernel takes q, k, v of one [B, T, C] shape, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}")
    b, t, c = _check(q, k, v, num_heads)
    smem = _bwd_smem_bytes(q.dtype, c // num_heads)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"attention backward kernel: {smem} bytes of shared memory")
    return b, t, c


def _attention_cuda(q, k, v, with_lse: bool, num_heads: int = 1, legacy_scale: bool = False):
    b, t, c = _check(q, k, v, num_heads)
    if any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("attention kernel needs 16-byte aligned q, k, v")
    scale, pre = _scales(c // num_heads, legacy_scale, q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty(b, num_heads * t, device=q.device, dtype=torch.float32) if with_lse else None
    tk = k.shape[1]
    with torch.cuda.device(q.device):  # the launch goes to the current device
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tk != t:
            code = _fn("asyrp_attention_kv", _KV_ARGS)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if with_lse else None, b, t, tk, c, num_heads, scale, pre,
                _DTYPES[q.dtype], stream)
        else:
            code = _fn("asyrp_attention", _FWD_ARGS)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if with_lse else None, b, t, c, num_heads, scale, pre,
                _DTYPES[q.dtype], stream)
    _build.check(code, "attention kernel")
    if tk != t:
        attention.kv_launches += 1
    elif num_heads == 1:
        attention.launches += 1
    else:
        attention.mh_launches += 1
    return o, lse


def _attention_bwd_cuda(q, k, v, o, d_o, lse, num_heads: int, legacy_scale: bool):
    b, t, c = _check_bwd(q, k, v, num_heads)
    d_o, o = d_o.contiguous(), o.contiguous()  # the caller's transposes may leave dO strided
    if d_o.dtype != q.dtype or d_o.shape != q.shape:
        raise ValueError(f"attention backward: dO {d_o.dtype}{tuple(d_o.shape)} does not match "
                         f"q {q.dtype}{tuple(q.shape)}")
    if any(a.data_ptr() % 16 for a in (q, k, v, d_o)):
        raise ValueError("attention backward kernel needs 16-byte aligned q, k, v, dO")
    scale, pre = _scales(c // num_heads, legacy_scale, q.dtype)
    d = torch.empty(b, num_heads * t, device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = _fn("asyrp_attention_bwd", _BWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), d_o.data_ptr(),
            lse.contiguous().data_ptr(), d.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, t, c, num_heads, scale, pre, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "attention backward kernel")
    if num_heads == 1:
        attention.bwd_launches += 1
    else:
        attention.mh_bwd_launches += 1
    return dq, dk, dv


def attention_backward(q, k, v, o, d_o, lse, *, num_heads: int = 1, legacy_scale: bool = False):
    """K2-bwd: (dq, dk, dv) from the forward's output and `lse` ([B, H*T])
    — the plain version for a CPU tensor, the kernels for a CUDA tensor."""
    b, t, _ = q.shape
    if lse.dtype != _acc(q.dtype) or tuple(lse.shape) != (b, num_heads * t):
        raise ValueError(f"attention backward with {num_heads} head(s) needs the forward's "
                         f"{_acc(q.dtype)} lse of shape {(b, num_heads * t)}, got {lse.dtype}"
                         f"{tuple(lse.shape)}")
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, o, d_o, lse, num_heads=num_heads,
                                        legacy_scale=legacy_scale)
    if q.device.type == "cuda":
        return _attention_bwd_cuda(q, k, v, o, d_o, lse, num_heads, legacy_scale)
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
        ctx.num_heads, ctx.legacy_scale = num_heads, legacy_scale
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, o, lse = ctx.saved_tensors
        return (*attention_backward(q, k, v, o, d_o, lse, num_heads=ctx.num_heads,
                                    legacy_scale=ctx.legacy_scale), None, None)


@torch.library.custom_op("asyrp::attention", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                  legacy_scale: bool) -> torch.Tensor:
    """The K2 forward as a registered op (no autograd)."""
    if q.device.type == "cuda":
        return _attention_cuda(q, k, v, False, num_heads, legacy_scale)[0]
    return attention_plain(q, k, v, num_heads=num_heads, legacy_scale=legacy_scale)


@_attention_op.register_fake
def _(q, k, v, num_heads, legacy_scale):
    return torch.empty_like(q)


def attention(q, k, v, *, num_heads: int = 1, legacy_scale: bool = False):
    if traced():
        return _attention_op(q, k, v, num_heads, legacy_scale)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if k.shape[1] != q.shape[1]:
            raise NotImplementedError("attention with Tq != Tk under autograd: spatial training "
                                      "needs K2-bwd across ranks (ROADMAP M10c)")
        return _Attention.apply(q, k, v, num_heads, legacy_scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads=num_heads, legacy_scale=legacy_scale)
    return _attention_cuda(q, k, v, False, num_heads, legacy_scale)[0]


attention.launches = 0
attention.mh_launches = 0
attention.bwd_launches = 0
attention.mh_bwd_launches = 0
attention.kv_launches = 0
