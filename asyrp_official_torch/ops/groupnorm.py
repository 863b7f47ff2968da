"""K1: GroupNorm (+ optional SiLU), forward and backward — the hand-written
CUDA kernels of `csrc/groupnorm.cu` and their plain PyTorch versions.

Stands for the JAX `models/common.py` `group_norm` (with `models/ddpmpp.py`
`_gn_silu` when `silu=True`) and the gradient XLA derives for it. Tensors
are NCHW (any trailing spatial rank): `[B, C, *spatial]`. Statistics,
affine and gradients run in f32 whatever the I/O dtype, and each result is
cast back once.

The serving entry also takes the elementwise ops around the norm:
`pre_add` [B, C] (DDPM++ `h + temb_proj(...)`, added before the
statistics) and `scale_shift` [B, 2C] (the OpenAI FiLM epilogue
`y * (1 + scale) + shift`, then SiLU if `silu`), each step rounded to the
I/O dtype as the separate torch ops round it (`group_norm_plain` composes
exactly those ops).

`group_norm` dispatches on the tensor's device: a CPU tensor takes the plain
versions, a CUDA tensor launches the kernels, anything else raises. Without
a gradient to track, a CUDA call is one kernel launch, fused ops included.
When a gradient is needed it takes `group_norm_unfused`: the torch ops
around K1's `torch.autograd.Function`, whose forward also keeps each group's
mean and rstd (f32) and whose backward computes dx, and dweight/dbias when
the weight is trained, from them — `group_norm_backward_plain` on the CPU,
kernel K1-bwd on CUDA. `group_norm.launches` and `group_norm.bwd_launches`
count the kernel launches.

Across ranks (spatial sharding, `parallel/spatial.py`), `group_norm_across`
normalizes a tensor whose rows are split over a group of ranks: each rank's
per-group (count, mean, M2) (`group_norm_part_stats`, kernel `gn_part`:
gn_fwd's statistics passes), gathered, then the normalize of the local rows
(`group_norm_apply`, kernel `gn_apply`, which combines the ranks' parts by
Chan's formula in its prologue; `combine_group_stats` is the plain
version's), pre-add and FiLM fused as in the one-rank entry. `group_norm.part_launches` and `group_norm.apply_launches`
count those launches. Under autograd it is `_GroupNormAcross` between the
same torch ops as `group_norm_unfused`: its backward sums each (sample,
group)'s dz·w and dz·w·xhat over the local rows (`group_norm_bwd_part`,
kernel `gn_bwd_part`: gn_bwd's sums pass, which also gives the per-channel
partial sums of dw and db), all-reduces those sums over the ranks, and forms
dx from them and the group's count (`group_norm_bwd_apply`, kernel
`gn_bwd_apply`); the weight, bias
and fused operands' gradients are this rank's partials, which the caller
sums over the ranks (`parallel/spatial.py`, rule 3).
`group_norm.bwd_part_launches` and `group_norm.bwd_apply_launches` count
those launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from typing import Optional

from asyrp_official_torch.ops import _build, traced

__all__ = ["group_norm", "group_norm_plain", "group_norm_unfused", "group_norm_backward",
           "group_norm_backward_plain", "group_norm_plan", "group_norm_across",
           "group_norm_part_stats", "group_norm_part_stats_plain", "combine_group_stats",
           "group_norm_apply", "group_norm_apply_plain", "group_norm_bwd_part",
           "group_norm_bwd_part_plain", "group_norm_bwd_apply", "group_norm_bwd_apply_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bshape(x):
    return (1, x.shape[1]) + (1,) * (x.dim() - 2)


def _per_channel(t, x):
    """[B, C] -> [B, C, 1, ...] against x."""
    return t.reshape(t.shape[:2] + (1,) * (x.dim() - 2))


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


def _film(y, scale_shift, silu):
    """y * (1 + scale) + shift, then SiLU: torch ops in y's dtype."""
    scale, shift = (_per_channel(t, y) for t in scale_shift.chunk(2, dim=1))
    y = y * (1.0 + scale) + shift
    return F.silu(y) if silu else y


def group_norm_plain(x, weight, bias, *, groups: int = 32, eps: float = 1e-6, silu: bool = False,
                     pre_add=None, scale_shift=None):
    """The reference math on any device, in plain PyTorch. `pre_add` [B, C]
    is added to x in x's dtype before the statistics; `scale_shift` [B, 2C]
    turns the norm's output y into y * (1 + scale) + shift, then SiLU if
    `silu` (without it, `silu` is the fused GroupNorm+SiLU)."""
    if pre_add is not None:
        x = x + _per_channel(pre_add, x)
    if scale_shift is None:
        return _plain_with_stats(x, weight, bias, groups, eps, silu)[0]
    return _film(_plain_with_stats(x, weight, bias, groups, eps, False)[0], scale_shift, silu)


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


# the C entry points, their argument types set once
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = {
    "asyrp_group_norm": [_P] * 8 + [_I, _I, _L, _I, ctypes.c_float, _I, _I, _P],
    "asyrp_group_norm_bwd": [_P] * 8 + [_I, _I, _L, _I, _I, _I, _P],
    "asyrp_group_norm_plan": [_I, _I, _L, _I, _I, _I, ctypes.POINTER(_L)],
    "asyrp_group_norm_part_stats": [_P] * 3 + [_I, _I, _L, _I, _I, _P],
    "asyrp_group_norm_apply": [_P] * 9 + [_I, _I, _I, _L, _I, ctypes.c_float, _I, _I, _P],
    "asyrp_group_norm_bwd_part": [_P] * 8 + [_I, _I, _L, _I, _I, _I, _P],
    "asyrp_group_norm_bwd_apply": [_P] * 8 + [ctypes.c_float, _I, _I, _L, _I, _I, _I, _P],
}
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load_library("groupnorm")
        for name, argtypes in _ARGS.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _lib = lib
    return _lib


def _launch(fn, x, *args):
    """Run `fn` on x's device and current stream; the device is switched only
    when it is not the current one."""
    idx = x.get_device()
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def _check_input(x, weight, bias, groups):
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm kernel needs a contiguous NCHW tensor")
    shape = x.shape
    b, c = shape[0], shape[1]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    dev = x.get_device()
    for t in (weight, bias):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.get_device() != dev
                or t.numel() != c):
            raise ValueError("group_norm weight/bias must be float32, contiguous, [C] and on "
                             "the input's device")
    return b, c, x.numel() // (b * c)


def _check_per_channel(t, x, width, what):
    """[B, width * C] in x's dtype, contiguous (a batch of 1 broadcast)."""
    if t is None:
        return None
    b, c = x.shape[:2]
    if t.shape == (b, width * c) and t.is_contiguous() and t.dtype == x.dtype and (
            t.get_device() == x.get_device()):
        return t
    if (t.dtype != x.dtype or t.device != x.device or t.dim() != 2
            or t.shape[0] not in (1, b) or t.shape[1] != width * c):
        raise ValueError(f"group_norm {what} must be [{b}, {width * c}] {x.dtype} on the input's "
                         f"device, got {t.dtype}{tuple(t.shape)}")
    return t.expand(b, -1).contiguous()


def _group_norm_cuda(x, weight, bias, groups, eps, silu, stats: bool, pre_add=None,
                     scale_shift=None):
    b, c, hw = _check_input(x, weight, bias, groups)
    pre_add = _check_per_channel(pre_add, x, 1, "pre_add")
    scale_shift = _check_per_channel(scale_shift, x, 2, "scale_shift")
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty(2, b, groups, device=x.device, dtype=torch.float32)
    code = _launch(
        _kernels().asyrp_group_norm, x, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), None if pre_add is None else pre_add.data_ptr(),
        None if scale_shift is None else scale_shift.data_ptr(),
        None if mean is None else mean.data_ptr(), None if rstd is None else rstd.data_ptr(),
        b, c, hw, groups, eps, silu, _DTYPES[x.dtype])
    _build.check(code, "group_norm kernel")
    group_norm.launches += 1
    return y, mean, rstd


def _group_norm_bwd_cuda(x, dy, weight, bias, mean, rstd, groups, silu, weight_grad):
    b, c, hw = _check_input(x, weight, bias, groups)
    dy = dy.contiguous()
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"group_norm backward: dy {dy.dtype}{tuple(dy.shape)} does not match "
                         f"x {x.dtype}{tuple(x.shape)}")
    mean, rstd = mean.contiguous(), rstd.contiguous()
    dx = torch.empty_like(x)
    # per sample: the sums of dz * xhat and of dz over each channel's H*W
    wsum = torch.empty(b, 2, c, device=x.device, dtype=torch.float32) if weight_grad else None
    code = _launch(
        _kernels().asyrp_group_norm_bwd, x, x.data_ptr(), dy.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        None if wsum is None else wsum.data_ptr(), b, c, hw, groups, silu, _DTYPES[x.dtype])
    _build.check(code, "group_norm backward kernel")
    group_norm.bwd_launches += 1
    if not weight_grad:
        return dx, None, None
    dw, db = wsum[0] if b == 1 else wsum.sum(dim=0)
    return dx, dw, db


def group_norm_plan(shape, dtype, *, groups: int = 32, backward: bool = False,
                    weight_grad: bool = False):
    """The launch plan the kernel takes for an NCHW `shape` (on the card):
    {cluster, vec, slice_vectors, resident_x, resident_dy, smem_bytes,
    group_vectors, threads}. A slice larger than its resident part streams the rest
    from device memory."""
    b, c = shape[:2]
    hw = 1
    for d in shape[2:]:
        hw *= d
    out = (ctypes.c_int64 * 8)()
    code = _kernels().asyrp_group_norm_plan(b, c, hw, groups, _DTYPES[dtype],
                                            (2 if weight_grad else 1) if backward else 0, out)
    _build.check(code, "group_norm plan")
    keys = ("cluster", "vec", "slice_vectors", "resident_x", "resident_dy", "smem_bytes",
            "group_vectors", "threads")
    return dict(zip(keys, out))


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


def _norm(x, weight, bias, groups, eps, silu):
    """K1 alone: under autograd its Function, else the kernel or the plain
    version."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNorm.apply(x, weight, bias, groups, eps, silu)
    if x.device.type == "cuda":
        return _group_norm_cuda(x, weight, bias, groups, eps, silu, stats=False)[0]
    return group_norm_plain(x, weight, bias, groups=groups, eps=eps, silu=silu)


def group_norm_unfused(x, weight, bias, *, groups: int = 32, eps: float = 1e-6,
                       silu: bool = False, pre_add=None, scale_shift=None):
    """`group_norm`'s function as K1 between separate torch ops: the path
    under autograd (K1's gradient is K1-bwd), and on the card the fused
    kernel's yardstick."""
    if pre_add is not None:
        x = x + _per_channel(pre_add, x)
    if scale_shift is None:
        return _norm(x, weight, bias, groups, eps, silu)
    return _film(_norm(x, weight, bias, groups, eps, False), scale_shift, silu)


def _unfused_needed(x, weight, bias, pre_add, scale_shift) -> bool:
    """A gradient to track, or a fused operand whose dtype would promote x's
    (the separate torch ops then give the promoted result)."""
    for t in (pre_add, scale_shift):
        if t is not None and (t.dtype != x.dtype or (torch.is_grad_enabled() and t.requires_grad)):
            return True
    return torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                        or bias.requires_grad)


@torch.library.custom_op("asyrp::group_norm", mutates_args=())
def _group_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                   eps: float, silu: bool, pre_add: Optional[torch.Tensor],
                   scale_shift: Optional[torch.Tensor]) -> torch.Tensor:
    """The fused K1 call as a registered op (no autograd)."""
    if x.device.type == "cuda":
        return _group_norm_cuda(x, weight, bias, groups, eps, silu, False, pre_add,
                                scale_shift)[0]
    return group_norm_plain(x, weight, bias, groups=groups, eps=eps, silu=silu, pre_add=pre_add,
                            scale_shift=scale_shift)


@_group_norm_op.register_fake
def _(x, weight, bias, groups, eps, silu, pre_add, scale_shift):
    return torch.empty_like(x)


def group_norm(x, weight, bias, *, groups: int = 32, eps: float = 1e-6, silu: bool = False,
               pre_add=None, scale_shift=None):
    if traced():
        return _group_norm_op(x, weight, bias, groups, eps, silu, pre_add, scale_shift)
    if _unfused_needed(x, weight, bias, pre_add, scale_shift):
        return group_norm_unfused(x, weight, bias, groups=groups, eps=eps, silu=silu,
                                  pre_add=pre_add, scale_shift=scale_shift)
    if x.device.type == "cuda":
        return _group_norm_cuda(x, weight, bias, groups, eps, silu, False, pre_add,
                                scale_shift)[0]
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups=groups, eps=eps, silu=silu,
                                pre_add=pre_add, scale_shift=scale_shift)
    raise ValueError(f"group_norm: no kernel for device {x.device}")


group_norm.launches = 0
group_norm.bwd_launches = 0


# ---------------------------------------------------------------------------
# K1 across ranks: a group's rows split over the ranks of a spatial group
# ---------------------------------------------------------------------------


def group_norm_part_stats_plain(x, *, groups: int = 32, pre_add=None):
    """Per (sample, group) of the local x (+ `pre_add`, added in x's dtype):
    (count, mean, M2) in f32, two-pass (the mean, then the centred squares),
    as [B, G, 1, 3]."""
    if pre_add is not None:
        x = x + _per_channel(pre_add, x)
    b = x.shape[0]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=2)
    m2 = (xf - mean[..., None]).square().sum(dim=2)
    n = torch.full_like(mean, float(xf.shape[2]))
    return torch.stack([n, mean, m2], dim=-1)[:, :, None]


def combine_group_stats(parts, eps: float):
    """Chan's combination of partial statistics [..., B, G, P, 3] (the
    leading axes: the ranks) into each group's (mean, rstd) [B, G] f32:
    mean = sum n_i m_i / N, M2 = sum M2_i + sum n_i (m_i - mean)^2. The
    specification of `gn_apply`'s prologue, which combines the ranks' parts
    the same way, in rank order."""
    parts = parts.float()
    if parts.dim() > 4:  # the ranks' axes join the parts'
        parts = parts.movedim(tuple(range(parts.dim() - 4)),
                              tuple(range(3, parts.dim() - 1))).flatten(2, -2)
    n, m, m2 = parts.unbind(-1)
    total = n.sum(dim=-1)
    mean = (n * m).sum(dim=-1) / total
    var = (m2.sum(dim=-1) + (n * (m - mean[..., None]).square()).sum(dim=-1)) / total
    return mean, torch.rsqrt(var + eps)


def group_norm_apply_plain(x, weight, bias, parts, *, eps: float = 1e-6, silu: bool = False,
                           pre_add=None, scale_shift=None, stats: bool = False):
    """`group_norm_plain` of the local rows with each group's statistics
    combined from `parts` [S, B, G, P, 3] (every rank's, in rank order;
    `combine_group_stats`): the normalize, the affine, the FiLM epilogue and
    SiLU, rounded as there. With `stats`, (y, mean, rstd)."""
    mean, rstd = combine_group_stats(parts, eps)
    if pre_add is not None:
        x = x + _per_channel(pre_add, x)
    b, groups = mean.shape
    xf = x.float().reshape(b, groups, -1)
    y = ((xf - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    y = y * weight.float().reshape(_bshape(x)) + bias.float().reshape(_bshape(x))
    if scale_shift is None:
        y = (y * torch.sigmoid(y) if silu else y).to(x.dtype)
    else:
        y = _film(y.to(x.dtype), scale_shift, silu)
    return (y, mean, rstd) if stats else y


def _part_stats_cuda(x, groups, pre_add):
    b, c = x.shape[:2]
    if x.dtype not in _DTYPES or not x.is_contiguous() or c % groups:
        raise ValueError(f"group_norm part stats: a contiguous float32/bfloat16 NCHW tensor with "
                         f"channels in {groups} groups, got {x.dtype}{tuple(x.shape)}")
    hw = x.numel() // (b * c)
    pre_add = _check_per_channel(pre_add, x, 1, "pre_add")
    parts = torch.empty(b, groups, 1, 3, device=x.device, dtype=torch.float32)
    code = _launch(_kernels().asyrp_group_norm_part_stats, x, x.data_ptr(),
                   None if pre_add is None else pre_add.data_ptr(), parts.data_ptr(), b, c, hw,
                   groups, _DTYPES[x.dtype])
    _build.check(code, "group_norm part-stats kernel")
    group_norm.part_launches += 1
    return parts


def _apply_cuda(x, weight, bias, parts, eps, silu, pre_add, scale_shift, stats):
    groups = parts.shape[-3]
    b, c, hw = _check_input(x, weight, bias, groups)
    if (parts.dtype != torch.float32 or parts.dim() != 5 or parts.shape[1:] != (b, groups, 1, 3)
            or parts.get_device() != x.get_device()):
        raise ValueError(f"group_norm apply: parts must be the gathered float32 [S, {b}, "
                         f"{groups}, 1, 3] on the input's device, got {parts.dtype}"
                         f"{tuple(parts.shape)}")
    pre_add = _check_per_channel(pre_add, x, 1, "pre_add")
    scale_shift = _check_per_channel(scale_shift, x, 2, "scale_shift")
    parts = parts.contiguous()
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty(2, b, groups, device=x.device, dtype=torch.float32)
    code = _launch(_kernels().asyrp_group_norm_apply, x, x.data_ptr(), weight.data_ptr(),
                   bias.data_ptr(), None if pre_add is None else pre_add.data_ptr(),
                   None if scale_shift is None else scale_shift.data_ptr(), parts.data_ptr(),
                   None if mean is None else mean.data_ptr(),
                   None if rstd is None else rstd.data_ptr(), y.data_ptr(), parts.shape[0], b, c,
                   hw, groups, eps, silu, _DTYPES[x.dtype])
    _build.check(code, "group_norm apply kernel")
    group_norm.apply_launches += 1
    return (y, mean, rstd) if stats else y


def group_norm_part_stats(x, *, groups: int = 32, pre_add=None):
    """The local (count, mean, M2) [B, G, 1, 3] f32 of each (sample,
    group): the plain version for a CPU tensor, the kernel for a CUDA
    tensor."""
    if x.device.type == "cpu":
        return group_norm_part_stats_plain(x, groups=groups, pre_add=pre_add)
    if x.device.type == "cuda":
        return _part_stats_cuda(x, groups, pre_add)
    raise ValueError(f"group_norm_part_stats: no kernel for device {x.device}")


def group_norm_apply(x, weight, bias, parts, *, eps: float = 1e-6, silu: bool = False,
                     pre_add=None, scale_shift=None, stats: bool = False):
    """y from the gathered `parts` [S, B, G, 1, 3]: the plain version for a
    CPU tensor, the kernel for a CUDA tensor (which combines the parts in
    its prologue). With `stats`, (y, mean, rstd): the combined statistics
    [B, G] f32 the backward reads."""
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, weight, bias, parts, eps=eps, silu=silu,
                                      pre_add=pre_add, scale_shift=scale_shift, stats=stats)
    if x.device.type == "cuda":
        return _apply_cuda(x, weight, bias, parts, eps, silu, pre_add, scale_shift, stats)
    raise ValueError(f"group_norm_apply: no kernel for device {x.device}")


def _xhat_dz(x, dy, weight, bias, mean, rstd, silu):
    """xhat and dz (dy through SiLU's derivative), f32, as
    `group_norm_backward_plain` forms them."""
    b, groups = mean.shape
    w = weight.float().reshape(_bshape(x))
    xhat = ((x.float().reshape(b, groups, -1) - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    dz = dy.float()
    if silu:
        z = xhat * w + bias.float().reshape(_bshape(x))
        s = torch.sigmoid(z)
        dz = dz * s * (1.0 + z * (1.0 - s))
    return xhat, dz


def group_norm_bwd_part_plain(x, dy, weight, bias, mean, rstd, *, silu: bool = False):
    """Over this rank's rows of each (sample, group), from the combined
    `mean` and `rstd` ([B, G] f32): (sums [B, G, 2] f32 of g = dz·w and of
    g·xhat, wsum [B, 2, C] f32 of dz·xhat and of dz per channel: this rank's
    partials of dw and db)."""
    b, groups = mean.shape
    xhat, dz = _xhat_dz(x, dy, weight, bias, mean, rstd, silu)
    sum_dims = list(range(2, x.dim()))
    wsum = torch.stack([(dz * xhat).sum(dim=sum_dims), dz.sum(dim=sum_dims)], dim=1)
    # g = dz·w summed per group: w times the per-channel sums
    gsum = (wsum * weight.float()).reshape(b, 2, groups, -1).sum(dim=-1)
    return torch.stack([gsum[:, 1], gsum[:, 0]], dim=-1), wsum


def group_norm_bwd_apply_plain(x, dy, weight, bias, mean, rstd, sums, count: int, *,
                               silu: bool = False):
    """dx = rstd·(g - mean(g) - xhat·mean(g·xhat)), g = dz·w, from the
    ranks' summed `sums` [B, G, 2] over the whole group's `count`
    elements."""
    b, groups = mean.shape
    means = sums / count
    xhat, dz = _xhat_dz(x, dy, weight, bias, mean, rstd, silu)
    g = (dz * weight.float().reshape(_bshape(x))).reshape(b, groups, -1)
    xg = xhat.reshape(b, groups, -1)
    dx = rstd[..., None] * (g - means[..., 0:1] - xg * means[..., 1:2])
    return dx.reshape(x.shape).to(x.dtype)


def _bwd_operands(x, dy, weight, bias, mean, rstd):
    b, c, hw = _check_input(x, weight, bias, mean.shape[1])
    dy = dy.contiguous()
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"group_norm backward: dy {dy.dtype}{tuple(dy.shape)} does not match "
                         f"x {x.dtype}{tuple(x.shape)}")
    return b, c, hw, dy, mean.float().contiguous(), rstd.float().contiguous()


def _bwd_part_cuda(x, dy, weight, bias, mean, rstd, silu):
    b, c, hw, dy, mean, rstd = _bwd_operands(x, dy, weight, bias, mean, rstd)
    groups = mean.shape[1]
    sums = torch.empty(b, groups, 2, device=x.device, dtype=torch.float32)
    wsum = torch.empty(b, 2, c, device=x.device, dtype=torch.float32)
    code = _launch(_kernels().asyrp_group_norm_bwd_part, x, x.data_ptr(), dy.data_ptr(),
                   weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                   sums.data_ptr(), wsum.data_ptr(), b, c, hw, groups, silu, _DTYPES[x.dtype])
    _build.check(code, "group_norm backward part kernel")
    group_norm.bwd_part_launches += 1
    return sums, wsum


def _bwd_apply_cuda(x, dy, weight, bias, mean, rstd, sums, count, silu):
    b, c, hw, dy, mean, rstd = _bwd_operands(x, dy, weight, bias, mean, rstd)
    sums = sums.float().contiguous()
    dx = torch.empty_like(x)
    code = _launch(_kernels().asyrp_group_norm_bwd_apply, x, x.data_ptr(), dy.data_ptr(),
                   weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                   sums.data_ptr(), dx.data_ptr(), float(count), b, c, hw, mean.shape[1], silu,
                   _DTYPES[x.dtype])
    _build.check(code, "group_norm backward apply kernel")
    group_norm.bwd_apply_launches += 1
    return dx


def group_norm_bwd_part(x, dy, weight, bias, mean, rstd, *, silu: bool = False):
    """K1-bwd across ranks, step 1: (sums [B, G, 2], wsum [B, 2, C]) of
    this rank's rows — the plain version for a CPU tensor, the kernel for a
    CUDA tensor."""
    if x.device.type == "cpu":
        return group_norm_bwd_part_plain(x, dy, weight, bias, mean, rstd, silu=silu)
    if x.device.type == "cuda":
        return _bwd_part_cuda(x, dy, weight, bias, mean, rstd, silu)
    raise ValueError(f"group_norm_bwd_part: no kernel for device {x.device}")


def group_norm_bwd_apply(x, dy, weight, bias, mean, rstd, sums, count: int, *,
                         silu: bool = False):
    """K1-bwd across ranks, step 2: dx of this rank's rows from the ranks'
    summed `sums` over the group's `count` elements — the plain version for
    a CPU tensor, the kernel for a CUDA tensor (which divides in its
    prologue)."""
    if x.device.type == "cpu":
        return group_norm_bwd_apply_plain(x, dy, weight, bias, mean, rstd, sums, count,
                                          silu=silu)
    if x.device.type == "cuda":
        return _bwd_apply_cuda(x, dy, weight, bias, mean, rstd, sums, count, silu)
    raise ValueError(f"group_norm_bwd_apply: no kernel for device {x.device}")


class _GroupNormAcross(torch.autograd.Function):
    """K1 across ranks with its gradient. The forward's combined statistics
    are constants of the backward's formula, so the backward needs one
    exchange: the all-reduce (`reduce`) of each group's two sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, gather, reduce, groups, eps, silu):
        parts = gather(group_norm_part_stats(x, groups=groups))
        y, mean, rstd = group_norm_apply(x, weight, bias, parts, eps=eps, silu=silu, stats=True)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.reduce, ctx.silu = reduce, silu
        # the whole group's count: the ranks hold equal row blocks
        ctx.count = parts.shape[0] * (x.shape[1] // groups) * (
            x.numel() // (x.shape[0] * x.shape[1]))
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        sums, wsum = group_norm_bwd_part(x, dy, weight, bias, mean, rstd, silu=ctx.silu)
        dx = group_norm_bwd_apply(x, dy, weight, bias, mean, rstd, ctx.reduce(sums), ctx.count,
                                  silu=ctx.silu)
        dw, db = wsum[0] if wsum.shape[0] == 1 else wsum.sum(dim=0)
        return (dx if ctx.needs_input_grad[0] else None, dw.to(weight.dtype),
                db.to(bias.dtype), None, None, None, None, None)


def group_norm_across(x, weight, bias, gather, *, reduce=None, groups: int = 32,
                      eps: float = 1e-6, silu: bool = False, pre_add=None, scale_shift=None):
    """`group_norm` of a tensor whose rows are split over ranks: the local
    statistics, `gather(parts)` -> [S, B, G, 1, 3] (every rank's, in rank
    order), then the normalize of the local rows from their combination.
    Under autograd `_GroupNormAcross` between separate torch ops (as
    `group_norm_unfused`), whose backward sums over the ranks with
    `reduce(t)` (an all-reduce, required there)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias, pre_add, scale_shift)):
        if reduce is None:
            raise ValueError("group_norm_across under autograd needs `reduce` (the all-reduce "
                             "of the backward's sums over the ranks)")
        if pre_add is not None:
            x = x + _per_channel(pre_add, x)
        y = _GroupNormAcross.apply(x, weight, bias, gather, reduce, groups, eps,
                                   silu and scale_shift is None)
        return y if scale_shift is None else _film(y, scale_shift, silu)
    parts = gather(group_norm_part_stats(x, groups=groups, pre_add=pre_add))
    return group_norm_apply(x, weight, bias, parts, eps=eps, silu=silu, pre_add=pre_add,
                            scale_shift=scale_shift)


group_norm.part_launches = 0
group_norm.apply_launches = 0
group_norm.bwd_part_launches = 0
group_norm.bwd_apply_launches = 0
