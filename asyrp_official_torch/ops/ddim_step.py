"""K3: the asymmetric DDIM update, forward and backward — the hand-written
CUDA kernels of `csrc/steps.cu` and their plain PyTorch versions.

Stands for the JAX `core/ddim.py` `ddim_step` (which that module calls the
sampler "kernel"; on the TPU it was left to XLA). One fused elementwise pass
in f32 whatever the carry dtype:

    x0_t   = (x - eps_mod * sqrt(1 - a)) / sqrt(a)
    c1     = eta * sqrt(clip((1 - a / a') * (1 - a') / (1 - a), 0))
    c2     = sqrt(clip((1 - a') - c1^2, 0))
    x_next = sqrt(a') * x0_t + c2 * eps + c1 * noise

with the optional dt_lambda override where `apply_dt` is set. `a`, `a'`,
`eta` and `apply_dt` are per sample: [1] or [B] tensors or Python numbers.
The kernel reads an f32 tensor on x's device in place (with a per-sample
stride of 0 or 1) and takes a number, or a one-element CPU tensor, by value;
any other tensor is first copied to x's device as f32 (`coef_operand`), once
per call. Bound: device-memory bytes; `csrc/steps.cu` says how the kernel
meets it.

eps and eps_mod may be strided views: the first C channels of a `learn_sigma`
model's [B, H, W, 2C] output (`core/sampler.py` splits it on the last axis).
The kernel reads them in place, row by row (`row_stride`), in its one pass.

`ddim_step` dispatches on the tensor's device: a CPU tensor takes
`ddim_step_plain`, a CUDA tensor launches the kernel (and bumps
`ddim_step.launches`), anything else raises. `ddim_launch_args` says which
instance a call takes (`FLAT`, `ROWS` or, where the layout or alignment
allows neither, `SCALAR`, which also bumps `ddim_step.scalar_launches`).

When x, eps or eps_mod needs a gradient (the edited step of Δ-training),
the update goes through `torch.autograd.Function`: the same forward, and the
closed-form backward, elementwise in f32 (`ddim_step_backward`; on CUDA one
launch of K3-bwd, which writes only the gradients asked for and bumps
`ddim_step.bwd_launches`):

    gx0  = g_x0_t + sqrt(a') * g_x_next
    dx   = gx0 / sqrt(a)
    deps_mod = -sqrt(1 - a) / sqrt(a) * gx0
    deps = c2 * g_x_next   (sqrt(1 - a') * dt_lambda where apply_dt is set)
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Optional

import torch

from asyrp_official_torch.ops import _build, traced

__all__ = ["ddim_step", "ddim_step_plain", "ddim_step_backward", "ddim_launch_args",
           "ddim_bwd_launch_args", "coef_operand", "row_stride", "SCALAR", "FLAT", "ROWS"]

# the kernel instances (`csrc/steps.cu` `Mode`)
SCALAR, FLAT, ROWS = 0, 1, 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _per_sample(v, b: int, device) -> torch.Tensor:
    """Scalar or [B] → f32 [B] on `device`."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    return t.expand(b) if t.numel() == 1 else t


def row_stride(t: torch.Tensor) -> int:
    """The stride between rows of `t` read as rows of its last axis: the
    last axis contiguous, one row per index of the leading axes, evenly
    spaced. A contiguous tensor's is its last axis' size; the first C
    channels of a contiguous [..., 2C] tensor give 2C. Raises for any other
    layout."""
    return _row_stride(t.shape, t.stride())


@functools.lru_cache(maxsize=256)
def _row_stride(shape, stride) -> int:
    """`row_stride` of a layout (the launch path meets the same few layouts
    at every step)."""
    nd = len(shape)
    if nd < 2 or (stride[-1] != 1 and shape[-1] > 1):
        raise ValueError(f"need a last axis of unit stride, got strides {stride}")
    row, n_rows = None, 1  # n_rows: rows spanned by the axes inside the current one
    for d in range(nd - 2, -1, -1):
        if shape[d] != 1:
            if row is None:
                row = stride[d]
            elif stride[d] != row * n_rows:
                raise ValueError(f"rows of {tuple(shape)} with strides {stride} are not "
                                 "evenly spaced")
        n_rows *= shape[d]
    row = shape[-1] if row is None else row
    if row < shape[-1]:
        raise ValueError(f"rows of {tuple(shape)} with strides {stride} overlap")
    return row


def ddim_step_plain(x, eps, eps_mod, at, at_next, eta, noise=None, *,
                    dt_lambda: float = 1.0, apply_dt=None):
    """The reference math on any device, in plain PyTorch. Returns
    (x_next, x0_t) in x's dtype."""
    b, nd = x.shape[0], x.dim()
    shape = (b,) + (1,) * (nd - 1)
    out_dtype = x.dtype
    xf, ef, emf = x.float(), eps.float(), eps_mod.float()
    a = _per_sample(at, b, x.device).reshape(shape)
    an = _per_sample(at_next, b, x.device).reshape(shape)
    et = _per_sample(eta, b, x.device).reshape(shape)
    x0_t = (xf - emf * torch.sqrt(1.0 - a)) / torch.sqrt(a)
    ratio = torch.clamp((1.0 - a / an) * (1.0 - an) / (1.0 - a), min=0.0)
    c1 = et * torch.sqrt(ratio)
    c2 = torch.sqrt(torch.clamp((1.0 - an) - c1 * c1, min=0.0))
    x_next = torch.sqrt(an) * x0_t + c2 * ef
    if noise is not None:
        x_next = x_next + c1 * noise.float()
    if apply_dt is not None:
        x_dt = torch.sqrt(an) * x0_t + torch.sqrt(1.0 - an) * ef * dt_lambda
        use = _per_sample(apply_dt, b, x.device).reshape(shape) > 0
        x_next = torch.where(use, x_dt, x_next)
    return x_next.to(out_dtype), x0_t.to(out_dtype)


def ddim_step_backward(g_x_next, g_x0_t, at, at_next, eta, *, dt_lambda: float = 1.0,
                       apply_dt=None, needs=(True, True, True)):
    """The closed-form gradient of `ddim_step` with respect to (x, eps,
    eps_mod), in f32, from the cotangents of (x_next, x0_t); either may be
    None (no gradient reaches that output). Computes only the gradients
    `needs` asks for, in that order; the others are None."""
    g = g_x_next if g_x_next is not None else g_x0_t
    b, nd = g.shape[0], g.dim()
    shape = (b,) + (1,) * (nd - 1)
    need_dx, need_deps, need_deps_mod = needs
    a = _per_sample(at, b, g.device).reshape(shape)
    gx0 = None
    if need_dx or need_deps_mod:
        if g_x0_t is not None:
            gx0 = g_x0_t.float()
        if g_x_next is not None:
            an = _per_sample(at_next, b, g.device).reshape(shape)
            term = torch.sqrt(an) * g_x_next.float()
            gx0 = term if gx0 is None else gx0 + term
    deps = None
    if need_deps:
        if g_x_next is None:
            deps = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        else:
            an = _per_sample(at_next, b, g.device).reshape(shape)
            et = _per_sample(eta, b, g.device).reshape(shape)
            c1 = et * torch.sqrt(torch.clamp((1.0 - a / an) * (1.0 - an) / (1.0 - a), min=0.0))
            c_eps = torch.sqrt(torch.clamp((1.0 - an) - c1 * c1, min=0.0))
            if apply_dt is not None:
                use = _per_sample(apply_dt, b, g.device).reshape(shape) > 0
                c_eps = torch.where(use, torch.sqrt(1.0 - an) * dt_lambda, c_eps)
            deps = c_eps * g_x_next.float()
    dx = gx0 / torch.sqrt(a) if need_dx else None
    deps_mod = -torch.sqrt(1.0 - a) / torch.sqrt(a) * gx0 if need_deps_mod else None
    return dx, deps, deps_mod


# ---------------------------------------------------------------------------
# the launch path: arguments packed for the C entry points, one launch
# ---------------------------------------------------------------------------


# A per-sample f32 operand as the kernel reads it: (pointer, stride, value),
# `pointer[s * stride]`, or `value` where the pointer is 0.
_NONE = (0, 0, 0.0)


def coef_operand(v, device):
    """A per-sample operand as the kernel can take it: a tensor of another
    dtype than float32, or on another device than `device` with more than
    one value, becomes a float32 copy on `device` (which the caller keeps
    until the launch); anything else is returned as it is: a number, an f32
    tensor on `device` (read in place), and a one-element CPU tensor for
    another device (passed by value)."""
    if type(v) is not torch.Tensor or (v.dtype is torch.float32 and v.device == device):
        return v
    if v.device.type == "cpu" and v.device != device and v.numel() == 1:
        return v
    return v.to(device, torch.float32)


def coef_arg(v, b: int, device, what: str):
    """A [1] or [B] f32 tensor on `device` is read in place: (pointer, 0 or
    its stride between samples, 0.0); a Python number, or a one-element CPU
    tensor, is passed by value: (0, 0, value). Raises for anything else."""
    if type(v) is torch.Tensor and v.dtype is torch.float32 and v.numel() == 1 and (
            v.device == device):  # the paths' case, checked first
        return v.data_ptr(), 0, 0.0
    if not isinstance(v, torch.Tensor):
        try:
            return 0, 0, float(v)
        except TypeError:
            raise TypeError(f"{what}: a number or a [1] / [{b}] tensor, got {type(v).__name__}")
    n = v.numel()
    if v.device != device:
        if v.device.type == "cpu" and n == 1:
            return 0, 0, float(v)
        raise ValueError(f"{what} [{n}] on {v.device}: a per-sample tensor must be on {device}")
    if v.dtype is not torch.float32:
        raise TypeError(f"{what}: a per-sample tensor must be float32, got {v.dtype}")
    if n == 1:
        return v.data_ptr(), 0, 0.0
    axes = [d for d, size in enumerate(v.shape) if size != 1]
    if n != b or len(axes) != 1:
        raise ValueError(f"{what}: need 1 or {b} values, got shape {tuple(v.shape)}")
    return v.data_ptr(), v.stride(axes[0]), 0.0


def _flat_n(tx: int, te: int) -> int:
    """Elements per thread of the flat instance for the dtype codes of the
    carry and of eps: one 16-byte vector of the narrower one."""
    return 4 if tx == te == 0 else 8


def _per_sample_rows(x):
    """(elements, rows of the last axis) per sample of x."""
    shape = x.shape
    per_sample = x.numel() // shape[0] if shape[0] else 0
    return per_sample, per_sample // shape[-1] if shape[-1] else 0


def step_mode(aligned: bool, channels: int, per_sample: int, rows: int, row_strides,
              flat_n: int, rows_ok: bool = True) -> int:
    """The instance a step kernel takes: FLAT where every operand read
    through its rows (`row_strides`) is contiguous like x and each sample
    fills whole vectors of `flat_n` elements, ROWS where they are the first
    3 channels of rows of 6 (`rows_ok`) and a sample's pixels come in whole
    groups of 8 (every tile of it whole 16-byte vectors), SCALAR elsewhere,
    or where a pointer is not 16-byte `aligned`."""
    if not aligned:
        return SCALAR
    if all(r == channels for r in row_strides):
        return FLAT if per_sample % flat_n == 0 else SCALAR
    if rows_ok and channels == 3 and all(r == 6 for r in row_strides) and rows % 8 == 0:
        return ROWS
    return SCALAR


def _check_carry(x, what: str) -> int:
    """x's dtype code; raises unless x is a contiguous f32 or bf16 tensor."""
    tx = _DTYPES.get(x.dtype)
    if tx is None:
        raise TypeError(f"{what} kernel takes a float32 or bfloat16 carry, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous x")
    return tx


def _row_stride_like(t, shape) -> int:
    """`row_stride` of a tensor already shaped like x: its last axis' size
    when it is contiguous."""
    return shape[-1] if t.is_contiguous() else row_stride(t)


def _check_like(x, what: str, **ts):
    shape, dev = x.shape, x.device
    for name, t in ts.items():
        if t is not None and (t.shape != shape or t.device != dev):
            raise ValueError(f"{what} kernel: {name} must be shaped and placed like x, got "
                             f"{tuple(t.shape)} on {t.device}")


class DDIMArgs(NamedTuple):
    """`csrc/steps.cu` `DdimArgs`, field for field (a per-sample operand as
    (pointer, stride, value))."""
    x: int
    eps: int
    eps_mod: int  # 0: eps itself
    noise: int
    x_next: int
    x0_t: int
    at: tuple
    at_next: tuple
    eta: tuple
    apply_dt: tuple
    dt_lambda: float
    has_dt: int
    batch: int
    rows: int  # rows (pixels) per sample
    channels: int
    row_eps: int
    row_eps_mod: int
    mode: int
    tx: int
    te: int


_DDIM_STRUCT = struct.Struct("<6q" + "qqd" * 4 + "d9q")


def ddim_launch_args(x, eps, eps_mod, at, at_next, eta, noise=None, *, dt_lambda: float = 1.0,
                     apply_dt=None, x_next=None, x0_t=None) -> DDIMArgs:
    """The arguments of one K3 launch (on any device: the CPU tests read
    them), with the outputs' pointers where they are given. Raises on what
    the kernel does not take."""
    tx = _check_carry(x, "ddim_step")
    e_dtype = eps.dtype
    te = _DTYPES.get(e_dtype)
    if te is None or eps_mod.dtype is not e_dtype:
        raise TypeError(f"ddim_step kernel: eps and eps_mod must share a float32 or bfloat16 "
                        f"dtype, got {e_dtype} and {eps_mod.dtype}")
    if noise is not None and (noise.dtype is not x.dtype or not noise.is_contiguous()):
        raise ValueError("ddim_step kernel: noise must be contiguous, in x's dtype")
    _check_like(x, "ddim_step", eps=eps, eps_mod=eps_mod, noise=noise)
    shape = x.shape
    r_e = _row_stride_like(eps, shape)
    same = eps_mod is eps
    r_m = r_e if same else _row_stride_like(eps_mod, shape)
    p_x, p_e = x.data_ptr(), eps.data_ptr()
    p_m = 0 if same else eps_mod.data_ptr()
    if p_m == p_e and r_m == r_e:  # the same view of the same tensor: read once
        same, p_m = True, 0
    p_z = 0 if noise is None else noise.data_ptr()
    per_sample, rows = _per_sample_rows(x)
    b, c, dev = shape[0], shape[-1], x.device
    mode = step_mode(not (p_x | p_e | p_m | p_z) & 15, c, per_sample, rows,
                     (r_e,) if same else (r_e, r_m), _flat_n(tx, te))
    return DDIMArgs(
        p_x, p_e, p_m, p_z, 0 if x_next is None else x_next.data_ptr(),
        0 if x0_t is None else x0_t.data_ptr(), coef_arg(at, b, dev, "at"),
        coef_arg(at_next, b, dev, "at_next"), coef_arg(eta, b, dev, "eta"),
        _NONE if apply_dt is None else coef_arg(apply_dt, b, dev, "apply_dt"),
        float(dt_lambda), int(apply_dt is not None), b, rows, c, r_e, r_m, mode, tx, te)


def _pack_ddim(a: DDIMArgs) -> bytes:
    return _DDIM_STRUCT.pack(*a[:6], *a.at, *a.at_next, *a.eta, *a.apply_dt, *a[10:])


class DDIMBwdArgs(NamedTuple):
    """`csrc/steps.cu` `DdimBwdArgs`, field for field."""
    g_x_next: int
    g_x0_t: int
    dx: int
    deps: int
    deps_mod: int
    at: tuple
    at_next: tuple
    eta: tuple
    apply_dt: tuple
    dt_lambda: float
    has_dt: int
    batch: int
    per_sample: int
    mode: int
    tx: int
    te: int


_DDIM_BWD_STRUCT = struct.Struct("<5q" + "qqd" * 4 + "d6q")


def ddim_bwd_launch_args(g_x_next, g_x0_t, at, at_next, eta, eps_dtype, *, dt_lambda=1.0,
                         apply_dt=None, dx=None, deps=None, deps_mod=None) -> DDIMBwdArgs:
    """The arguments of one K3-bwd launch: contiguous cotangents (either
    None) in the carry's dtype, the gradients of eps and eps_mod in
    `eps_dtype`, each output's pointer where it is given."""
    g = g_x_next if g_x_next is not None else g_x0_t
    for t in (g_x_next, g_x0_t):
        if t is not None:
            _check_carry(t, "ddim_step backward")
            _check_like(g, "ddim_step backward", cotangent=t)
            if t.dtype is not g.dtype:
                raise TypeError("ddim_step backward: the cotangents must share a dtype")
    te = _DTYPES.get(eps_dtype)
    if te is None:
        raise TypeError(f"ddim_step backward kernel: eps dtype {eps_dtype}")
    shape = g.shape
    ptrs = []
    for t, dt in ((g_x_next, None), (g_x0_t, None), (dx, g.dtype), (deps, eps_dtype),
                  (deps_mod, eps_dtype)):
        if t is None:
            ptrs.append(0)
            continue
        if dt is not None and (t.dtype is not dt or not t.is_contiguous() or t.shape != shape):
            raise ValueError("ddim_step backward kernel: dx in the cotangents' dtype, d eps and "
                             "d eps_mod in eps's, each contiguous and shaped like them")
        ptrs.append(t.data_ptr())
    per_sample = _per_sample_rows(g)[0]
    aligned = not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4]) & 15
    tx = _DTYPES[g.dtype]
    mode = FLAT if aligned and per_sample % _flat_n(tx, te) == 0 else SCALAR
    b, dev = shape[0], g.device
    return DDIMBwdArgs(
        *ptrs, coef_arg(at, b, dev, "at"), coef_arg(at_next, b, dev, "at_next"),
        coef_arg(eta, b, dev, "eta"),
        _NONE if apply_dt is None else coef_arg(apply_dt, b, dev, "apply_dt"),
        float(dt_lambda), int(apply_dt is not None), b, per_sample, mode, tx, te)


def _pack_ddim_bwd(a: DDIMBwdArgs) -> bytes:
    return _DDIM_BWD_STRUCT.pack(*a[:5], *a.at, *a.at_next, *a.eta, *a.apply_dt, *a[9:])


_ENTRIES = ("asyrp_ddim_step", "asyrp_ddim_step_bwd", "asyrp_ddpm_step")
_fns = {}


def kernels() -> dict:
    """The entries of `csrc/steps.cu` (built at the first call), by name;
    each takes the packed arguments and the stream."""
    if not _fns:
        lib = _build.load_library("steps")
        for name in _ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [ctypes.c_char_p, ctypes.c_void_p], ctypes.c_int
            _fns[name] = fn
    return _fns


def launch(entry: str, packed: bytes, mode: int, x) -> None:
    """One launch of `entry` on x's device and current stream; raises on a
    non-zero `cudaGetLastError()`."""
    fn = kernels()[entry]
    idx = x.get_device()
    if idx == torch.cuda.current_device():
        code = fn(packed, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            code = fn(packed, torch._C._cuda_getCurrentRawStream(idx))
    if code:
        _build.check(code, f"{entry} (instance {('scalar', 'flat', 'rows')[mode]})")


def _ddim_step_cuda(x, eps, eps_mod, at, at_next, eta, noise, dt_lambda, apply_dt):
    dev = x.device
    at, at_next, eta = coef_operand(at, dev), coef_operand(at_next, dev), coef_operand(eta, dev)
    apply_dt = None if apply_dt is None else coef_operand(apply_dt, dev)
    x_next, x0_t = torch.empty_like(x), torch.empty_like(x)
    args = ddim_launch_args(x, eps, eps_mod, at, at_next, eta, noise, dt_lambda=dt_lambda,
                            apply_dt=apply_dt, x_next=x_next, x0_t=x0_t)
    if args.rows:
        launch("asyrp_ddim_step", _pack_ddim(args), args.mode, x)
        ddim_step.launches += 1
        ddim_step.scalar_launches += args.mode == SCALAR
    return x_next, x0_t


def _ddim_step_bwd_cuda(g_x_next, g_x0_t, coeffs, dtypes, needs):
    at, at_next, eta, dt_lambda, apply_dt = coeffs
    g_x_next = None if g_x_next is None else g_x_next.contiguous()
    g_x0_t = None if g_x0_t is None else g_x0_t.contiguous()
    g = g_x_next if g_x_next is not None else g_x0_t
    dev = g.device
    at, at_next, eta = coef_operand(at, dev), coef_operand(at_next, dev), coef_operand(eta, dev)
    apply_dt = None if apply_dt is None else coef_operand(apply_dt, dev)
    outs = [torch.empty(g.shape, dtype=dt, device=dev) if need else None
            for dt, need in zip(dtypes, needs)]
    args = ddim_bwd_launch_args(g_x_next, g_x0_t, at, at_next, eta, dtypes[1],
                                dt_lambda=dt_lambda, apply_dt=apply_dt, dx=outs[0],
                                deps=outs[1], deps_mod=outs[2])
    if args.per_sample:
        launch("asyrp_ddim_step_bwd", _pack_ddim_bwd(args), args.mode, g)
        ddim_step.bwd_launches += 1
        ddim_step.scalar_launches += args.mode == SCALAR
    return outs


class _DDIMStep(torch.autograd.Function):
    """K3 with its gradient: on CUDA the kernel's forward and K3-bwd, on the
    CPU the plain forward and the closed-form backward."""

    @staticmethod
    def forward(ctx, x, eps, eps_mod, at, at_next, eta, noise, dt_lambda, apply_dt):
        if x.device.type == "cuda":
            x_next, x0_t = _ddim_step_cuda(x, eps, eps_mod, at, at_next, eta, noise, dt_lambda,
                                           apply_dt)
        else:
            x_next, x0_t = ddim_step_plain(x, eps, eps_mod, at, at_next, eta, noise,
                                           dt_lambda=dt_lambda, apply_dt=apply_dt)
        ctx.set_materialize_grads(False)  # an output no loss reaches has no cotangent to read
        ctx.coeffs = (at, at_next, eta, dt_lambda, apply_dt)
        ctx.dtypes = (x.dtype, eps.dtype, eps_mod.dtype)
        return x_next, x0_t

    @staticmethod
    def backward(ctx, g_x_next, g_x0_t):
        needs = tuple(ctx.needs_input_grad[:3])
        g = g_x_next if g_x_next is not None else g_x0_t
        if g is None or not any(needs):
            return (None,) * 9
        if g.device.type == "cuda":
            grads = _ddim_step_bwd_cuda(g_x_next, g_x0_t, ctx.coeffs, ctx.dtypes, needs)
        else:
            at, at_next, eta, dt_lambda, apply_dt = ctx.coeffs
            grads = ddim_step_backward(g_x_next, g_x0_t, at, at_next, eta, dt_lambda=dt_lambda,
                                       apply_dt=apply_dt, needs=needs)
            grads = [None if gr is None else gr.to(dt) for gr, dt in zip(grads, ctx.dtypes)]
        return (*grads, None, None, None, None, None, None)


@torch.library.custom_op("asyrp::ddim_step", mutates_args=())
def _ddim_step_op(x: torch.Tensor, eps: torch.Tensor, eps_mod: torch.Tensor, at: torch.Tensor,
                  at_next: torch.Tensor, eta: torch.Tensor, noise: Optional[torch.Tensor],
                  dt_lambda: float, apply_dt: Optional[torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The K3 forward as a registered op (no autograd); the per-sample
    operands are tensors."""
    if x.device.type == "cuda":
        return _ddim_step_cuda(x, eps, eps_mod, at, at_next, eta, noise, dt_lambda, apply_dt)
    return ddim_step_plain(x, eps, eps_mod, at, at_next, eta, noise, dt_lambda=dt_lambda,
                           apply_dt=apply_dt)


@_ddim_step_op.register_fake
def _(x, eps, eps_mod, at, at_next, eta, noise, dt_lambda, apply_dt):
    return torch.empty_like(x), torch.empty_like(x)


def _as_operand(v, x):
    return v if isinstance(v, torch.Tensor) else torch.tensor([float(v)], device=x.device)


def ddim_step(x, eps, eps_mod, at, at_next, eta, noise: Optional[torch.Tensor] = None, *,
              dt_lambda: float = 1.0, apply_dt=None):
    """One DDIM update; `noise=None` means the eta term is known to vanish
    (or eta is 0). Returns (x_next, x0_t) in x's dtype."""
    if traced():
        return _ddim_step_op(x, eps, eps_mod, _as_operand(at, x), _as_operand(at_next, x),
                             _as_operand(eta, x), noise, float(dt_lambda),
                             None if apply_dt is None else _as_operand(apply_dt, x))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ddim_step: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or eps.requires_grad
                                    or eps_mod.requires_grad):
        return _DDIMStep.apply(x, eps, eps_mod, at, at_next, eta, noise, dt_lambda, apply_dt)
    if x.device.type == "cpu":
        return ddim_step_plain(x, eps, eps_mod, at, at_next, eta, noise,
                               dt_lambda=dt_lambda, apply_dt=apply_dt)
    return _ddim_step_cuda(x, eps, eps_mod, at, at_next, eta, noise, dt_lambda, apply_dt)


ddim_step.launches = 0
ddim_step.bwd_launches = 0
ddim_step.scalar_launches = 0  # launches of the scalar instance, forward and backward
