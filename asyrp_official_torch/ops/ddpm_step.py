"""The DDPM ancestral step — the hand-written CUDA kernel of
`csrc/steps.cu` and its plain PyTorch version.

Stands for the JAX `core/ddim.py` `ddpm_step` (left to XLA on the TPU), the
update of `--sample_type ddpm`. One fused elementwise pass in f32 whatever
the carry dtype:

    mean = 1 / sqrt(1 - b_t) * (x - b_t / sqrt(1 - a_t) * eps)
    out  = mean + [t != 0] * exp(logvar / 2) * noise

`b_t`, `a_t` and `t` are per sample: [1] or [B] tensors or Python numbers,
taken as `ddim_step` takes its coefficients (`ddim_step.coef_operand`: an
f32 tensor on x's device is read in place, any other is copied there as
f32 once per call). `logvar` is per element (the
learned-sigma channels of a `learn_sigma` model, shaped like x) or per
sample (the schedule's table). eps and a per-element logvar may be strided
views — the two halves of a [B, H, W, 2C] model output — which the kernel
reads in place, row by row (`ddim_step.row_stride`); where they are the two
halves of the same rows, one read of each row gives both. Bound:
device-memory bytes, as for K3.

`ddpm_step` dispatches on the tensor's device: a CPU tensor takes
`ddpm_step_plain`, a CUDA tensor launches the kernel (and bumps
`ddpm_step.launches`, and `ddpm_step.scalar_launches` for the scalar
instance), anything else raises. There is no gradient: the DDPM step serves
generation only.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import torch

from asyrp_official_torch.ops.ddim_step import (
    _DTYPES, _NONE, FLAT, ROWS, SCALAR, _check_carry, _check_like, _flat_n, _per_sample,
    _per_sample_rows, _row_stride_like, coef_arg, coef_operand, launch, step_mode)

__all__ = ["ddpm_step", "ddpm_step_plain", "ddpm_launch_args"]

# where the kernel reads logvar (`csrc/steps.cu` `LogVar`)
LV_SAMPLE, LV_ELEMENT, LV_PAIRED = 0, 1, 2


def _per_element(logvar, x) -> bool:
    return torch.is_tensor(logvar) and logvar.dim() == x.dim() and x.dim() > 1


def ddpm_step_plain(x, eps, logvar, bt, at, t, noise):
    """The reference math on any device, in plain PyTorch. Returns the next
    sample in x's dtype."""
    b, nd = x.shape[0], x.dim()
    shape = (b,) + (1,) * (nd - 1)
    btv = _per_sample(bt, b, x.device).reshape(shape)
    atv = _per_sample(at, b, x.device).reshape(shape)
    lv = logvar.float() if _per_element(logvar, x) else _per_sample(logvar, b, x.device).reshape(shape)
    weight = btv / torch.sqrt(1.0 - atv)
    mean = 1.0 / torch.sqrt(1.0 - btv) * (x.float() - weight * eps.float())
    keep = 1.0 - (_per_sample(t, b, x.device) == 0).float().reshape(shape)
    return (mean + keep * torch.exp(0.5 * lv) * noise.float()).to(x.dtype)


class DDPMArgs(NamedTuple):
    """`csrc/steps.cu` `DdpmArgs`, field for field (a per-sample operand as
    (pointer, stride, value))."""
    x: int
    eps: int
    logvar: int  # per element; 0 otherwise
    noise: int
    out: int
    bt: tuple
    at: tuple
    t: tuple
    lv: tuple  # per sample
    lv_mode: int
    batch: int
    rows: int  # rows (pixels) per sample
    channels: int
    row_eps: int
    row_logvar: int
    mode: int
    tx: int
    te: int


_DDPM_STRUCT = struct.Struct("<5q" + "qqd" * 4 + "9q")


def ddpm_launch_args(x, eps, logvar, bt, at, t, noise, *, out=None) -> DDPMArgs:
    """The arguments of one DDPM-step launch (on any device: the CPU tests
    read them), with the output's pointer where it is given. Raises on what
    the kernel does not take."""
    tx = _check_carry(x, "ddpm_step")
    per_elem = _per_element(logvar, x)
    if eps.dtype not in _DTYPES or (per_elem and logvar.dtype is not eps.dtype):
        raise TypeError(f"ddpm_step kernel: eps (and a per-element logvar) must share a float32 "
                        f"or bfloat16 dtype, got {eps.dtype}"
                        f"{f' and {logvar.dtype}' if per_elem else ''}")
    if not torch.is_tensor(noise) or noise.dtype is not x.dtype or not noise.is_contiguous():
        raise ValueError("ddpm_step kernel: noise must be a contiguous tensor in x's dtype")
    _check_like(x, "ddpm_step", eps=eps, noise=noise, logvar=logvar if per_elem else None)
    shape = x.shape
    b, c = shape[0], shape[-1]
    r_e = _row_stride_like(eps, shape)
    p_x, p_e, p_z = x.data_ptr(), eps.data_ptr(), noise.data_ptr()
    r_l, p_l, lv_mode, strides = 0, 0, LV_SAMPLE, (r_e,)
    if per_elem:
        r_l, p_l = _row_stride_like(logvar, shape), logvar.data_ptr()
        if r_l == r_e and p_l == p_e + c * eps.element_size():
            lv_mode = LV_PAIRED  # the second half of eps's rows: read with them
        else:
            lv_mode, strides = LV_ELEMENT, (r_e, r_l)
    per_sample, rows = _per_sample_rows(x)
    aligned = not (p_x | p_e | p_z | (p_l if lv_mode == LV_ELEMENT else 0)) & 15
    te = _DTYPES[eps.dtype]
    mode = step_mode(aligned, c, per_sample, rows, strides, _flat_n(tx, te),
                     rows_ok=lv_mode != LV_ELEMENT)
    if lv_mode == LV_PAIRED and mode != ROWS:
        lv_mode = LV_ELEMENT  # the flat and scalar instances read it through its own pointer
        if mode == FLAT:
            mode = SCALAR  # a paired logvar is never contiguous
    dev = x.device
    return DDPMArgs(
        p_x, p_e, p_l, p_z, 0 if out is None else out.data_ptr(), coef_arg(bt, b, dev, "bt"),
        coef_arg(at, b, dev, "at"), coef_arg(t, b, dev, "t"),
        _NONE if per_elem else coef_arg(logvar, b, dev, "logvar"), lv_mode, b, rows, c, r_e,
        r_l, mode, tx, te)


def _pack_ddpm(a: DDPMArgs) -> bytes:
    return _DDPM_STRUCT.pack(*a[:5], *a.bt, *a.at, *a.t, *a.lv, *a[9:])


def _ddpm_step_cuda(x, eps, logvar, bt, at, t, noise):
    dev = x.device
    bt, at, t = coef_operand(bt, dev), coef_operand(at, dev), coef_operand(t, dev)
    if not _per_element(logvar, x):
        logvar = coef_operand(logvar, dev)
    out = torch.empty_like(x)
    args = ddpm_launch_args(x, eps, logvar, bt, at, t, noise, out=out)
    if args.rows:
        launch("asyrp_ddpm_step", _pack_ddpm(args), args.mode, x)
        ddpm_step.launches += 1
        ddpm_step.scalar_launches += args.mode == SCALAR
    return out


def ddpm_step(x, eps, logvar, bt, at, t, noise):
    """One DDPM ancestral step. Returns the next sample in x's dtype."""
    if x.device.type == "cpu":
        return ddpm_step_plain(x, eps, logvar, bt, at, t, noise)
    if x.device.type == "cuda":
        return _ddpm_step_cuda(x, eps, logvar, bt, at, t, noise)
    raise ValueError(f"ddpm_step: no kernel for device {x.device}")


ddpm_step.launches = 0
ddpm_step.scalar_launches = 0
