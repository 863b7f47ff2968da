"""The DDPM ancestral step — a Triton kernel and its plain PyTorch version.

Stands for the JAX `core/ddim.py` `ddpm_step` (left to XLA on the TPU), the
update of `--sample_type ddpm`. One fused elementwise pass in f32 whatever
the carry dtype:

    mean = 1 / sqrt(1 - b_t) * (x - b_t / sqrt(1 - a_t) * eps)
    out  = mean + [t != 0] * exp(logvar / 2) * noise

`b_t`, `a_t` and `t` are per sample ([B] or scalars). `logvar` is per
element (the learned-sigma channels of a `learn_sigma` model, shaped like
x) or per sample (the schedule's table). eps and a per-element logvar may
be strided views — the two halves of a [B, H, W, 2C] model output — which
the kernel reads in place, row by row (`ddim_step.row_stride`). Bound:
device-memory bytes (four reads and one write per element, a few dozen
FLOPs), no reuse: Triton's block model covers it, as for K3.

`ddpm_step` dispatches on the tensor's device: a CPU tensor takes
`ddpm_step_plain`, a CUDA tensor launches the Triton kernel (and bumps
`ddpm_step.launches`), anything else raises. Triton is imported, and the
kernel compiled, at the first CUDA call. There is no gradient: the DDPM
step serves generation only.
"""
from __future__ import annotations

import functools
import os

import torch

from asyrp_official_torch.ops import _build
from asyrp_official_torch.ops.ddim_step import _per_sample, row_stride

__all__ = ["ddpm_step", "ddpm_step_plain"]

_BLOCK = 1024


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


@functools.lru_cache(maxsize=None)
def _kernel():
    global tl
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_build.BUILD_DIR, "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def ddpm_kernel(x_ptr, eps_ptr, lv_ptr, noise_ptr, bt_ptr, at_ptr, t_ptr, out_ptr, n_elem,
                    per_sample, inner, eps_row, lv_row,
                    LV_PER_ELEM: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_elem
        s = offs // per_sample
        row = offs // inner  # eps / logvar: row `row`, column offs - row * inner
        col = offs - row * inner
        bt = tl.load(bt_ptr + s, mask=mask, other=0.5)
        a = tl.load(at_ptr + s, mask=mask, other=0.5)
        t = tl.load(t_ptr + s, mask=mask, other=0.0)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        e = tl.load(eps_ptr + row * eps_row + col, mask=mask, other=0.0).to(tl.float32)
        z = tl.load(noise_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        if LV_PER_ELEM:
            lv = tl.load(lv_ptr + row * lv_row + col, mask=mask, other=0.0).to(tl.float32)
        else:
            lv = tl.load(lv_ptr + s, mask=mask, other=0.0)
        weight = bt / tl.sqrt(1.0 - a)
        mean = 1.0 / tl.sqrt(1.0 - bt) * (x - weight * e)
        keep = tl.where(t == 0.0, 0.0, 1.0)
        out = mean + keep * tl.exp(0.5 * lv) * z
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)

    return ddpm_kernel, triton.cdiv


tl = None  # triton.language, bound at the first launch (the kernel resolves it as a global)


def _ddpm_step_cuda(x, eps, logvar, bt, at, t, noise):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ddpm_step kernel takes a float32 or bfloat16 carry, got {x.dtype}")
    per_elem = _per_element(logvar, x)
    for name, a in (("eps", eps), ("noise", noise)) + ((("logvar", logvar),) if per_elem else ()):
        if a.shape != x.shape or a.device != x.device:
            raise ValueError(f"ddpm_step kernel: {name} must be shaped and placed like x")
    if not (x.is_contiguous() and noise.is_contiguous()):
        raise ValueError("ddpm_step kernel needs a contiguous x and noise")
    b = x.shape[0]
    btv = _per_sample(bt, b, x.device).contiguous()
    atv = _per_sample(at, b, x.device).contiguous()
    tv = _per_sample(t, b, x.device).contiguous()
    lv = logvar if per_elem else _per_sample(logvar, b, x.device).contiguous()
    out = torch.empty_like(x)
    kernel, cdiv = _kernel()
    n = x.numel()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        kernel[(cdiv(n, _BLOCK),)](
            x, eps, lv, noise, btv, atv, tv, out, n, n // b, x.shape[-1], row_stride(eps),
            row_stride(lv) if per_elem else 0, LV_PER_ELEM=per_elem, BLOCK=_BLOCK,
        )
    ddpm_step.launches += 1
    return out


def ddpm_step(x, eps, logvar, bt, at, t, noise):
    """One DDPM ancestral step. Returns the next sample in x's dtype."""
    if x.device.type == "cpu":
        return ddpm_step_plain(x, eps, logvar, bt, at, t, noise)
    if x.device.type == "cuda":
        return _ddpm_step_cuda(x, eps, logvar, bt, at, t, noise)
    raise ValueError(f"ddpm_step: no kernel for device {x.device}")


ddpm_step.launches = 0
