"""K3: the asymmetric DDIM update — a Triton kernel and its plain PyTorch
version.

Stands for the JAX `core/ddim.py` `ddim_step` (which that module calls the
sampler "kernel"; on the TPU it was left to XLA). One fused elementwise pass
in f32 whatever the carry dtype:

    x0_t   = (x - eps_mod * sqrt(1 - a)) / sqrt(a)
    c1     = eta * sqrt(clip((1 - a / a') * (1 - a') / (1 - a), 0))
    c2     = sqrt(clip((1 - a') - c1^2, 0))
    x_next = sqrt(a') * x0_t + c2 * eps + c1 * noise

with the optional dt_lambda override where `apply_dt` is set. `a`, `a'` and
`eta` are per sample ([B] or scalars). Bound: device-memory bytes (four
reads and two writes per element, a few dozen FLOPs); there is no reuse, so
shared memory, wgmma and TMA have nothing to offer and Triton's block model
covers it.

`ddim_step` dispatches on the tensor's device: a CPU tensor takes
`ddim_step_plain`, a CUDA tensor launches the Triton kernel (and bumps
`ddim_step.launches`), anything else raises. Triton is imported, and the
kernel compiled, at the first CUDA call.
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import torch

from asyrp_official_torch.ops import _build

__all__ = ["ddim_step", "ddim_step_plain"]

_BLOCK = 1024


def _per_sample(v, b: int, device) -> torch.Tensor:
    """Scalar or [B] → f32 [B] on `device`."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    return t.expand(b) if t.numel() == 1 else t


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


tl = None  # triton.language, bound at the first launch (the kernel resolves it as a global)


@functools.lru_cache(maxsize=None)
def _kernel():
    global tl
    # Triton's cache stays inside the checkout unless the caller chose one
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_build.BUILD_DIR, "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def ddim_kernel(x_ptr, eps_ptr, epsm_ptr, noise_ptr, at_ptr, atn_ptr, eta_ptr, dt_ptr,
                    xn_ptr, x0_ptr, n_elem, per_sample, dt_lambda,
                    HAS_NOISE: tl.constexpr, HAS_DT: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_elem
        s = offs // per_sample
        a = tl.load(at_ptr + s, mask=mask, other=0.5)
        an = tl.load(atn_ptr + s, mask=mask, other=0.5)
        eta = tl.load(eta_ptr + s, mask=mask, other=0.0)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        e = tl.load(eps_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        em = tl.load(epsm_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        x0 = (x - em * tl.sqrt(1.0 - a)) / tl.sqrt(a)
        ratio = tl.maximum((1.0 - a / an) * (1.0 - an) / (1.0 - a), 0.0)
        c1 = eta * tl.sqrt(ratio)
        c2 = tl.sqrt(tl.maximum((1.0 - an) - c1 * c1, 0.0))
        xn = tl.sqrt(an) * x0 + c2 * e
        if HAS_NOISE:
            z = tl.load(noise_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            xn = xn + c1 * z
        if HAS_DT:
            use = tl.load(dt_ptr + s, mask=mask, other=0.0)
            x_dt = tl.sqrt(an) * x0 + tl.sqrt(1.0 - an) * e * dt_lambda
            xn = tl.where(use > 0, x_dt, xn)
        tl.store(xn_ptr + offs, xn.to(xn_ptr.dtype.element_ty), mask=mask)
        tl.store(x0_ptr + offs, x0.to(x0_ptr.dtype.element_ty), mask=mask)

    return ddim_kernel, triton.cdiv


def _ddim_step_cuda(x, eps, eps_mod, at, at_next, eta, noise, dt_lambda, apply_dt):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ddim_step kernel takes a float32 or bfloat16 carry, got {x.dtype}")
    for name, t in (("eps", eps), ("eps_mod", eps_mod), ("noise", noise)):
        if t is not None and (t.shape != x.shape or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"ddim_step kernel: {name} must be contiguous, shaped and placed like x")
    if not x.is_contiguous():
        raise ValueError("ddim_step kernel needs a contiguous x")
    b = x.shape[0]
    a = _per_sample(at, b, x.device).contiguous()
    an = _per_sample(at_next, b, x.device).contiguous()
    et = _per_sample(eta, b, x.device).contiguous()
    dt = _per_sample(apply_dt, b, x.device).contiguous() if apply_dt is not None else a
    x_next = torch.empty_like(x)
    x0_t = torch.empty_like(x)
    kernel, cdiv = _kernel()
    n = x.numel()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        kernel[(cdiv(n, _BLOCK),)](
            x, eps, eps_mod, noise if noise is not None else x, a, an, et, dt, x_next, x0_t,
            n, n // b, float(dt_lambda),
            HAS_NOISE=noise is not None, HAS_DT=apply_dt is not None, BLOCK=_BLOCK,
        )
    ddim_step.launches += 1
    return x_next, x0_t


def ddim_step(x, eps, eps_mod, at, at_next, eta, noise: Optional[torch.Tensor] = None, *,
              dt_lambda: float = 1.0, apply_dt=None):
    """One DDIM update; `noise=None` means the eta term is known to vanish
    (or eta is 0). Returns (x_next, x0_t) in x's dtype."""
    if x.device.type == "cpu":
        return ddim_step_plain(x, eps, eps_mod, at, at_next, eta, noise,
                               dt_lambda=dt_lambda, apply_dt=apply_dt)
    if x.device.type == "cuda":
        return _ddim_step_cuda(x, eps, eps_mod, at, at_next, eta, noise, dt_lambda, apply_dt)
    raise ValueError(f"ddim_step: no kernel for device {x.device}")


ddim_step.launches = 0
