"""The DDIM update — the port of the JAX `core/ddim.py` `ddim_step` and
`bvec`. The update itself is kernel K3 (`ops/ddim_step.py`), re-exported
here: its plain PyTorch version on the CPU, the CUDA C++ kernel of
`csrc/steps.cu` on CUDA. Its
coefficients are f32 whatever the carry dtype: alpha-bar near 1 rounds to
exactly 1.0 in bf16. `t_next == -1` is read by the caller through
`alphas_cumprod_ext[t_next + 1]`.

The DDPM ancestral step (`ddpm_step`, `--sample_type ddpm`) is its own
kernel in the same source, wrapped by `ops/ddpm_step.py`, which
`core/sampler.py` calls."""
from __future__ import annotations

from asyrp_official_torch.ops.ddim_step import ddim_step

__all__ = ["ddim_step", "bvec"]


def bvec(a, ndim: int):
    """Reshape a per-batch [B] tensor to broadcast against [B, ...]."""
    return a.reshape(tuple(a.shape) + (1,) * (ndim - a.dim()))
