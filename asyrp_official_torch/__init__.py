"""Asyrp on PyTorch and CUDA: h-space editing of a frozen diffusion UNet
(Asyrp, ICLR 2023), ported from the JAX package `asyrp_official_tpu`, which
stays beside it as the reference.

It imports `torch` and never `jax`. The numpy-only host modules of the JAX
package (schedules, step tables, hostrng, assets, interval selection, Δ
checkpoint IO, datasets, the grid writer, the CLI parser) are shared, not
forked. The hot ops of the serving path are hand-written Hopper kernels with
plain PyTorch versions beside them (`asyrp_official_torch.ops`).
"""

__version__ = "0.1.0"

from asyrp_official_tpu.core.schedule import make_schedule, uniform_seq

__all__ = ["make_schedule", "uniform_seq"]
