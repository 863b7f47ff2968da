"""Asyrp on PyTorch and CUDA: h-space editing of a frozen diffusion UNet
(Asyrp, ICLR 2023), ported from the JAX package `asyrp_official_tpu`, which
stays beside it as the reference.

It imports `torch`, never `jax`, and nothing of the JAX package: the
numpy-only host modules it needs (schedules, step tables, hostrng, assets,
interval selection, Δ checkpoint IO, datasets, the grid writer, the CLI
parser) and the configs and assets they read are its own copies. The hot
ops of the serving and training paths are hand-written Hopper kernels with
plain PyTorch versions beside them (`asyrp_official_torch.ops`).
"""

__version__ = "0.1.0"

from asyrp_official_torch.core.schedule import make_schedule, uniform_seq

__all__ = ["make_schedule", "uniform_seq"]
