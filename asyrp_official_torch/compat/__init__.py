"""Checkpoint IO of the port. Δ checkpoints are read and written by
`compat/delta_ckpt` (the port's copy of the JAX package's module); their
JAX-layout trees become the port's state dicts through `from_jax`."""

from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint, save_delta_checkpoint

__all__ = ["load_delta_checkpoint", "save_delta_checkpoint"]
