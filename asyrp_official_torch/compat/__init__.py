"""Checkpoint IO of the port. Δ checkpoints are read and written by the JAX
package's numpy-only `compat/delta_ckpt` (shared, not forked); their
JAX-layout trees become the port's state dicts through `from_jax`."""

from asyrp_official_tpu.compat.delta_ckpt import load_delta_checkpoint, save_delta_checkpoint

__all__ = ["load_delta_checkpoint", "save_delta_checkpoint"]
