"""Spatial sharding: one image's activations split by rows over the ranks
of a spatial group — the port of the JAX `parallel/spatial.py`.

In the JAX package GSPMD partitions the UNet from a sharding annotation on
the input (`spatial_shard`, `batch_spatial_shard`) and inserts the
collectives itself. Here they are written out, in the layer that owns
each: every rank holds a contiguous block of rows of every activation
(NCHW inside the UNets, NHWC at their boundary), in rank order, and

  * a 3x3 convolution takes a one-row halo from each neighbour
    (`pad_rows`; zero at the image's top and bottom edge), the DDPM++
    downsample one row from below, the OpenAI stride-2 conv one from above;
  * a GroupNorm combines the ranks' per-group statistics (K1 across ranks,
    `ops/groupnorm.group_norm_across`);
  * an attention gathers K and V along the token axis (`gather`): row-block
    order is token order, so a rank's queries attend to the whole image
    (K2 with Tq = T / S, Tk = T);
  * an edit of the bottleneck h sums its norms and dot products over the
    ranks (`all_reduce_sum`), and slices Δh rows and masks to its own rows
    (`local_rows`);
  * average pooling and nearest upsampling stay local.

The inputs are placed by `parallel/mesh.Mesh.put` (the JAX `spatial_shard`
and `batch_spatial_shard`: a rank's image rows, and on a 2D mesh its batch
rows too). The group in use is set for the duration of a `with
sharded(group):` block; the model code reads it with `active()`. Every exchange is an
`all_gather` or an `all_reduce`, which NCCL and gloo both take for CUDA
tensors (gloo's since torch 2.x), so a one-card run over gloo executes the
code NCCL runs.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["SpatialGroup", "sharded", "active", "all_gather_slots", "all_reduce_sum", "gather",
           "pad_rows", "local_rows", "local_height"]


@dataclasses.dataclass(frozen=True)
class SpatialGroup:
    """`size` ranks, this one `rank`, over the process group `group`."""

    size: int
    rank: int
    group: Any = None


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("asyrp_spatial_group", default=None)


@contextlib.contextmanager
def sharded(group: Optional[SpatialGroup]):
    """The model code in this block runs on `group`'s row blocks (None, or
    a group of size 1: unsharded)."""
    token = _ACTIVE.set(group if group is not None and group.size > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[SpatialGroup]:
    return _ACTIVE.get()


def all_gather_slots(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """[size, *t.shape]: every rank's `t` in rank order."""
    if size == 1:
        return t.unsqueeze(0)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def all_reduce_sum(t: torch.Tensor, sg: SpatialGroup) -> torch.Tensor:
    """The sum of `t` over the group's ranks (a new tensor)."""
    out = t.clone()
    dist.all_reduce(out, group=sg.group)
    return out


def gather(t: torch.Tensor, dim: int, sg: SpatialGroup) -> torch.Tensor:
    """The ranks' blocks of `t` concatenated along `dim`, in rank order."""
    slots = all_gather_slots(t, sg.group, sg.size)
    return torch.cat(slots.unbind(0), dim=dim)


def pad_rows(x: torch.Tensor, sg: SpatialGroup, *, top: bool = True,
             bottom: bool = True) -> torch.Tensor:
    """NCHW `x` with the row above its block (the previous rank's last)
    on top and the row below (the next rank's first) at the bottom; zero
    rows at the image's edges. One exchange for both."""
    edges = torch.stack([x[:, :, 0], x[:, :, -1]])  # [2, B, C, W]
    slots = all_gather_slots(edges, sg.group, sg.size)
    parts = []
    if top:
        parts.append(slots[sg.rank - 1, 1] if sg.rank > 0 else torch.zeros_like(x[:, :, 0]))
    parts.append(x)
    if bottom:
        parts.append(slots[sg.rank + 1, 0] if sg.rank < sg.size - 1
                     else torch.zeros_like(x[:, :, 0]))
    return torch.cat([p if p.dim() == 4 else p.unsqueeze(2) for p in parts], dim=2)


def local_rows(t: torch.Tensor, dim: int, sg: SpatialGroup) -> torch.Tensor:
    """This rank's block of a whole-image tensor's rows along `dim`."""
    n = t.shape[dim]
    if n % sg.size:
        raise ValueError(f"{n} rows do not divide over {sg.size} spatial ranks")
    rows = n // sg.size
    return t.narrow(dim, sg.rank * rows, rows)


def local_height(height: int) -> int:
    """The rows of a `height`-row image that this rank holds."""
    sg = active()
    return height if sg is None else height // sg.size
