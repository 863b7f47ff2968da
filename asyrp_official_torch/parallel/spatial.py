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

Training on row blocks (GSPMD derives the same for the JAX package) rests
on three rules, which every sharded module keeps:

  1. Each exchange's backward is its exact adjoint. `gather` (an
     all_gather along the rows) takes back an all_reduce (sum) of the whole
     gradient, then this rank's rows; `all_reduce_sum` an all_reduce; a
     halo of `pad_rows` sends the halo row's gradient back to the rank that
     owns that row, which adds it to its edge row. Each is a
     `torch.autograd.Function`; every rank issues the same collectives in
     the same order in the backward, the edge ranks too (a zero halo still
     takes part in the exchange). The exchanges inside K1 across ranks
     (`ops/groupnorm._GroupNormAcross`) and K2's gathered K/V follow it.
  2. Each rank backpropagates its share of the loss, and the shares sum
     over the spatial group to the loss one process computes: a term summed
     over pixels is its local sum over the global count; a term computed
     on the whole image (`gather_image`: the CLIP directional term, the ID
     term) is computed on every rank and weighted 1/S
     (`parallel/mesh.loss_share`).
  3. Parameter gradients are summed over the spatial group, then averaged
     over the data axis (`parallel/mesh.Mesh.sync_grads`).

Break any one and the trained Δ lands S times off, or on one rank's rows.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["SpatialGroup", "sharded", "active", "all_gather_slots", "all_reduce_sum", "gather",
           "gather_image", "pad_rows", "local_rows", "local_height"]


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


def _all_reduce(t: torch.Tensor, sg: SpatialGroup) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=sg.group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; its adjoint is the same sum."""

    @staticmethod
    def forward(ctx, t, sg):
        ctx.sg = sg
        return _all_reduce(t, sg)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.sg), None


class _Gather(torch.autograd.Function):
    """The ranks' blocks concatenated along `dim`; the adjoint sums the
    whole gradient over the ranks (each rank's consumers of the gathered
    tensor gave their part) and keeps this rank's block."""

    @staticmethod
    def forward(ctx, t, dim, sg):
        ctx.dim, ctx.sg, ctx.n = dim, sg, t.shape[dim]
        slots = all_gather_slots(t, sg.group, sg.size)
        return torch.cat(slots.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.sg)
        return g.narrow(ctx.dim, ctx.sg.rank * ctx.n, ctx.n).contiguous(), None, None


class _PadRows(torch.autograd.Function):
    """NCHW x with its neighbours' edge rows as halos (see `pad_rows`). The
    adjoint sends each halo row's gradient back to its owner: one exchange
    of every rank's two halo gradients (zero at the image's edges and where
    a side has no halo), added to the owner's first and last rows."""

    @staticmethod
    def forward(ctx, x, sg, top, bottom):
        ctx.sg, ctx.top, ctx.bottom = sg, top, bottom
        edges = torch.stack([x[:, :, 0], x[:, :, -1]])  # [2, B, C, W]
        slots = all_gather_slots(edges, sg.group, sg.size)
        zero = torch.zeros_like(x[:, :, :1])
        parts = []
        if top:
            parts.append(slots[sg.rank - 1, 1].unsqueeze(2) if sg.rank > 0 else zero)
        parts.append(x)
        if bottom:
            parts.append(slots[sg.rank + 1, 0].unsqueeze(2) if sg.rank < sg.size - 1 else zero)
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        sg, top, bottom = ctx.sg, ctx.top, ctx.bottom
        h = g.shape[2] - int(top) - int(bottom)
        zero = torch.zeros_like(g[:, :, 0])
        # the gradients of this rank's halos: the top one belongs to the
        # previous rank's last row, the bottom one to the next rank's first
        halos = torch.stack([g[:, :, 0] if top else zero, g[:, :, -1] if bottom else zero])
        slots = all_gather_slots(halos, sg.group, sg.size)
        dx = g.narrow(2, int(top), h).clone()
        if sg.rank > 0:  # the previous rank's bottom halo was this rank's first row
            dx[:, :, 0] += slots[sg.rank - 1, 1]
        if sg.rank < sg.size - 1:  # the next rank's top halo was this rank's last row
            dx[:, :, -1] += slots[sg.rank + 1, 0]
        return dx, None, None, None


def all_reduce_sum(t: torch.Tensor, sg: SpatialGroup) -> torch.Tensor:
    """The sum of `t` over the group's ranks (a new tensor); differentiable:
    its gradient is the sum of the ranks' gradients."""
    return _AllReduceSum.apply(t, sg)


def gather(t: torch.Tensor, dim: int, sg: SpatialGroup) -> torch.Tensor:
    """The ranks' blocks of `t` concatenated along `dim`, in rank order;
    differentiable (rule 1)."""
    return _Gather.apply(t, dim, sg)


def gather_image(x: torch.Tensor, sg: Optional[SpatialGroup]) -> torch.Tensor:
    """The whole NHWC image from this rank's rows, on every rank (for the
    loss nets); `x` itself without a group. Differentiable (rule 1)."""
    return x if sg is None else gather(x, 1, sg)


def pad_rows(x: torch.Tensor, sg: SpatialGroup, *, top: bool = True,
             bottom: bool = True) -> torch.Tensor:
    """NCHW `x` with the row above its block (the previous rank's last)
    on top and the row below (the next rank's first) at the bottom; zero
    rows at the image's edges. One exchange for both, and one in the
    backward (rule 1)."""
    return _PadRows.apply(x, sg, top, bottom)


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
