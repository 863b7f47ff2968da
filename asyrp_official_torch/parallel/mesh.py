"""The device mesh over `torch.distributed` — the port of the JAX
`parallel/mesh.py`.

One process per GPU, launched by `torchrun` (PyTorch's idiom; the JAX
package drives all of its devices from one controller). The mesh is
`data` x `spatial`: rank r sits at (r // spatial, r % spatial), as the JAX
package reshapes its device list. Batches split over `data` (contiguous
rows per rank), image rows over `spatial` (`parallel/spatial.py`); the
frozen UNet and the Δ state are the same on every rank.

Every rank holds the same host batch (the runner's pipelines are
deterministic per seed), and `shard_batch` takes its own block of it —
the value-level contract of the JAX `_put_tree`; `fetch` gathers the
blocks back in rank order onto every rank. Per-image trajectories are
independent, so the only cross-image reductions are the Δ-gradient
all-reduce (`Mesh.sync_grads`: summed over the spatial ranks, averaged
over the data axis), the batch means of a loss (`Mesh.batch_mean`) and the
mean-of-Δh accumulation (`multislice.combine_delta_means`). Under spatial
sharding each rank's loss is its share (`loss_share`, and the L1 term's
local sum over the global count in `pipelines/train.default_loss`), and
the training step sums the shares back for its metrics.

`plan_mesh` holds the guards of the flags (the JAX runner's, with the
same error texts) as a pure function.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from asyrp_official_torch.parallel.spatial import SpatialGroup, active, all_gather_slots

__all__ = ["DATA_AXIS", "SPATIAL_AXIS", "Mesh", "plan_mesh", "make_mesh", "world_size",
           "shard_batch", "replicate", "fetch", "pad_to_multiple", "loss_share"]

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def world_size() -> int:
    """Processes in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def plan_mesh(dp: int, sp: int, tp_spatial: bool, world: int, image_size: int, bs_train: int,
              bottleneck_hw: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """(data, spatial) ways of the run's mesh, or None for a run without
    one (no --dp / --sp). `world` is the number of processes.

    --dp N: N data ways (-1: all processes); --tp_spatial with --dp N:
    the N processes split each image's rows (1 x N); --sp S: a D x S mesh,
    D = --dp or world // S. The mesh takes every process: D * S must be
    the world size (one process per GPU). Rows per spatial rank: the
    image's and the bottleneck's height must divide by S (no padding)."""
    if sp and sp < 2:
        # a silently ignored flag contradicts the loud-failure convention
        raise ValueError(f"--sp {sp}: the spatial axis needs >= 2 ways (use --dp alone for pure "
                         "data parallelism)")
    if sp and tp_spatial:
        raise ValueError("--sp and --tp_spatial are exclusive: --tp_spatial spreads the WHOLE "
                         "--dp mesh over the height axis; --sp carves a 2D data x spatial mesh")
    if sp:
        if dp in (0, -1):
            if world % sp:
                raise ValueError(f"--sp {sp} does not divide the {world} available processes; "
                                 "pass --dp D explicitly to use a subset")
            d = world // sp
        else:
            d = dp
        if d < 1:
            raise ValueError(f"--sp {sp} exceeds the {world} available processes")
        if image_size % sp:
            raise ValueError(f"--sp: image_size={image_size} must divide by --sp {sp}")
        if bs_train % d:
            raise ValueError(f"bs_train={bs_train} must divide by the data axis {d} (--dp)")
        plan = (d, sp)
    elif dp:
        n = world if dp == -1 else dp
        if tp_spatial:
            if image_size % n:
                raise ValueError(f"--tp_spatial: image_size={image_size} must divide by --dp {n}")
            plan = (1, n)
        else:
            if bs_train % n:
                # the reference asserts the same (main.py:326-327)
                raise ValueError(f"bs_train={bs_train} must divide by --dp {n}")
            plan = (n, 1)
    elif tp_spatial:
        raise ValueError("--tp_spatial requires --dp")
    else:
        return None
    ways = plan[0] * plan[1]
    if ways > world:
        raise ValueError(f"requested a {ways}-process mesh but only {world} processes are "
                         f"running: launch one per GPU with torchrun --nproc_per_node {ways}")
    if ways != world:
        raise ValueError(f"the mesh must use the whole world: --dp/--sp ask for {ways} "
                         f"processes, {world} are running (torchrun --nproc_per_node {ways})")
    if bottleneck_hw is not None and plan[1] > 1 and bottleneck_hw % plan[1]:
        raise ValueError(f"the bottleneck's {bottleneck_hw} rows do not divide over {plan[1]} "
                         "spatial ranks: use fewer spatial ways")
    return plan


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`data` x `spatial` ranks of the default process group; this
    process is `rank`. `data_group` joins the ranks of one spatial index
    (they hold different images), `spatial_group` those of one data index
    (they hold one image's rows). `device` is this rank's device, for the
    host arrays its collectives carry."""

    data: int = 1
    spatial: int = 1
    rank: int = 0
    data_group: Any = None
    spatial_group: Any = None
    device: torch.device = torch.device("cpu")

    @property
    def size(self) -> int:
        return self.data * self.spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.spatial

    @property
    def is_writer(self) -> bool:
        """The rank that writes the run's files (every rank holds the same
        fetched values)."""
        return self.rank == 0

    def spatial_info(self) -> Optional[SpatialGroup]:
        """The spatial group for `spatial.sharded`, or None."""
        if self.spatial == 1:
            return None
        return SpatialGroup(self.spatial, self.spatial_rank, self.spatial_group)

    # -- placement ----------------------------------------------------------
    def local(self, x, batch_dim: int = 0, height_dim: Optional[int] = 1):
        """This rank's block of a global array (numpy or torch): its rows
        of `batch_dim` on the data axis, of `height_dim` on the spatial
        axis."""
        if self.data > 1:
            if x.shape[batch_dim] % self.data:
                raise ValueError(f"B={x.shape[batch_dim]} not divisible by data={self.data}")
            b = x.shape[batch_dim] // self.data
            x = _narrow(x, batch_dim, self.data_rank * b, b)
        if self.spatial > 1 and height_dim is not None:
            if x.shape[height_dim] % self.spatial:
                raise ValueError(f"H={x.shape[height_dim]} not divisible by {self.spatial} "
                                 "spatial ranks")
            h = x.shape[height_dim] // self.spatial
            x = _narrow(x, height_dim, self.spatial_rank * h, h)
        return x

    def put(self, x, device=None) -> torch.Tensor:
        """The JAX runner's `_put`: this rank's block of a host [B, H, W, C]
        batch, as a float32 tensor on `device` (the mesh's by default)."""
        block = np.ascontiguousarray(self.local(np.asarray(x, np.float32)))
        return torch.from_numpy(block).to(device or self.device)

    def put_padded(self, x, device=None) -> Tuple[torch.Tensor, int]:
        """The JAX runner's `_put_padded`: the batch padded to a multiple
        of the data axis (its last image repeated), then `put`. Returns
        (block, n_real); callers slice fetched outputs back to n_real."""
        x, n = pad_to_multiple(np.asarray(x, np.float32), self.data)
        return self.put(x, device), n

    def gather(self, x: torch.Tensor, batch_dim: Optional[int] = 0,
               height_dim: Optional[int] = 1) -> torch.Tensor:
        """The global tensor from every rank's block (on every rank); a
        None axis is not gathered (`batch_dim=None`: whole images of this
        rank's rows of the batch)."""
        if self.spatial > 1 and height_dim is not None:
            slots = all_gather_slots(x, self.spatial_group, self.spatial)
            x = torch.cat(slots.unbind(0), dim=height_dim)
        if self.data > 1 and batch_dim is not None:
            slots = all_gather_slots(x, self.data_group, self.data)
            x = torch.cat(slots.unbind(0), dim=batch_dim)
        return x

    def fetch(self, x: torch.Tensor, batch_dim: Optional[int] = 0,
              height_dim: Optional[int] = 1) -> np.ndarray:
        """Host numpy of the global value of a sharded tensor."""
        return self.gather(x, batch_dim, height_dim).cpu().numpy()

    def noise_fn(self, generator: torch.Generator, shape, n_real: Optional[int] = None
                 ) -> Optional[Callable]:
        """The sampler's `noise_fn` for a batch of global `shape` whose
        first `n_real` rows are real: each step draws what the
        single-process run draws from `generator` (a standard normal of
        [n_real, ...]), pads it as the batch was padded, and takes this
        rank's block. None without a mesh (the sampler draws itself)."""
        if self.size == 1:
            return None
        shape = tuple(shape)
        n_real = shape[0] if n_real is None else n_real

        def draw(step, local_shape):
            z = torch.randn((n_real,) + shape[1:], generator=generator,
                            device=generator.device, dtype=torch.float32)
            if n_real < shape[0]:
                z = torch.cat([z, z[-1:].expand((shape[0] - n_real,) + shape[1:])])
            return self.local(z)

        return draw

    # -- reductions over the data axis ----------------------------------------
    def sync_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Each parameter's gradient summed over the spatial group (each
        rank's is the part its rows and its loss share gave), then averaged
        over the data axis: one flattened all-reduce over every rank of the
        mesh, divided by the data-axis size (rules 2 and 3 of
        `parallel/spatial.py`). The local losses must be per-image means
        over equal shards (or `batch_mean`), so that the average is the
        global batch's gradient."""
        if self.size == 1:
            return
        params = [p for p in params if p.requires_grad]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        # the whole mesh is the data group when there is no spatial axis
        dist.all_reduce(flat, group=self.data_group if self.spatial == 1 else None)
        flat /= self.data
        ofs = 0
        for p, g in zip(params, grads):
            n = g.numel()
            p.grad = flat[ofs:ofs + n].view_as(g).to(g.dtype)
            ofs += n

    def batch_mean(self, v: torch.Tensor) -> torch.Tensor:
        """The mean of a per-image vector over the global batch; its
        gradient is the local mean's, so that a loss nonlinear in a batch
        mean (the CLIP directional term) gets the global batch's gradient
        after `sync_grads` averages the ranks'. On a 2D mesh every spatial
        rank of a data index holds the same vector (computed on the gathered
        image): each data group then gives the same mean, replicated over
        the spatial ranks."""
        if self.data == 1:
            return v.mean()
        total = v.detach().sum().reshape(1).float()
        dist.all_reduce(total, group=self.data_group)
        local = v.mean()
        return local + (total[0].to(v.dtype) / (v.numel() * self.data) - local).detach()

    def mean_over_data(self, value: float) -> float:
        """A per-rank scalar averaged over the data axis (for the logs)."""
        if self.data == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64 if self.device.type == "cpu"
                         else torch.float32, device=self.device)
        dist.all_reduce(t, group=self.data_group)
        return float(t[0]) / self.data

    def replicate(self, tensors: Iterable[torch.Tensor]) -> None:
        """Broadcast every tensor from rank 0 in place (the Δ state, which
        each rank also builds from the seed: this makes the copies one)."""
        if self.size == 1:
            return
        for t in tensors:
            dist.broadcast(t.data, src=0)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def loss_share(term: torch.Tensor) -> torch.Tensor:
    """This rank's share of a loss term that every rank of the active
    spatial group computes whole (from `spatial.gather_image`): 1/S of it,
    so that the shares sum to the term (rule 2 of `parallel/spatial.py`);
    the term itself outside a sharded block."""
    sg = active()
    return term if sg is None else term / sg.size


def _narrow(x, dim: int, start: int, length: int):
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, start, length)
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(start, start + length)
    return x[tuple(idx)]


def make_mesh(data: int = 1, spatial: int = 1, device=None) -> Mesh:
    """The `data` x `spatial` mesh over the default process group (every
    rank calls this, in the same order: the sub-groups are made
    collectively). data * spatial must be the world size; 1 x 1 needs no
    process group."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    world = world_size()
    if data * spatial != world:
        raise ValueError(f"a {data} x {spatial} mesh needs {data * spatial} processes, "
                         f"{world} are running (torchrun --nproc_per_node {data * spatial})")
    if world == 1:
        return Mesh(device=device)
    rank = dist.get_rank()
    data_group = spatial_group = None
    for s in range(spatial):  # the ranks of one spatial index: a data group
        g = dist.new_group([d * spatial + s for d in range(data)])
        if rank % spatial == s:
            data_group = g
    for d in range(data):  # the ranks of one data index: a spatial group
        g = dist.new_group([d * spatial + s for s in range(spatial)])
        if rank // spatial == d:
            spatial_group = g
    return Mesh(data, spatial, rank, data_group, spatial_group, device)


def shard_batch(mesh: Mesh, x, device=None) -> torch.Tensor:
    """This rank's block of a [B, ...] batch (B must divide by the data
    axis: `pad_to_multiple` first)."""
    return mesh.put(x, device)


def replicate(mesh: Mesh, tensors) -> None:
    """The same parameters on every rank: broadcast from rank 0."""
    mesh.replicate(tensors)


def fetch(mesh: Mesh, x: torch.Tensor, batch_dim: int = 0, height_dim: Optional[int] = 1
          ) -> np.ndarray:
    """Host numpy of the global value of a sharded batch, on every rank."""
    return mesh.fetch(x, batch_dim, height_dim)


def pad_to_multiple(x: np.ndarray, m: int):
    """Pad the batch axis to a multiple of m; returns (padded, real_count)."""
    b = x.shape[0]
    rem = (-b) % m
    if rem:
        pad = np.repeat(x[-1:], rem, axis=0)
        x = np.concatenate([x, pad], axis=0)
    return x, b
