"""Work lists over processes, and the mean of Δh across them — the port of
the JAX `parallel/multislice.py`.

Per-image trajectories are independent; the only global reductions are the
Δ-gradient average and the mean-of-Δh accumulation. So a process (or a
data-axis rank) can take a contiguous shard of the image list, and the
small Δh sums are combined with one all-reduce of the sum and one of the
count.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["process_info", "shard_work", "combine_delta_means"]


def process_info() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_work(items: Sequence, index: Optional[int] = None, count: Optional[int] = None) -> List:
    """Contiguous shard of a work list for this process. Deterministic, and
    balanced with the remainder spread over the first n % count shards — a
    ceil-division split can hand trailing processes EMPTY shards, which
    then deadlock collective combines."""
    if index is None or count is None:
        index, count = process_info()
    n = len(items)
    base, rem = divmod(n, count)
    start = index * base + min(index, rem)
    size = base + (1 if index < rem else 0)
    return list(items[start: start + size])


def combine_delta_means(local_sum: np.ndarray, local_count: int, *, group=None,
                        device=None) -> np.ndarray:
    """The global mean of per-process Δh sums: an all-reduce of the sum
    and one of the count over `group` (the default group if None; the
    data axis of a mesh, whose spatial ranks hold the same images); plain
    division without a process group. `device`: where the collective's
    tensors live (CUDA for NCCL; the CPU for gloo)."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size(group) == 1:
        return local_sum / max(local_count, 1)
    device = torch.device(device) if device is not None else torch.device("cpu")
    total = torch.from_numpy(np.ascontiguousarray(local_sum, np.float32)).to(device)
    count = torch.tensor([float(local_count)], dtype=torch.float32, device=device)
    dist.all_reduce(total, group=group)
    dist.all_reduce(count, group=group)
    return total.cpu().numpy() / max(int(round(float(count[0]))), 1)
