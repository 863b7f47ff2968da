"""The benchmark's side of the program under test: its modules filled with
weights drawn from the seed, and the device helpers of a run.

The program is `asyrp_official_torch`. A module is built on the meta
device, its state dict's names and shapes (the released checkpoints'
layout) are read off it, and the weights drawn for those names are
assigned to it, as the runner assigns a loaded checkpoint.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from portbench import weights

__all__ = ["seeded_module", "sync", "peak_bytes"]


def seeded_module(factory: Callable[[], torch.nn.Module], seed: int, purpose: str,
                  device) -> Tuple[torch.nn.Module, List[Tuple[str, Tuple[int, ...]]]]:
    """`factory()` with weights drawn from (seed, purpose) on `device`, and
    the (name, shape) list they were drawn for."""
    with torch.device("meta"):
        module = factory()
    shapes = [(k, tuple(v.shape)) for k, v in module.state_dict().items()]
    module.load_state_dict(weights.draw_state(shapes, seed, purpose, device), assign=True)
    return module, shapes


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
