"""The train-state sidecar — the port of the JAX package's
`pipelines/checkpoint.py`: the trainable module's state dict, the
optimizer's state and the outer-iteration counter in one file, so a resumed
run continues bit for bit. Base training keeps its EMA in `extra`.

The file is `torch.save` of {"trainable", "opt_state", "meta": {"it_out"},
"extra"}, written to a temp file beside it and then moved into place
(`os.replace`), so a reader never sees half a file. The JAX package's orbax
directories are not read.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

__all__ = ["save_train_state", "load_train_state"]


def save_train_state(path: str, *, trainable: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
                     it_out: int, extra: Optional[Dict[str, Any]] = None) -> None:
    """`trainable`: a state dict; `opt_state`: `optimizer.state_dict()`;
    `extra`: anything `torch.save` takes (e.g. the EMA's state dict)."""
    path = os.path.abspath(path)
    state = {"trainable": trainable, "opt_state": opt_state, "meta": {"it_out": int(it_out)},
             "extra": extra}
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_train_state(path: str, *, like: Dict[str, Any],
                     map_location=None) -> Optional[Dict[str, Any]]:
    """The saved state, or None if `path` does not exist. `like` is a state
    of the same layout (e.g. the fresh run's): the saved `trainable` must
    have its keys and shapes, or this raises."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location=map_location, weights_only=True)
    if "trainable" in like:
        want = {k: tuple(v.shape) for k, v in like["trainable"].items()}
        got = {k: tuple(v.shape) for k, v in state["trainable"].items()}
        if want != got:
            missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
            raise ValueError(f"train state {path} does not match the restore layout: missing "
                             f"{missing[:5]}, unexpected {extra[:5]}, shapes differ at "
                             f"{[k for k in want if k in got and want[k] != got[k]][:5]}")
    return state
