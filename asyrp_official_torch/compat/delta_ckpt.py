"""Δ checkpoint IO — the port's copy of the JAX package's
`compat/delta_ckpt.py` (with `load_state_dict_numpy` and the DDPM-flavor
`convert_delta_block` of its `compat/torch_convert.py`). Reads and writes
the reference `.pth` format with torch:

  * key "i" (str) → DeltaBlock state_dict, for i in range(get_h_num)
    (`--train_delta_block`), or
  * key "t" (str timestep) → Δh tensor [C, h, w] (`--train_delta_h`), and
  * optional "optimizer" / "scheduler" states.

Blocks travel in the JAX layout ({"conv1": {"w": [I, O], "b"}, ...}) as in
the JAX package, so the two packages read each other's checkpoints;
`compat/from_jax.delta_block_state_dict_from_jax` turns one into a
`DeltaBlock` state dict.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "checkpoint_name",
    "load_state_dict_numpy",
    "convert_delta_block",
    "load_delta_checkpoint",
    "save_delta_checkpoint",
    "blocks_to_torch_sd",
]

_OPENAI_TODO = "the OpenAI DeltaBlock flavor is not ported yet (ROADMAP.md Queue 1, M8)"


def checkpoint_name(
    exp: str, category: str, t_0: int, n_inv: int, n_gen: int, it: int,
    extra: Optional[int] = None,
) -> str:
    base = f"{exp}_LC_{category}_t{t_0}_ninv{n_inv}_ngen{n_gen}_{it}"
    if extra is not None:
        base += f"_{extra}"
    return base + ".pth"


def load_state_dict_numpy(path: str) -> Dict[str, np.ndarray]:
    """Read a torch checkpoint into {key: numpy}: plain pickles,
    {'state_dict': ...} wrappers, DataParallel 'module.' prefixes and
    TorchScript archives (the OpenAI CLIP release format)."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    except RuntimeError:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    if hasattr(sd, "state_dict") and not isinstance(sd, dict):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else v
    return out


def _mat(sd, prefix):
    """1x1 conv [O, I, 1, 1] → [I, O] channel matrix."""
    w = np.asarray(sd[f"{prefix}.weight"], np.float32)
    if w.shape[2:] != (1, 1):
        raise ValueError(f"{prefix}: expected a 1x1 conv, got {w.shape}")
    return {"w": w[:, :, 0, 0].T, "b": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def _lin(sd, prefix):
    w = np.asarray(sd[f"{prefix}.weight"], np.float32)
    return {"w": w.T, "b": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def _norm(sd, prefix):
    return {"scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def convert_delta_block(sd: Dict[str, np.ndarray], prefix: str = "") -> Dict[str, Any]:
    """A DDPM-flavor DeltaBlock state dict (conv1 / temb_proj / norm2 /
    conv2) → the JAX-layout block."""
    p = prefix + "." if prefix and not prefix.endswith(".") else prefix
    if f"{p}conv1.weight" in sd:
        return {
            "conv1": _mat(sd, f"{p}conv1"),
            "temb_proj": _lin(sd, f"{p}temb_proj"),
            "norm2": _norm(sd, f"{p}norm2"),
            "conv2": _mat(sd, f"{p}conv2"),
        }
    if f"{p}in_layers.0.weight" in sd:
        raise NotImplementedError(_OPENAI_TODO)
    raise KeyError(f"no DeltaBlock found at prefix {prefix!r}; keys: {sorted(sd)[:8]}...")


def load_delta_checkpoint(path: str) -> Dict[str, Any]:
    """Returns {"blocks": [JAX-layout block, ...]} (train_delta_block
    checkpoints) or {"delta_rows": {t: [h, w, C] numpy}} (train_delta_h),
    plus the raw "optimizer"/"scheduler" states when present."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    out: Dict[str, Any] = {}
    blocks: Dict[int, Any] = {}
    rows: Dict[int, np.ndarray] = {}
    for k, v in raw.items():
        if k in ("optimizer", "scheduler"):
            out[k] = v
            continue
        try:
            ki = int(k)
        except (TypeError, ValueError):
            continue
        if v is None:  # --ignore_timesteps train_delta_h holes
            continue
        if isinstance(v, dict):
            blocks[ki] = convert_delta_block({kk: vv.detach().cpu().numpy() for kk, vv in v.items()})
        else:  # Δh tensor [C, h, w] → NHWC [h, w, C]
            rows[ki] = np.transpose(v.detach().cpu().numpy().astype(np.float32), (1, 2, 0))
    if blocks:
        out["blocks"] = [blocks[i] for i in sorted(blocks)]
    if rows:
        out["delta_rows"] = rows
    return out


def blocks_to_torch_sd(block, flavor: str) -> Dict[str, np.ndarray]:
    """A JAX-layout DeltaBlock → torch state dict (numpy values) with the
    reference's key names."""
    if flavor == "openai":
        raise NotImplementedError(_OPENAI_TODO)
    if flavor != "ddpm":
        raise ValueError(f"unknown flavor {flavor}")
    groups = {
        "conv1": {"weight": np.asarray(block["conv1"]["w"]).T[:, :, None, None],
                  "bias": np.asarray(block["conv1"]["b"])},
        "temb_proj": {"weight": np.asarray(block["temb_proj"]["w"]).T,
                      "bias": np.asarray(block["temb_proj"]["b"])},
        "norm2": {"weight": np.asarray(block["norm2"]["scale"]),
                  "bias": np.asarray(block["norm2"]["bias"])},
        "conv2": {"weight": np.asarray(block["conv2"]["w"]).T[:, :, None, None],
                  "bias": np.asarray(block["conv2"]["b"])},
    }
    return {f"{g}.{k}": v for g, kv in groups.items() for k, v in kv.items()}


def save_delta_checkpoint(
    path: str,
    *,
    blocks: Optional[Sequence[Any]] = None,
    flavor: str = "ddpm",
    delta_rows: Optional[Dict[int, np.ndarray]] = None,
    optimizer: Any = None,
    scheduler: Any = None,
) -> None:
    """Write a reference-compatible `.pth`. delta_rows values are NHWC
    [h, w, C] and are stored NCHW [C, h, w]."""
    dicts: Dict[str, Any] = {}
    if blocks is not None:
        for i, b in enumerate(blocks):
            dicts[f"{i}"] = {k: torch.from_numpy(np.array(v, copy=True))
                             for k, v in blocks_to_torch_sd(b, flavor).items()}
    if delta_rows is not None:
        for t, row in delta_rows.items():
            dicts[f"{t}"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(np.asarray(row), (2, 0, 1))))
    if optimizer is not None:
        dicts["optimizer"] = optimizer
    if scheduler is not None:
        dicts["scheduler"] = scheduler
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(dicts, path)
