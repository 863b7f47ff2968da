"""JAX-layout param trees (numpy) → the port's state dicts.

The exact inverse of `asyrp_official_tpu/compat/torch_convert.py`'s
`_conv` / `_mat` / `_lin` / `_norm`:
  conv kxk: HWIO → OIHW;  1x1 channel matrix [I, O] → [O, I, 1, 1];
  linear: [I, O] → [O, I];  GroupNorm: scale/bias → weight/bias.

The same bridge loads Δ checkpoints, since
`compat/delta_ckpt.load_delta_checkpoint` returns JAX-layout blocks, and it
turns the JAX-layout random init into the port's weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from asyrp_official_torch.compat.delta_ckpt import blocks_to_torch_sd

__all__ = ["ddpmpp_state_dict_from_jax", "delta_block_state_dict_from_jax"]


def _conv(p, prefix, out):
    out[f"{prefix}.weight"] = np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))
    out[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)


def _mat(p, prefix, out):
    out[f"{prefix}.weight"] = np.asarray(p["w"], np.float32).T[:, :, None, None]
    out[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)


def _lin(p, prefix, out):
    out[f"{prefix}.weight"] = np.asarray(p["w"], np.float32).T
    out[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)


def _norm(p, prefix, out):
    out[f"{prefix}.weight"] = np.asarray(p["scale"], np.float32)
    out[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)


def _resblock(p, prefix, out):
    _norm(p["norm1"], f"{prefix}.norm1", out)
    _conv(p["conv1"], f"{prefix}.conv1", out)
    _lin(p["temb_proj"], f"{prefix}.temb_proj", out)
    _norm(p["norm2"], f"{prefix}.norm2", out)
    _conv(p["conv2"], f"{prefix}.conv2", out)
    if "nin_shortcut" in p:
        _mat(p["nin_shortcut"], f"{prefix}.nin_shortcut", out)
    if "conv_shortcut" in p:
        _conv(p["conv_shortcut"], f"{prefix}.conv_shortcut", out)


def _attn(p, prefix, out):
    _norm(p["norm"], f"{prefix}.norm", out)
    for name in ("q", "k", "v", "proj_out"):
        _mat(p[name], f"{prefix}.{name}", out)


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.require(v, np.float32, ["C", "W"])) for k, v in sd.items()}


def ddpmpp_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, np.ndarray] = {}
    _lin(params["temb"]["dense0"], "temb.dense.0", out)
    _lin(params["temb"]["dense1"], "temb.dense.1", out)
    _conv(params["conv_in"], "conv_in", out)
    for kind, resample in (("down", "downsample"), ("up", "upsample")):
        for i, lvl in enumerate(params[kind]):
            for j, blk in enumerate(lvl["block"]):
                _resblock(blk, f"{kind}.{i}.block.{j}", out)
            for j, att in enumerate(lvl["attn"]):
                _attn(att, f"{kind}.{i}.attn.{j}", out)
            if resample in lvl:
                _conv(lvl[resample], f"{kind}.{i}.{resample}.conv", out)
    _resblock(params["mid"]["block_1"], "mid.block_1", out)
    _attn(params["mid"]["attn_1"], "mid.attn_1", out)
    _resblock(params["mid"]["block_2"], "mid.block_2", out)
    _norm(params["norm_out"], "norm_out", out)
    _conv(params["conv_out"], "conv_out", out)
    return _tensors(out)


def delta_block_state_dict_from_jax(block: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A DDPM-flavor DeltaBlock tree (JAX layout) → `DeltaBlock` state dict."""
    return _tensors({k: np.asarray(v, np.float32) for k, v in blocks_to_torch_sd(block, "ddpm").items()})
