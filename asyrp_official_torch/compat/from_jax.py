"""JAX-layout param trees (numpy) → the port's state dicts.

The exact inverse of `asyrp_official_tpu/compat/torch_convert.py`'s
`_conv` / `_mat` / `_mat1d` / `_lin` / `_norm`:
  conv kxk: HWIO → OIHW;  1x1 channel matrix [I, O] → [O, I, 1, 1] (a 1-D
  conv's [O, I, 1] for the OpenAI attention);  linear: [I, O] → [O, I];
  GroupNorm: scale/bias → weight/bias.

The same bridge loads Δ checkpoints, since
`compat/delta_ckpt.load_delta_checkpoint` returns JAX-layout blocks, and it
turns the JAX-layout random init into the port's weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from asyrp_official_torch.compat.delta_ckpt import blocks_to_torch_sd

__all__ = ["ddpmpp_state_dict_from_jax", "openai_unet_state_dict_from_jax",
           "delta_block_state_dict_from_jax"]


def _conv(p, prefix, out):
    out[f"{prefix}.weight"] = np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))
    out[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)


def _mat(p, prefix, out):
    out[f"{prefix}.weight"] = np.asarray(p["w"], np.float32).T[:, :, None, None]
    out[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)


def _mat1d(p, prefix, out):
    out[f"{prefix}.weight"] = np.asarray(p["w"], np.float32).T[:, :, None]
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


def _openai_layer(kind: str, p, prefix, out):
    if kind == "res":
        _norm(p["in_norm"], f"{prefix}.in_layers.0", out)
        _conv(p["in_conv"], f"{prefix}.in_layers.2", out)
        _lin(p["emb"], f"{prefix}.emb_layers.1", out)
        _norm(p["out_norm"], f"{prefix}.out_layers.0", out)
        _conv(p["out_conv"], f"{prefix}.out_layers.3", out)
        if "skip_mat" in p:
            _mat(p["skip_mat"], f"{prefix}.skip_connection", out)
    elif kind == "attn":
        _norm(p["norm"], f"{prefix}.norm", out)
        _mat1d(p["qkv"], f"{prefix}.qkv", out)
        _mat1d(p["proj_out"], f"{prefix}.proj_out", out)
    elif kind == "conv":
        _conv(p, prefix, out)
    elif kind == "downsample":
        _conv(p, f"{prefix}.op", out)
    elif kind == "upsample":
        _conv(p, f"{prefix}.conv", out)
    else:
        raise ValueError(kind)


def openai_unet_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The JAX `openai_unet` params → `OpenAIUNet` state dict, walking the
    config's plan (the inverse of `convert_openai_unet` followed by
    `openai_unet.params_from_torch`)."""
    from asyrp_official_torch.models.openai_unet import build_plan  # the model imports this module

    plan = build_plan(cfg)
    out: Dict[str, np.ndarray] = {}
    _lin(params["time_embed"]["dense0"], "time_embed.0", out)
    _lin(params["time_embed"]["dense1"], "time_embed.2", out)
    if "label_emb" in params:
        out["label_emb.weight"] = np.asarray(params["label_emb"]["w"], np.float32)
    for stem in ("input", "output"):
        blocks = params[f"{stem}_blocks"]
        if len(blocks) != len(plan[stem]):
            raise ValueError(f"{stem}: the plan has {len(plan[stem])} blocks, the params "
                             f"{len(blocks)}")
        for bi, (specs, ps) in enumerate(zip(plan[stem], blocks)):
            for li, (spec, p) in enumerate(zip(specs, ps)):
                _openai_layer(spec["kind"], p, f"{stem}_blocks.{bi}.{li}", out)
    for li, (spec, p) in enumerate(zip(plan["middle"], params["middle_block"])):
        _openai_layer(spec["kind"], p, f"middle_block.{li}", out)
    _norm(params["out_norm"], "out.0", out)
    _conv(params["out_conv"], "out.2", out)
    return _tensors(out)


def delta_block_state_dict_from_jax(block: Dict[str, Any], flavor: str = "ddpm"
                                    ) -> Dict[str, torch.Tensor]:
    """A DeltaBlock tree (JAX layout) → the flavor's DeltaBlock state dict."""
    return _tensors({k: np.asarray(v, np.float32)
                     for k, v in blocks_to_torch_sd(block, flavor).items()})
