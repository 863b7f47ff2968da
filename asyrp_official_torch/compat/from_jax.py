"""JAX-layout param trees (numpy) → the port's state dicts.

The exact inverse of `asyrp_official_tpu/compat/torch_convert.py`'s
`_conv` / `_mat` / `_mat1d` / `_lin` / `_norm`:
  conv kxk: HWIO → OIHW;  1x1 channel matrix [I, O] → [O, I, 1, 1] (a 1-D
  conv's [O, I, 1] for the OpenAI attention);  linear: [I, O] → [O, I];
  GroupNorm: scale/bias → weight/bias.

The same bridge loads Δ checkpoints, since
`compat/delta_ckpt.load_delta_checkpoint` returns JAX-layout blocks, and it
turns the JAX-layout random init into the port's weights (the UNets, and
the ADM classifier `EncoderUNet`). The two loss networks cross it too:
LPIPS-Alex (the `--lpips_ckpt` npz tree) and IR-SE50 (BatchNorm
mean/var/scale/bias → running_mean/running_var/weight/bias, PReLU `a` →
weight).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from asyrp_official_torch.compat.delta_ckpt import blocks_to_torch_sd
from asyrp_official_torch.losses.id_loss import IRSE50_BLOCKS

__all__ = ["ddpmpp_state_dict_from_jax", "openai_unet_state_dict_from_jax",
           "encoder_state_dict_from_jax", "delta_block_state_dict_from_jax",
           "delta_block_global_state_dict_from_jax", "lpips_state_dict_from_jax",
           "irse50_state_dict_from_jax"]


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
    if "label_emb" in params:  # absent from an unconditional checkpoint's tree
        out["label_emb.weight"] = np.asarray(params["label_emb"]["w"], np.float32)
    _openai_stems(params, plan, out)
    _norm(params["out_norm"], "out.0", out)
    _conv(params["out_conv"], "out.2", out)
    return _tensors(out)


def _openai_stems(params, plan, out, stems=("input", "output")):
    """The OpenAI UNet's input / output blocks and middle block, walked by
    the plan."""
    for stem in stems:
        blocks = params[f"{stem}_blocks"]
        if len(blocks) != len(plan[stem]):
            raise ValueError(f"{stem}: the plan has {len(plan[stem])} blocks, the params "
                             f"{len(blocks)}")
        for bi, (specs, ps) in enumerate(zip(plan[stem], blocks)):
            for li, (spec, p) in enumerate(zip(specs, ps)):
                _openai_layer(spec["kind"], p, f"{stem}_blocks.{bi}.{li}", out)
    for li, (spec, p) in enumerate(zip(plan["middle"], params["middle_block"])):
        _openai_layer(spec["kind"], p, f"middle_block.{li}", out)


def encoder_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The JAX `encoder_unet` params → `EncoderUNet` state dict under the
    reference's keys (the inverse of the JAX `encoder_params_from_torch`):
    the attention pool's positional embedding [T+1, C] → [C, T+1]."""
    from asyrp_official_torch.models.encoder_unet import encoder_plan

    out: Dict[str, np.ndarray] = {}
    _lin(params["time_embed"]["dense0"], "time_embed.0", out)
    _lin(params["time_embed"]["dense1"], "time_embed.2", out)
    _openai_stems(params, encoder_plan(cfg), out, stems=("input",))
    head = params["out"]
    if cfg.pool == "adaptive":
        _norm(head["norm"], "out.0", out)
        _mat(head["conv"], "out.3", out)
    elif cfg.pool == "attention":
        _norm(head["norm"], "out.0", out)
        pool = head["pool"]
        out["out.2.positional_embedding"] = np.asarray(pool["positional_embedding"], np.float32).T
        _mat1d(pool["qkv"], "out.2.qkv_proj", out)
        _mat1d(pool["c_proj"], "out.2.c_proj", out)
    elif cfg.pool in ("spatial", "spatial_v2"):
        _lin(head["lin1"], "out.0", out)
        if cfg.pool == "spatial_v2":
            _norm(head["norm"], "out.1", out)
        _lin(head["lin2"], "out.3" if cfg.pool == "spatial_v2" else "out.2", out)
    else:
        raise ValueError(cfg.pool)
    return _tensors(out)


def delta_block_state_dict_from_jax(block: Dict[str, Any], flavor: str = "ddpm"
                                    ) -> Dict[str, torch.Tensor]:
    """A DeltaBlock tree (JAX layout) → the flavor's DeltaBlock state dict."""
    return _tensors({k: np.asarray(v, np.float32)
                     for k, v in blocks_to_torch_sd(block, flavor).items()})


def delta_block_global_state_dict_from_jax(block: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A `delta_block_global_init` tree (JAX layout) → `DeltaBlockGlobal`
    state dict, under the reference DeltaBlock_global's names."""
    out: Dict[str, np.ndarray] = {}
    _conv(block["conv1"], "conv1", out)
    for name in ("temb_proj", "clip_proj", "clip_proj_2"):
        _lin(block[name], name, out)
    for i in (2, 3, 4):
        _norm(block[f"norm{i}"], f"norm{i}", out)
        _mat(block[f"conv{i}"], f"conv{i}", out)
    return _tensors(out)


def lpips_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX LPIPS tree ({"convs": [{"w" HWIO, "b"}], "lins": [{"w" [C]}]})
    → `losses.lpips.LPIPS` state dict."""
    out: Dict[str, np.ndarray] = {}
    for i, p in enumerate(params["convs"]):
        _conv(p, f"convs.{i}", out)
    for i, p in enumerate(params["lins"]):
        out[f"lins.{i}"] = np.asarray(p["w"], np.float32)
    return _tensors(out)


def irse50_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX IR-SE50 tree → `losses.id_loss.IRSE50` state dict, under the
    reference Backbone's key names (the inverse of the JAX
    `id_loss.params_from_torch`)."""
    out: Dict[str, np.ndarray] = {}

    def conv(p, prefix):
        out[f"{prefix}.weight"] = np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))

    def bn(p, prefix):
        out[f"{prefix}.running_mean"] = np.asarray(p["mean"], np.float32)
        out[f"{prefix}.running_var"] = np.asarray(p["var"], np.float32)
        out[f"{prefix}.weight"] = np.asarray(p["scale"], np.float32)
        out[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)

    conv(params["input_conv"], "input_layer.0")
    bn(params["input_bn"], "input_layer.1")
    out["input_layer.2.weight"] = np.asarray(params["input_prelu"]["a"], np.float32)
    for i, (p, (cin, depth, _)) in enumerate(zip(params["body"], IRSE50_BLOCKS)):
        base = f"body.{i}"
        bn(p["bn1"], f"{base}.res_layer.0")
        conv(p["conv1"], f"{base}.res_layer.1")
        out[f"{base}.res_layer.2.weight"] = np.asarray(p["prelu"]["a"], np.float32)
        conv(p["conv2"], f"{base}.res_layer.3")
        bn(p["bn2"], f"{base}.res_layer.4")
        conv(p["se"]["fc1"], f"{base}.res_layer.5.fc1")
        conv(p["se"]["fc2"], f"{base}.res_layer.5.fc2")
        if cin != depth:
            conv(p["short_conv"], f"{base}.shortcut_layer.0")
            bn(p["short_bn"], f"{base}.shortcut_layer.1")
    bn(params["out_bn2d"], "output_layer.0")
    _lin(params["out_linear"], "output_layer.3", out)
    bn(params["out_bn1d"], "output_layer.4")
    sd = _tensors(out)
    # the BatchNorms' counters, which a strict load expects and eval ignores
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return sd
