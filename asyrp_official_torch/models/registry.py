"""Dataset → model-family routing — the port of the JAX `models/registry.py`
and of the JAX `runner.spec_from_config`. Families:
  'ddpmpp' — SDEdit/DiffusionCLIP DDPM++ (CelebA_HQ / LSUN / Dialog / CUSTOM);
  'openai' — iDDPM (FFHQ / AFHQ / IMAGENET) and ADM (MetFACE / CelebA_HQ_P2),
             one implementation for both (`models/openai_unet.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from asyrp_official_torch.compat.from_jax import (
    ddpmpp_state_dict_from_jax,
    openai_unet_state_dict_from_jax,
)
from asyrp_official_torch.models import ddpmpp, openai_unet

__all__ = ["ModelSpec", "resolve", "spec_from_config"]

_OPENAI_DATASETS = ("FFHQ", "AFHQ", "IMAGENET", "MetFACE", "CelebA_HQ_P2")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    family: str          # 'ddpmpp' | 'openai'
    config: Any          # DDPMppConfig | OpenAIUNetConfig
    learn_sigma: bool    # the model outputs 2C channels: eps and a learned log-variance
    delta_flavor: str    # DeltaBlock flavor of this family

    def build(self) -> torch.nn.Module:
        if self.family == "ddpmpp":
            return ddpmpp.DDPMpp(self.config)
        return openai_unet.OpenAIUNet(self.config)

    def init(self, key: np.ndarray) -> Dict[str, Any]:
        """Random params in the JAX layout, the same draws as the JAX init."""
        if self.family == "ddpmpp":
            return ddpmpp.init_params(key, self.config)
        return openai_unet.init_params(key, self.config)

    def state_dict_from_jax(self, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """JAX-layout params → the state dict of `build()`."""
        if self.family == "ddpmpp":
            return ddpmpp_state_dict_from_jax(params)
        return openai_unet_state_dict_from_jax(params, self.config)

    def apply(self, model, x, t, edit=None, **kw):
        return model.apply(x, t, edit=edit, **kw)

    @property
    def bottleneck_ch(self) -> int:
        return self.config.bottleneck_ch

    @property
    def temb_ch(self) -> int:
        return self.config.temb_ch

    @property
    def bottleneck_hw(self) -> int:
        """Side of the h-space map: the resolution after len(mult) - 1
        downsamples of the architecture (8 at 256² for both families)."""
        if self.family == "ddpmpp":
            return self.config.resolution // 2 ** (len(self.config.ch_mult) - 1)
        return self.config.image_size // 2 ** (len(self.config.channel_mult) - 1)


def resolve(dataset: str) -> ModelSpec:
    """Dataset names follow the reference configs."""
    if dataset in ("CelebA_HQ", "LSUN", "CelebA_HQ_Dialog", "CUSTOM"):
        return ModelSpec("ddpmpp", ddpmpp.CELEBA_CONFIG, False, "ddpm")
    if dataset in ("FFHQ", "AFHQ"):
        return ModelSpec("openai", openai_unet.AFHQ_CONFIG, True, "openai")
    if dataset == "IMAGENET":
        return ModelSpec("openai", openai_unet.IMAGENET_CONFIG, True, "openai")
    if dataset in ("MetFACE", "CelebA_HQ_P2"):
        return ModelSpec("openai", openai_unet.METFACE_CONFIG, True, "openai")
    raise ValueError(f"Not implemented dataset: {dataset}")


def spec_from_config(config) -> ModelSpec:
    """The JAX `runner.spec_from_config`: the OpenAI-family datasets build
    the registry architecture unless the yml opts into yml-driven
    construction with an explicit `family:` key."""
    m, d = config["model"], config["data"]
    if d["dataset"] in _OPENAI_DATASETS and "family" not in m:
        return resolve(d["dataset"])
    if m.get("family", "ddpmpp") == "ddpmpp":
        cfg = ddpmpp.DDPMppConfig(
            ch=m["ch"],
            out_ch=m["out_ch"],
            ch_mult=tuple(m["ch_mult"]),
            num_res_blocks=m["num_res_blocks"],
            attn_resolutions=tuple(m["attn_resolutions"]),
            dropout=m.get("dropout", 0.0),
            in_channels=m["in_channels"],
            resolution=d["image_size"],
            resamp_with_conv=m.get("resamp_with_conv", True),
        )
        return ModelSpec("ddpmpp", cfg, False, "ddpm")
    img = d["image_size"]
    cfg = openai_unet.OpenAIUNetConfig(
        image_size=img,
        in_channels=m["in_channels"],
        model_channels=m["ch"],
        out_channels=m["out_ch"],
        num_res_blocks=m["num_res_blocks"],
        # the yml stores attention RESOLUTIONS; the OpenAI models key on the rate
        attention_ds=tuple(img // r for r in m["attn_resolutions"]),
        channel_mult=tuple(m["ch_mult"]),
        num_classes=1000 if m.get("class_cond") else None,
        num_head_channels=m.get("num_head_channels", 64),
        use_scale_shift_norm=m.get("use_scale_shift_norm", True),
        resblock_updown=m.get("resblock_updown", True),
        dropout=m.get("dropout", 0.0),
    )
    return ModelSpec("openai", cfg, m.get("learn_sigma", True), "openai")
