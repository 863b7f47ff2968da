"""Dataset → model-family routing — the port of the JAX
`models/registry.py` for the DDPM++ family. The OpenAI-family UNets
(FFHQ / AFHQ / IMAGENET / MetFACE / CelebA_HQ_P2) are not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from asyrp_official_torch.models import ddpmpp

__all__ = ["ModelSpec", "resolve", "spec_from_config"]

_OPENAI_DATASETS = ("FFHQ", "AFHQ", "IMAGENET", "MetFACE", "CelebA_HQ_P2")
_OPENAI_TODO = "the OpenAI-family UNets are not ported yet (ROADMAP.md Queue 1, M8)"


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    family: str          # 'ddpmpp'
    config: Any          # DDPMppConfig
    delta_flavor: str

    def build(self) -> ddpmpp.DDPMpp:
        return ddpmpp.DDPMpp(self.config)

    def init(self, key: np.ndarray) -> Dict[str, Any]:
        """Random params in the JAX layout, the same draws as the JAX init."""
        return ddpmpp.init_params(key, self.config)

    def apply(self, model, x, t, edit=None, **kw):
        return model.apply(x, t, edit=edit, **kw)

    @property
    def bottleneck_ch(self) -> int:
        return self.config.bottleneck_ch

    @property
    def temb_ch(self) -> int:
        return self.config.temb_ch



def resolve(dataset: str) -> ModelSpec:
    if dataset in ("CelebA_HQ", "LSUN", "CelebA_HQ_Dialog", "CUSTOM"):
        return ModelSpec("ddpmpp", ddpmpp.CELEBA_CONFIG, "ddpm")
    if dataset in _OPENAI_DATASETS:
        raise NotImplementedError(f"{dataset}: {_OPENAI_TODO}")
    raise ValueError(f"Not implemented dataset: {dataset}")


def spec_from_config(config) -> ModelSpec:
    """The JAX `runner.spec_from_config`, DDPM++ branch."""
    m, d = config["model"], config["data"]
    if d["dataset"] in _OPENAI_DATASETS and "family" not in m:
        return resolve(d["dataset"])
    if m.get("family", "ddpmpp") != "ddpmpp":
        raise NotImplementedError(_OPENAI_TODO)
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
    return ModelSpec("ddpmpp", cfg, "ddpm")
