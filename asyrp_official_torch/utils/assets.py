"""Bundled data assets — the port's copy of the readers of the JAX
package's `utils/assets.py`, over the port's own copies of the files in
`asyrp_official_torch/assets/`:

  * src_trg_prompts.json — attribute → (source texts, target texts);
  * clip_templates.json — CLIP prompt-augmentation templates;
  * calibration_tables.npz — per-timestep LPIPS curves ([N, 2] (t, value));

and the writer of the `--lpips` stage's tsv tables, which `load_lpips_tsv`
reads back.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["ASSETS_DIR", "src_trg_prompts", "clip_templates", "lpips_curve", "load_lpips_tsv",
           "write_lpips_tsv"]

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


@functools.lru_cache()
def src_trg_prompts() -> Dict[str, Tuple[List[str], List[str]]]:
    with open(os.path.join(ASSETS_DIR, "src_trg_prompts.json")) as f:
        return {k: (v[0], v[1]) for k, v in json.load(f).items()}


@functools.lru_cache()
def clip_templates() -> Dict[str, List[str]]:
    with open(os.path.join(ASSETS_DIR, "clip_templates.json")) as f:
        return json.load(f)


@functools.lru_cache()
def _calibration() -> Dict[str, np.ndarray]:
    return dict(np.load(os.path.join(ASSETS_DIR, "calibration_tables.npz")))


def lpips_curve(dataset: str, kind: str = "x0_t") -> Dict[int, float]:
    """Per-timestep LPIPS curve as {t: value}; kind: 'x0_t' | 'x' |
    'x0_t_std' | 'x_std'."""
    name = f"{dataset}_LPIPS_distance_{kind}"
    tab = _calibration().get(name)
    if tab is None:
        raise KeyError(f"no calibration table {name}; available: "
                       f"{sorted(k for k in _calibration() if 'LPIPS' in k)}")
    return {int(t): float(v) for t, v in tab}


def load_lpips_tsv(path: str) -> Dict[int, float]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                t, v = line.split("\t")
                out[int(t)] = float(v)
    return out


def write_lpips_tsv(
    out_dir: str, dataset: str, curves: Dict[str, Dict[int, float]]
) -> None:
    """Write curves in the reference's tsv format (the `--lpips` stage
    output, diffusion_latent.py:1296-1303) so both frameworks can consume
    each other's calibration runs."""
    os.makedirs(out_dir, exist_ok=True)
    for kind, curve in curves.items():
        path = os.path.join(out_dir, f"{dataset}_LPIPS_distance_{kind}.tsv")
        with open(path, "w") as f:
            for t in curve:
                f.write(f"{t}\t{curve[t]}\n")
