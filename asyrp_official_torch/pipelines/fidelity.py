"""The output-fidelity gate — the port of the JAX package's
`pipelines/fidelity.py`: LPIPS between this framework's outputs and the
reference's, image by image (the acceptance metric: mean LPIPS ≤ 0.01).
The harness is weight-agnostic; the LPIPS weights are the caller's.

    net = LPIPS(); net.load_state_dict(lpips_state_dict_from_jax(tree))
    report = compare_output_dirs("runs/ours/fidelity", "ref_outputs", net)
    assert report["mean"] <= 0.01
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from asyrp_official_torch.losses.lpips import LPIPS

__all__ = ["compare_images", "compare_output_dirs"]


def _load_pm1(path: str, size: Optional[int] = None) -> np.ndarray:
    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 127.5 - 1.0


@torch.no_grad()
def compare_images(lpips_net: LPIPS, ours: Sequence[str], theirs: Sequence[str], *,
                   batch_size: int = 8, size: Optional[int] = None) -> Dict[str, float]:
    """Pairwise LPIPS over two equal-length image lists, on the net's device."""
    if len(ours) != len(theirs):
        raise ValueError(f"{len(ours)} images against {len(theirs)}")
    dev = next(lpips_net.parameters()).device
    dists = []
    for ofs in range(0, len(ours), batch_size):
        a, b = (torch.from_numpy(np.stack([_load_pm1(p, size) for p in paths[ofs:ofs + batch_size]]))
                .to(dev).permute(0, 3, 1, 2) for paths in (ours, theirs))
        dists.extend(lpips_net(a, b).cpu().numpy().tolist())
    arr = np.asarray(dists)
    return {"mean": float(arr.mean()), "max": float(arr.max()), "n": int(arr.size),
            "per_image": dists}


def compare_output_dirs(ours_dir: str, theirs_dir: str, lpips_net: LPIPS, *,
                        batch_size: int = 8, size: Optional[int] = None) -> Dict[str, float]:
    """Match images by the filename intersection of two output directories."""
    a = {f for f in os.listdir(ours_dir) if f.lower().endswith((".png", ".jpg"))}
    b = {f for f in os.listdir(theirs_dir) if f.lower().endswith((".png", ".jpg"))}
    common = sorted(a & b)
    if not common:
        raise ValueError(f"no matching filenames between {ours_dir} ({len(a)} imgs) and "
                         f"{theirs_dir} ({len(b)} imgs)")
    return compare_images(lpips_net, [os.path.join(ours_dir, f) for f in common],
                          [os.path.join(theirs_dir, f) for f in common],
                          batch_size=batch_size, size=size)
