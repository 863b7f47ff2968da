"""Latent precompute — the port of the JAX `pipelines/precompute.py`
`precompute_pairs`: invert the first `n_img` dataset images and reconstruct
them, in batches, with the same cache naming
(`{category}_{mode}_t{t0}_nim{N}_ninv{ninv}_pairs.npz`), `.npz` payload
({"x0", "x_rec", "x_lat"}, NHWC float32) and partial resume as the JAX
package, so the two packages read each other's caches."""
from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np
import torch

from asyrp_official_torch.models.registry import ModelSpec
from asyrp_official_torch.pipelines import engine
from asyrp_official_tpu.core.schedule import Schedule, uniform_seq

__all__ = ["pairs_cache_path", "load_pairs_cache", "precompute_pairs"]


def pairs_cache_path(cache_dir: str, category: str, mode: str, t_0: int, nim: int,
                     n_inv: int) -> str:
    return os.path.join(cache_dir, f"{category}_{mode}_t{t_0}_nim{nim}_ninv{n_inv}_pairs")


def load_pairs_cache(base_path: str) -> Optional[Dict[str, np.ndarray]]:
    if not os.path.exists(base_path + ".npz"):
        return None
    with np.load(base_path + ".npz") as d:
        return {k: d[k] for k in ("x0", "x_rec", "x_lat")}


def _atomic_savez(path: str, **arrays) -> None:
    """Write to a temporary name, then rename: a crash mid-write leaves no
    truncated cache behind. The temporary name keeps the .npz suffix, or
    np.savez would append one."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def precompute_pairs(
    spec: ModelSpec,
    model,
    schedule: Schedule,
    dataset,
    *,
    n_img: int,
    n_inv_step: int,
    device: torch.device,
    t_0: int = 999,
    mode: str = "train",
    category: str = "CUSTOM",
    cache_dir: str = "precomputed",
    batch_size: int = 8,
    re_precompute: bool = False,
    compute_dtype=torch.float32,
    save_imgs_dir: Optional[str] = None,
    shuffle_seed: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Returns {"x0", "x_rec", "x_lat"}, each [n_img, H, W, C] numpy."""
    n_img = min(n_img, len(dataset))
    base = pairs_cache_path(cache_dir, category, mode, t_0, n_img, n_inv_step)
    done: Optional[Dict[str, np.ndarray]] = None
    if not re_precompute:
        cached = load_pairs_cache(base)
        if cached is not None and cached["x0"].shape[0] >= n_img:
            return {k: v[:n_img] for k, v in cached.items()}
        for nim in reversed(range(1, n_img)):  # partial resume: largest smaller cache
            done = load_pairs_cache(pairs_cache_path(cache_dir, category, mode, t_0, nim,
                                                     n_inv_step))
            if done is not None:
                break

    seq = uniform_seq(n_inv_step, t_0)
    invert = engine.make_invert(spec, schedule, seq, compute_dtype=compute_dtype)
    generate = engine.make_generate(spec, schedule, seq, compute_dtype=compute_dtype)

    order = list(range(len(dataset)))
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(order)
    start = 0 if done is None else done["x0"].shape[0]
    xs: List[np.ndarray] = []
    for i in order[start:n_img]:
        item = dataset[i]
        xs.append(item[0] if isinstance(item, tuple) else item)
    out = {k: [done[k]] if done is not None else [] for k in ("x0", "x_rec", "x_lat")}
    for ofs in range(0, len(xs), batch_size):
        chunk = np.stack(xs[ofs:ofs + batch_size]).astype(np.float32)
        x0 = torch.from_numpy(chunk).to(device)
        x_lat, _ = invert(model, x0)
        x_rec, _ = generate(model, x_lat)
        out["x0"].append(chunk)
        out["x_rec"].append(x_rec.cpu().numpy())
        out["x_lat"].append(x_lat.cpu().numpy())

    pairs = {k: np.concatenate(v)[:n_img] if v else np.zeros((0,)) for k, v in out.items()}
    _atomic_savez(base + ".npz", **pairs)
    if save_imgs_dir:
        from asyrp_official_tpu.data.imageio import save_image

        for i in range(pairs["x0"].shape[0]):
            for tag, key in (("0_orig", "x0"), (f"1_lat_ninv{n_inv_step}", "x_lat"),
                             (f"1_rec_ninv{n_inv_step}", "x_rec")):
                save_image(pairs[key][i], os.path.join(save_imgs_dir, f"{mode}_{i}_{tag}.png"),
                           pm1=True)
    return pairs
