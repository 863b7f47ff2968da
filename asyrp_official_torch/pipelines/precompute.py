"""Latent precompute — the port of the JAX `pipelines/precompute.py`
`precompute_pairs`: invert the first `n_img` dataset images and reconstruct
them, in batches, with the same cache naming
(`{category}_{mode}_t{t0}_nim{N}_ninv{ninv}_pairs.npz`, the category
`{category}_{class_name}` for one ImageNet class), `.npz` payload
({"x0", "x_rec", "x_lat"}, NHWC float32) and partial resume as the JAX
package, so the two packages read each other's caches;
`precompute_with_h`, one image's inversion with its h trajectory (DiffStyle),
cached as the JAX package caches it; and `random_noise_pairs`, the Gaussian
latents of `--load_random_noise`.

On a mesh (`mesh`, `parallel/mesh.py`) every rank holds the same host
batch, runs its block of it (padded to the data axis, and its rows of each
image under spatial sharding inside the caller's `spatial.sharded` block),
and fetches the whole batch back; only the writer rank writes the cache and
the images."""
from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np
import torch

from asyrp_official_torch.models.registry import ModelSpec
from asyrp_official_torch.parallel.mesh import Mesh
from asyrp_official_torch.pipelines import engine
from asyrp_official_torch.core.schedule import Schedule, uniform_seq

__all__ = ["pairs_cache_path", "load_pairs_cache", "precompute_pairs", "precompute_with_h",
           "random_noise_pairs"]


def pairs_cache_path(cache_dir: str, category: str, mode: str, t_0: int, nim: int,
                     n_inv: int, *, random_noise: bool = False,
                     class_name: Optional[str] = None) -> str:
    cat = f"{category}_{class_name}" if class_name else category
    mid = "random_noise_" if random_noise else f"t{t_0}_"
    return os.path.join(cache_dir, f"{cat}_{mode}_{mid}nim{nim}_ninv{n_inv}_pairs")


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
    class_name: Optional[str] = None,
    save_imgs_dir: Optional[str] = None,
    shuffle_seed: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Returns {"x0", "x_rec", "x_lat"}, each [n_img, H, W, C] numpy."""
    place = mesh if mesh is not None else Mesh(device=device)
    n_img = min(n_img, len(dataset))
    base = pairs_cache_path(cache_dir, category, mode, t_0, n_img, n_inv_step,
                            class_name=class_name)
    done: Optional[Dict[str, np.ndarray]] = None
    if not re_precompute:
        cached = load_pairs_cache(base)
        if cached is not None and cached["x0"].shape[0] >= n_img:
            return {k: v[:n_img] for k, v in cached.items()}
        for nim in reversed(range(1, n_img)):  # partial resume: largest smaller cache
            done = load_pairs_cache(pairs_cache_path(cache_dir, category, mode, t_0, nim,
                                                     n_inv_step, class_name=class_name))
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
        x0, n_real = place.put_padded(chunk, device)
        x_lat, _ = invert(model, x0)
        x_rec, _ = generate(model, x_lat)
        out["x0"].append(chunk)
        out["x_rec"].append(place.fetch(x_rec)[:n_real])
        out["x_lat"].append(place.fetch(x_lat)[:n_real])

    pairs = {k: np.concatenate(v)[:n_img] if v else np.zeros((0,)) for k, v in out.items()}
    if not place.is_writer:
        return pairs
    _atomic_savez(base + ".npz", **pairs)
    if save_imgs_dir:
        from asyrp_official_torch.data.imageio import save_image

        for i in range(pairs["x0"].shape[0]):
            for tag, key in (("0_orig", "x0"), (f"1_lat_ninv{n_inv_step}", "x_lat"),
                             (f"1_rec_ninv{n_inv_step}", "x_rec")):
                save_image(pairs[key][i], os.path.join(save_imgs_dir, f"{mode}_{i}_{tag}.png"),
                           pm1=True)
    return pairs


def precompute_with_h(
    spec: ModelSpec,
    model,
    schedule: Schedule,
    x0: np.ndarray,
    *,
    n_inv_step: int,
    device: torch.device,
    t_0: int = 999,
    cache_key: Optional[str] = None,
    category: str = "CUSTOM",
    cache_dir: str = "precomputed",
    compute_dtype=torch.float32,
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Invert `x0` ([B, H, W, C] numpy) recording the bottleneck h of every
    step, keyed by the step's source t. Returns {"x0", "x_lat", "h_traj"
    [S-1, B, h, w, C] (NHWC, as the JAX package writes it), "h_times"};
    with `cache_key`, cached as `{category}_inv{n}_{key}.npz`. On a `mesh`
    each rank inverts its block (its rows under spatial sharding, inside the
    caller's `spatial.sharded` block) and the latents and the h trajectory
    are gathered whole before the cache is written: either package reads
    it."""
    base = None
    if cache_key is not None:
        base = os.path.join(cache_dir, f"{category}_inv{n_inv_step}_{cache_key}")
        if os.path.exists(base + ".npz"):
            with np.load(base + ".npz") as d:
                return {k: d[k] for k in d.files}
    place = mesh if mesh is not None else Mesh(device=device)
    seq = uniform_seq(n_inv_step, t_0)
    run = engine.make_invert_with_h(spec, schedule, seq, compute_dtype=compute_dtype)
    x_dev, n_real = place.put_padded(np.asarray(x0, np.float32), device)
    x_lat, h_traj = run(model, x_dev)
    out = {
        "x0": np.asarray(x0),
        "x_lat": place.fetch(x_lat)[:n_real],
        # [S-1, B, C, h, w]: the batch on axis 1, the rows on axis 3
        "h_traj": place.fetch(h_traj, batch_dim=1, height_dim=3)[:, :n_real]
        .transpose(0, 1, 3, 4, 2),
        "h_times": np.asarray(seq[:-1], np.int32),
    }
    if base is not None and place.is_writer:
        _atomic_savez(base + ".npz", **out)
    return out


def random_noise_pairs(
    spec: ModelSpec,
    model,
    schedule: Schedule,
    *,
    n_img: int,
    n_inv_step: int,
    device: torch.device,
    image_size: int = 256,
    channels: int = 3,
    mode: str = "train",
    category: str = "CUSTOM",
    cache_dir: str = "precomputed",
    saved_noise: bool = False,
    batch_size: int = 8,
    seed: int = 0,
    compute_dtype=torch.float32,
    t_0: int = 999,
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """`--load_random_noise`: x_lat ~ N(0, I) from
    `np.random.RandomState(seed + (0 if train else 1))`, x0 and x_rec zero;
    with `saved_noise`, x0 = x_rec = the plain generation from x_lat (eta 0,
    `n_inv_step` steps), cached under the `random_noise_` name."""
    rng = np.random.RandomState(seed + (0 if mode == "train" else 1))
    x_lat = rng.randn(n_img, image_size, image_size, channels).astype(np.float32)
    if not saved_noise:
        zeros = np.zeros_like(x_lat)
        return {"x0": zeros, "x_rec": zeros, "x_lat": x_lat}
    base = pairs_cache_path(cache_dir, category, mode, t_0, n_img, n_inv_step, random_noise=True)
    cached = load_pairs_cache(base)
    if cached is not None and cached["x_lat"].shape[0] >= n_img:
        return {k: v[:n_img] for k, v in cached.items()}
    generate = engine.make_generate(spec, schedule, uniform_seq(n_inv_step, t_0),
                                    compute_dtype=compute_dtype)
    place = mesh if mesh is not None else Mesh(device=device)
    recs = []
    for ofs in range(0, n_img, batch_size):
        x_dev, n_real = place.put_padded(x_lat[ofs:ofs + batch_size], device)
        x, _ = generate(model, x_dev)
        recs.append(place.fetch(x)[:n_real])
    x_rec = np.concatenate(recs)
    pairs = {"x0": x_rec, "x_rec": x_rec, "x_lat": x_lat}
    if place.is_writer:
        _atomic_savez(base + ".npz", **pairs)
    return pairs
