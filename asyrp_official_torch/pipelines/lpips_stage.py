"""The LPIPS-distance calibration stage (`--lpips`) — the port of the JAX
package's `pipelines/lpips_stage.py` (reference `compute_lpips_distance`,
diffusion_latent.py:1190-1303).

Per training image: the (typically 1000-step) DDIM inversion, recording
LPIPS(x_t, x0) and LPIPS(x0_t, x0) at every step; then the mean and the
population std per timestep, and the four tsv tables that interval
selection reads.

Each inversion step runs the frozen UNet (K1 and K2 inside), then K3 (eta
0, eps_mod = eps; the first C channels of a `learn_sigma` output), then the
two LPIPS distances. They go into a device tensor [S, B], which the host
fetches once per batch: no host sync per step. x0's AlexNet taps are
computed once per batch. On a row block (`parallel.spatial.sharded`) the
UNet and K3 run on this rank's rows and the LPIPS net on the whole images
(`spatial.gather_image` of x0, x_t and x0_t): every rank of the spatial
group computes the same distances.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from asyrp_official_torch.core.schedule import Schedule, uniform_seq
from asyrp_official_torch.core.steptable import inversion_table
from asyrp_official_torch.losses.lpips import LPIPS
from asyrp_official_torch.models.registry import ModelSpec
from asyrp_official_torch.ops import ddim_step as k3
from asyrp_official_torch.parallel import spatial
from asyrp_official_torch.parallel.mesh import Mesh
from asyrp_official_torch.utils.assets import write_lpips_tsv

log = logging.getLogger(__name__)

__all__ = ["make_lpips_chain", "compute_lpips_distance"]


def make_lpips_chain(spec: ModelSpec, schedule: Schedule, seq, lpips_net: LPIPS, *,
                     compute_dtype=torch.float32):
    """Returns fn(model, x0) -> (lpips_x [S, B], lpips_x0t [S, B]), f32
    tensors on x0's device; x0 is [B, H, W, C] in [-1, 1]."""
    table = inversion_table(seq)
    acp = np.asarray(schedule.alphas_cumprod_ext)

    @torch.no_grad()
    def run(model, x0):
        f32 = dict(dtype=torch.float32, device=x0.device)
        ts = torch.as_tensor(np.asarray(table.t, np.float32), **f32)
        at = torch.as_tensor(acp[np.asarray(table.t) + 1], **f32)
        at_next = torch.as_tensor(acp[np.asarray(table.t_next) + 1], **f32)
        bsz = x0.shape[0]
        d_x = torch.empty((table.num_steps, bsz), **f32)
        d_x0t = torch.empty((table.num_steps, bsz), **f32)
        sg = spatial.active()

        def whole(img):  # NHWC rows -> the NCHW image the LPIPS net takes
            return spatial.gather_image(img, sg).permute(0, 3, 1, 2)

        taps0 = lpips_net.taps(whole(x0))
        x = x0
        for i in range(table.num_steps):
            eps, *_ = spec.apply(model, x.to(compute_dtype), ts[i].expand(bsz))
            if spec.learn_sigma:
                eps = eps[..., : eps.shape[-1] // 2]
            x, x0_t = k3.ddim_step(x, eps, eps, at[i:i + 1], at_next[i:i + 1], 0.0)
            d_x[i] = lpips_net.distance(taps0, whole(x))
            d_x0t[i] = lpips_net.distance(taps0, whole(x0_t))
        return d_x, d_x0t

    return run


def compute_lpips_distance(
    spec: ModelSpec,
    model,
    schedule: Schedule,
    dataset,
    lpips_net: LPIPS,
    *,
    n_img: int,
    n_inv_step: int = 1000,
    t_0: int = 999,
    batch_size: int = 4,
    out_dir: Optional[str] = None,
    dataset_name: str = "custom",
    compute_dtype=torch.float32,
    mesh: Optional[Mesh] = None,
) -> Dict[str, Dict[int, float]]:
    """Returns curves {"x": {t: mean}, "x_std": ..., "x0_t": ...,
    "x0_t_std": ...}, keyed by `seq[1:]` (the reference records each step
    under its destination timestep); writes the reference-format tsvs when
    `out_dir` is given. The images go to the LPIPS net's device, where the
    model must be. The last batch may be partial. On a `mesh` each rank runs
    its rows of the batch, padded to the data axis (and its rows of each
    image under spatial sharding, inside the caller's `spatial.sharded`
    block), the distances are gathered over the data axis, and the writer
    rank writes the tsvs."""
    place = mesh if mesh is not None else Mesh()
    seq = uniform_seq(n_inv_step, t_0)
    chain = make_lpips_chain(spec, schedule, seq, lpips_net, compute_dtype=compute_dtype)
    device = next(lpips_net.parameters()).device
    n = min(n_img, len(dataset))
    all_x, all_x0t = [], []
    for ofs in range(0, n, batch_size):
        items = [dataset[i] for i in range(ofs, min(ofs + batch_size, n))]
        chunk = np.stack([it[0] if isinstance(it, tuple) else it for it in items])
        x0, n_real = place.put_padded(chunk, device)
        t0 = time.perf_counter()
        # the batch's one host fetch
        d_x, d_x0t = place.fetch(torch.stack(chain(model, x0)), batch_dim=2,
                                 height_dim=None)[:, :, :n_real]
        all_x.append(d_x)
        all_x0t.append(d_x0t)
        dt = time.perf_counter() - t0
        log.info("lpips chain batch of %d: %.0f ms (%.0f ms/image, %.2f ms/step)",
                 chunk.shape[0], dt * 1e3, dt * 1e3 / chunk.shape[0],
                 dt * 1e3 / max(1, len(seq) - 1))

    d_x = np.concatenate(all_x, axis=1)  # [S, N]
    d_x0t = np.concatenate(all_x0t, axis=1)
    ts = seq[1:]
    curves = {
        "x": {t: float(m) for t, m in zip(ts, d_x.mean(axis=1))},
        "x_std": {t: float(s) for t, s in zip(ts, d_x.std(axis=1))},
        "x0_t": {t: float(m) for t, m in zip(ts, d_x0t.mean(axis=1))},
        "x0_t_std": {t: float(s) for t, s in zip(ts, d_x0t.std(axis=1))},
    }
    if out_dir and place.is_writer:
        write_lpips_tsv(out_dir, dataset_name, curves)
    return curves
