"""The Δ-training step — the port of the JAX package's `pipelines/train.py`
(`default_loss`, `make_optimizer`, `steplr_lr`, `make_train_step`).

The trainable is DeltaBlock 0 (`train_target="blocks"`,
`--train_delta_block`) or the stacked Δh rows (`"rows"`,
`--train_delta_h`): one [K, C, h, w] f32 leaf, `edit.delta_rows`, whose
row `delta_idx` a timestep injects, so each step's loss reaches only its
own row. Per batch, a Python loop over the generation table of
`seq_train`. At every timestep:
  * the plain DDIM reference step without grad (or the cached x0_t_origin);
  * the edited forward, whose graph starts at the DeltaBlock or the row (the UNet is
    frozen and `decode_mode="split"` runs the encoder, the middle block and
    the plain decode without grad), and the DDIM update with eta 0;
  * the loss, `backward`, and one SGD step on the trainable — the
    optimizer steps at EVERY timestep, with the lr set per call;
  * the carry is detached, so each step's gradient flows only through its
    own x0_t.

Both DDIM updates launch K3 on CUDA; the edited one goes through K3's
`autograd.Function`, whose closed-form backward (one K3-bwd launch on
CUDA) takes x0_t's gradient to eps_mod (eta 0). K3 takes the model's outputs in the model's dtype and
computes in f32. A `learn_sigma` model (the OpenAI family) outputs 2C
channels: both updates read the first C, as strided views of the output
that K3 takes without a copy; autograd scatters eps_mod's contiguous
gradient back into the 2C-channel output.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from asyrp_official_torch.core.schedule import Schedule
from asyrp_official_torch.core.steptable import generation_table
from asyrp_official_torch.models.delta import EditState
from asyrp_official_torch.models.registry import ModelSpec
from asyrp_official_torch.ops import ddim_step as k3
from asyrp_official_torch.parallel import spatial
from asyrp_official_torch.parallel.mesh import loss_share

__all__ = ["default_loss", "make_optimizer", "steplr_lr", "make_train_step"]


def default_loss(x0_t, x0_t_origin, x0, *, l1_w: float = 3.0, cosine: float = 1.0,
                 extra: Optional[Callable] = None):
    """l1_w · L1(x0_t, x0_t_origin) · cosine, plus `extra(x0, x0_t,
    x0_t_origin)` (the CLIP and ID terms, already weighted).

    On a row block (`parallel.spatial.sharded`) this is the rank's share of
    that loss (rule 2 of `parallel/spatial.py`): the L1 term's local sum over
    the whole image's count, and `extra` of the whole images
    (`spatial.gather_image`, the gradient flowing back to each rank's rows)
    weighted 1/S (`parallel.mesh.loss_share`)."""
    sg = spatial.active()
    if sg is None:
        loss = l1_w * (x0_t - x0_t_origin).abs().mean() * cosine
        if extra is not None:
            loss = loss + extra(x0, x0_t, x0_t_origin)
        return loss
    loss = l1_w * ((x0_t - x0_t_origin).abs().sum() / (x0_t.numel() * sg.size)) * cosine
    if extra is not None:
        whole = [spatial.gather_image(a, sg) for a in (x0, x0_t, x0_t_origin)]
        loss = loss + loss_share(extra(*whole))
    return loss


def make_optimizer(params, lr: float) -> torch.optim.SGD:
    """Plain SGD, weight decay 0; `make_train_step`'s step sets the lr of
    each call (the StepLR value of the outer iteration, `steplr_lr`)."""
    return torch.optim.SGD(params, lr=lr, weight_decay=0.0)


def _params(optimizer: torch.optim.Optimizer):
    return [p for group in optimizer.param_groups for p in group["params"]]


def steplr_lr(base_lr: float, it_out: int, step_size: int, gamma: float) -> float:
    return base_lr * (gamma ** (it_out // step_size))


def make_train_step(spec: ModelSpec, schedule: Schedule, seq_train, *, t_edit: int,
                    loss_fn: Callable = default_loss, compute_dtype=torch.float32,
                    ignore_timesteps: bool = False, train_target: str = "blocks",
                    cached_origin: bool = False, sync_grads: Optional[Callable] = None):
    """Returns fn(model, edit, optimizer, x_lat, x0, lr[, origins]) ->
    {"loss_per_step": [n], "loss": scalar, "x_next": the carry after the
    last step}, training `edit.blocks` or (`train_target="rows"`)
    `edit.delta_rows` in place; the optimizer holds those parameters.

    With `cached_origin=True` the fn takes the x0_t_origin stack
    ([n_steps, B, H, W, C], from `fn.compute_origins(model, x_lat)`)
    instead of running the plain reference step: it depends only on the
    frozen UNet and x_lat, so it holds for every outer iteration.

    `sync_grads(params)` runs on the optimizer's parameters between the
    backward and the optimizer step: on a mesh it sums their gradients over
    the spatial ranks and averages them over the data axis
    (`parallel.mesh.Mesh.sync_grads`). Under spatial sharding the fn runs
    inside the caller's `spatial.sharded` block, each rank on its rows with
    its share of the loss (`default_loss`); the metrics report the shares'
    sum over the spatial ranks, the loss one process computes."""
    if train_target not in ("blocks", "rows"):
        raise ValueError(f"train_target must be 'blocks' or 'rows', got {train_target!r}")
    table = generation_table(seq_train, t_edit=t_edit, ignore_timesteps=ignore_timesteps,
                             delta_times=list(seq_train) if train_target == "rows" else None)
    acp = np.asarray(schedule.alphas_cumprod_ext)
    per_step = {}  # device -> the steps' t, a and a' ([n_steps] f32), built once

    def eps_of(out):
        """The eps channels of a model output, in the model's dtype: the
        first C of a learn_sigma model's 2C, as a strided view. K3 reads
        either dtype and computes in f32."""
        return out[..., : out.shape[-1] // 2] if spec.learn_sigma else out

    def coeffs(i: int, x):
        """Step i's t ([B]), a and a' ([1]): views of tensors that went to
        x's device once, as `core/sampler.py` builds them."""
        if x.device not in per_step:
            f32 = dict(dtype=torch.float32, device=x.device)
            per_step[x.device] = (torch.as_tensor(np.asarray(table.t, np.float32), **f32),
                                  torch.as_tensor(acp[np.asarray(table.t) + 1], **f32),
                                  torch.as_tensor(acp[np.asarray(table.t_next) + 1], **f32))
        ts, at, at_next = per_step[x.device]
        return ts[i].expand(x.shape[0]), at[i:i + 1], at_next[i:i + 1]

    @torch.no_grad()
    def plain_origin_step(model, x_orig, i):
        t_b, at, at_next = coeffs(i, x_orig)
        eps = eps_of(spec.apply(model, x_orig.to(compute_dtype), t_b)[0])
        return k3.ddim_step(x_orig, eps, eps, at, at_next, 0.0)

    @torch.no_grad()
    def compute_origins(model, x_lat):
        x_orig, origins = x_lat, []
        for i in range(table.num_steps):
            x_orig, x0_t_origin = plain_origin_step(model, x_orig, i)
            origins.append(x0_t_origin)
        return torch.stack(origins)

    def train_step(model, edit: EditState, optimizer, x_lat, x0, lr: float,
                   origins: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if cached_origin and origins is None:
            raise ValueError("cached_origin=True: pass the x0_t_origin stack (fn.compute_origins)")
        for group in optimizer.param_groups:
            group["lr"] = lr
        x_edit = x_orig = x_lat
        losses = []
        for i in range(table.num_steps):
            if cached_origin:
                x0_t_origin = origins[i]
            else:
                x_orig, x0_t_origin = plain_origin_step(model, x_orig, i)
            t_b, at, at_next = coeffs(i, x_edit)
            e = edit.at_step({"use_delta": float(table.use_delta[i]),
                              "delta_idx": int(table.delta_idx[i])})
            eps, eps_mod, _, _ = spec.apply(model, x_edit.to(compute_dtype), t_b, edit=e,
                                            decode_mode="split")
            x_next, x0_t = k3.ddim_step(x_edit, eps_of(eps), eps_of(eps_mod), at, at_next, 0.0)
            loss = loss_fn(x0_t, x0_t_origin, x0)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if sync_grads is not None:
                sync_grads(_params(optimizer))
            optimizer.step()
            x_edit = x_next.detach()
            losses.append(loss.detach())
        per_step = torch.stack(losses)
        sg = spatial.active()
        if sg is not None:
            per_step = spatial.all_reduce_sum(per_step, sg)
        return {"loss_per_step": per_step, "loss": per_step.mean(), "x_next": x_edit}

    train_step.compute_origins = compute_origins
    return train_step
