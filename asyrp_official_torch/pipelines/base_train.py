"""Base diffusion-model training — the port of the JAX package's
`pipelines/base_train.py`: one step is q_sample → model → (hybrid) loss →
backward → optimizer → EMA, for users who train the diffusion UNet itself
(the Asyrp pipeline only freezes pretrained ones).

The UNet's GroupNorms and attentions run through their kernels' autograd
Functions (`ops/groupnorm.py`, `ops/attention.py`), so a step on the card
runs K1 / K1-bwd (with the norms' weight and bias gradients) and K2 /
K2-bwd (K2-MH / K2-bwd-MH for an OpenAI UNet). Mixed precision is
`compute_dtype`: the step casts x, the model casts its own weights at use,
and the output returns to float32 before the loss (no autocast).
Timestep importance sampling stays on the host (`core/resample.py`): the
step returns each sample's loss for the sampler's history.

Data parallelism (one process per GPU, `parallel/mesh.py`): each rank steps
on its rows of the global batch, and `sync_grads` (`Mesh.sync_grads`)
averages the gradients over the ranks before the optimizer step. The loss
is a mean of per-sample terms over equal shards, so the average is the
global batch's gradient. The caller draws the timesteps and the noise for
the global batch and hands each rank its rows, so the ranks together draw
what one process draws.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import torch

from asyrp_official_torch.core import gaussian as G
from asyrp_official_torch.core.schedule import update_ema

__all__ = ["init_train_state", "make_base_train_step", "unet_eps_fn"]


def init_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """(model, ema, optimizer): the EMA is a deep copy of the model that
    takes no gradient (a copy, not an alias, as the JAX package's)."""
    ema = copy.deepcopy(model).requires_grad_(False)
    return model, ema, optimizer


def unet_eps_fn(model, x, t):
    """The raw output of one of the port's UNets (`model.apply`, NHWC at its
    boundary) for an NCHW x, as NCHW: the `apply_fn` of a UNet."""
    return model.apply(x.permute(0, 2, 3, 1), t)[0].permute(0, 3, 1, 2)


def make_base_train_step(
    apply_fn: Callable,               # apply_fn(model, x_nchw, t) -> model output, NCHW
    tab: G.GaussianTables,
    optimizer: torch.optim.Optimizer,
    *,
    mean_type: str = "eps",
    var_type: str = "fixedsmall",
    loss_type: str = "mse",
    p2_gamma: float = 0.0,
    p2_k: float = 1.0,
    ema_rate: float = 0.9999,
    compute_dtype=torch.float32,
    sync_grads: Optional[Callable] = None,
):
    """Returns step(model, ema, x0, t, noise, loss_weights) -> metrics,
    which updates the model, the EMA and `optimizer` (built over the model's
    parameters) in place.

    `t` is an integer [B] tensor (per-sample timesteps); `loss_weights` [B]
    is the schedule sampler's 1/(N·p) reweighting. `metrics`: "loss" (the
    weighted mean), "loss_per_sample" [B] (for the sampler's history),
    "mse", and "vb" with a learned variance; tensors, detached."""

    def model_fn(model):
        return lambda x, tt: apply_fn(model, x.to(compute_dtype), tt).float()

    def step(model, ema, x0, t, noise, loss_weights) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        terms = G.training_losses(tab, model_fn(model), x0, t, noise, mean_type=mean_type,
                                  var_type=var_type, loss_type=loss_type, p2_gamma=p2_gamma,
                                  p2_k=p2_k)
        loss = (terms["loss"] * loss_weights).mean()
        loss.backward()
        if sync_grads is not None:
            sync_grads(list(model.parameters()))
        optimizer.step()
        update_ema(ema, model, rate=ema_rate)
        metrics = {"loss": loss.detach(), "loss_per_sample": terms["loss"].detach(),
                   "mse": terms.get("mse", terms["loss"]).detach().mean()}
        if "vb" in terms:
            metrics["vb"] = terms["vb"].detach().mean()
        return metrics

    return step
