"""Trajectory engines: inversion, generation, asymmetric editing — the port
of the JAX `pipelines/engine.py`.

Each maker returns a plain callable that runs under `torch.no_grad()`. The
UNet runs in `compute_dtype` (float32 or bfloat16) while the step update and
the carry stay float32, as in the JAX package. Every chain splits a
`learn_sigma` model's output channels (`spec.learn_sigma`); generation takes
`sample_type` "ddim" or "ddpm", inversion is always DDIM.

Calling conventions (the model takes the place of the JAX params):
  make_invert(...)        -> fn(model, x0)                       -> (x_lat, ys)
  make_generate(...)      -> fn(model, x_lat, generator=None, noise_fn=None) -> (x, ys)
  make_edit_generate(...) -> fn(model, edit, x_lat, generator=None, noise_fn=None) -> (x, ys)
  make_invert_edit(...)   -> fn(model, edit, x0, generator=None, noise_fn=None) -> x_edit
  make_invert_with_h(...) -> fn(model, x0)                       -> (x_lat, h_traj)
  make_image_noise_generate(...) -> fn(model, noise_param, x_lat, generator=None,
                                       noise_fn=None)            -> (x, ys)

`h_traj` is the bottleneck h of every inversion step, [S-1, B, C, h, w] f32
(NCHW, the layout `EditState.delta_rows` takes; the JAX package's is NHWC).
`make_image_noise_generate` is the one maker not under `no_grad`: the
gradient reaches `noise_param` ([H, W, C]) through the whole chain.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from asyrp_official_torch.core.sampler import sample_chain
from asyrp_official_torch.models.delta import EditState
from asyrp_official_torch.models.registry import ModelSpec
from asyrp_official_torch.core.schedule import Schedule
from asyrp_official_torch.core.steptable import StepTable, generation_table, inversion_table
from asyrp_official_torch.utils import profiling as prof

__all__ = ["make_invert", "make_generate", "make_edit_generate", "make_invert_edit",
           "make_invert_with_h", "make_image_noise_generate"]


def _plain_eps(spec: ModelSpec, model, compute_dtype, want_h: bool = False):
    """The plain decode; with `want_h` also the step's bottleneck h as the
    extra "h" ([B, C, h, w] f32)."""

    def eps_fn(x, t, aux):
        with prof.span(prof.EVAL, edited=False):
            eps, _, _, h = spec.apply(model, x.to(compute_dtype), t)
            if not want_h:
                return eps.float(), None
            return eps.float(), None, {"h": h.permute(0, 3, 1, 2).float()}

    return eps_fn


def _gated_eps(spec: ModelSpec, model, edit: EditState, compute_dtype, want_delta: bool):
    """Per step, on the host: the dual decode (eps from h, eps_mod from the
    edited h2) where the step's gate is on, the plain decode where it is off
    (the gated-off edit would give eps_mod == eps there). With `want_delta`
    also the step's Δh as the extra "delta_h" ([B, h, w, C] f32), zero on a
    gated-off step."""

    def eps_fn(x, t, aux):
        edited = aux["use_delta"] > 0
        with prof.span(prof.EVAL, edited=edited):
            if edited:
                eps, eps_mod, delta_h, _ = spec.apply(model, x.to(compute_dtype), t,
                                                      edit=edit.at_step(aux))
                eps_mod = eps_mod.float()
            else:
                eps, _, _, h = spec.apply(model, x.to(compute_dtype), t)
                eps_mod, delta_h = None, torch.zeros_like(h) if want_delta else None
            if not want_delta:
                return eps.float(), eps_mod
            return eps.float(), eps_mod, {"delta_h": delta_h.float()}

    return eps_fn


def _edited_chain(spec: ModelSpec, schedule: Schedule, table: StepTable, *, compute_dtype,
                  sample_type: str = "ddim", dt_lambda: float = 1.0, dt_end: int = 999,
                  collect: Tuple[str, ...] = ()):
    """The edited generation over `table`: one chain that picks the decode
    per step (`_gated_eps`), so a gate with holes (sparse `delta_times`) and
    a "delta_h" harvest (an entry for every step) run as the prefix gate does.

    Returns fn(model, edit, x, generator, noise_fn) -> (x, ys)."""
    want_delta = "delta_h" in collect

    def run(model, edit, x, generator=None, noise_fn=None):
        return sample_chain(_gated_eps(spec, model, edit, compute_dtype, want_delta), schedule,
                            table, x, generator, sample_type=sample_type,
                            learn_sigma=spec.learn_sigma, dt_lambda=dt_lambda, dt_end=dt_end,
                            collect=collect, noise_fn=noise_fn)

    return run


def make_invert(spec: ModelSpec, schedule: Schedule, seq, *, compute_dtype=torch.float32,
                collect: Tuple[str, ...] = ()) -> Callable:
    """DDIM inversion x0 → xT over the ascending `seq`."""
    table = inversion_table(seq)

    @torch.no_grad()
    def run(model, x0):
        return sample_chain(_plain_eps(spec, model, compute_dtype), schedule, table, x0,
                            learn_sigma=spec.learn_sigma, collect=collect)

    return run


def make_generate(spec: ModelSpec, schedule: Schedule, seq, *, t_addnoise: int = -1,
                  sample_type: str = "ddim", compute_dtype=torch.float32,
                  collect: Tuple[str, ...] = ()) -> Callable:
    """Plain (un-edited) generation xT → x0."""
    table = generation_table(seq, t_addnoise=t_addnoise)

    @torch.no_grad()
    def run(model, x_lat, generator=None, noise_fn=None):
        return sample_chain(_plain_eps(spec, model, compute_dtype), schedule, table, x_lat,
                            generator, sample_type=sample_type, learn_sigma=spec.learn_sigma,
                            collect=collect, noise_fn=noise_fn)

    return run


def make_edit_generate(spec: ModelSpec, schedule: Schedule, seq, *, t_edit: int,
                       t_addnoise: int = -1, delta_times=None, ignore_timesteps: bool = False,
                       sample_type: str = "ddim", dt_lambda: float = 1.0, dt_end: int = 999,
                       compute_dtype=torch.float32, collect: Tuple[str, ...] = ()) -> Callable:
    """Asymmetric edited generation: Δ injected for t >= t_edit (and, with
    `delta_times`, only at the timesteps that have a Δh row, which
    `delta_idx` then picks), eta=1 noise for t < t_addnoise. `collect` may
    name "delta_h": the per-step Δh, [S, B, h, w, C] f32, zero on
    gated-off steps."""
    table = generation_table(seq, t_edit=t_edit, t_addnoise=t_addnoise, delta_times=delta_times,
                             ignore_timesteps=ignore_timesteps)
    chain = _edited_chain(spec, schedule, table, compute_dtype=compute_dtype,
                          sample_type=sample_type, dt_lambda=dt_lambda, dt_end=dt_end,
                          collect=collect)
    return torch.no_grad()(chain)


def make_invert_edit(spec: ModelSpec, schedule: Schedule, seq_inv, seq_gen, *, t_edit: int,
                     t_addnoise: int = -1, compute_dtype=torch.float32) -> Callable:
    """Serving path in one call: DDIM inversion, then the edited generation."""
    inv_table = inversion_table(seq_inv)
    gen_chain = _edited_chain(spec, schedule,
                              generation_table(seq_gen, t_edit=t_edit, t_addnoise=t_addnoise),
                              compute_dtype=compute_dtype)

    @torch.no_grad()
    def run(model, edit, x0, generator=None, noise_fn=None):
        with prof.span(prof.REQUEST):
            x_lat, _ = sample_chain(_plain_eps(spec, model, compute_dtype), schedule, inv_table,
                                    x0, learn_sigma=spec.learn_sigma)
            x_edit, _ = gen_chain(model, edit, x_lat, generator, noise_fn)
        return x_edit

    return run


def make_image_noise_generate(spec: ModelSpec, schedule: Schedule, seq, *, t_edit: int,
                              t_addnoise: int = -1, coeff: float = 1.0,
                              compute_dtype=torch.float32) -> Callable:
    """Image-space noise optimization (`--image_space_noise_optim`): eps_mod =
    eps + noise_param·coeff for t >= t_edit, eps elsewhere. Runs with
    autograd on, so a `noise_param` that requires grad gets its gradient
    through every step after the first gated one (K3-bwd, and the UNet's
    backward through K1-bwd and K2-bwd)."""
    table = generation_table(seq, t_edit=t_edit, t_addnoise=t_addnoise)

    def run(model, noise_param, x_lat, generator=None, noise_fn=None):
        def eps_fn(x, t, aux):
            eps, *_ = spec.apply(model, x.to(compute_dtype), t)
            if spec.learn_sigma:
                eps = eps[..., :eps.shape[-1] // 2]
            eps = eps.float()
            if aux["use_delta"] <= 0:
                return eps, None
            return eps, eps + noise_param[None].float() * coeff

        return sample_chain(eps_fn, schedule, table, x_lat, generator, noise_fn=noise_fn)

    return run


def make_invert_with_h(spec: ModelSpec, schedule: Schedule, seq, *,
                       compute_dtype=torch.float32) -> Callable:
    """DDIM inversion over the ascending `seq` that also returns the
    bottleneck h of every step (the input of each step's eval), for
    DiffStyle: fn(model, x0) -> (x_lat, h_traj [S-1, B, C, h, w] f32)."""
    table = inversion_table(seq)

    @torch.no_grad()
    def run(model, x0):
        x_lat, ys = sample_chain(_plain_eps(spec, model, compute_dtype, want_h=True), schedule,
                                 table, x0, learn_sigma=spec.learn_sigma, collect=("h",))
        return x_lat, ys["h"]

    return run
