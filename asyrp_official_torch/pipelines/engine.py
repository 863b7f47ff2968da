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
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from asyrp_official_torch.core.sampler import sample_chain
from asyrp_official_torch.models.delta import EditState
from asyrp_official_torch.models.registry import ModelSpec
from asyrp_official_torch.core.schedule import Schedule
from asyrp_official_torch.core.steptable import StepTable, generation_table, inversion_table

__all__ = ["make_invert", "make_generate", "make_edit_generate", "make_invert_edit"]


def _plain_eps(spec: ModelSpec, model, compute_dtype):
    def eps_fn(x, t, aux):
        eps, *_ = spec.apply(model, x.to(compute_dtype), t)
        return eps.float(), None

    return eps_fn


def _edited_eps(spec: ModelSpec, model, edit: EditState, compute_dtype):
    """The dual decode: eps from h, eps_mod from the edited h2."""

    def eps_fn(x, t, aux):
        eps, eps_mod, _, _ = spec.apply(model, x.to(compute_dtype), t, edit=edit.at_step(aux))
        return eps.float(), eps_mod.float()

    return eps_fn


def _edited_chain(spec: ModelSpec, schedule: Schedule, table: StepTable, *, compute_dtype,
                  sample_type: str = "ddim", dt_lambda: float = 1.0, dt_end: int = 999,
                  collect: Tuple[str, ...] = ()):
    """The edited generation over `table` as two segments: the steps with
    t >= t_edit (a prefix of the descending table) run the dual decode, the
    rest the single plain decode — the gated-off edit would give eps_mod ==
    eps there. The second segment's step indices are offset, so its noise
    follows the first's as in one whole run.

    Returns fn(model, edit, x, generator, noise_fn) -> (x, ys)."""
    k = table.edit_prefix_len()
    if k is None:
        raise ValueError("the t_edit gate of a generation table must be a prefix of its steps")
    n = table.num_steps
    common = dict(sample_type=sample_type, learn_sigma=spec.learn_sigma, dt_lambda=dt_lambda,
                  dt_end=dt_end, collect=collect)

    def run(model, edit, x, generator=None, noise_fn=None):
        parts = []
        if k:
            x, ys = sample_chain(_edited_eps(spec, model, edit, compute_dtype), schedule,
                                 table.slice(0, k), x, generator, noise_fn=noise_fn, **common)
            parts.append(ys)
        if k < n:
            x, ys = sample_chain(_plain_eps(spec, model, compute_dtype), schedule,
                                 table.slice(k, n), x, generator, step_offset=k,
                                 noise_fn=noise_fn, **common)
            parts.append(ys)
        return x, {key: torch.cat([p[key] for p in parts]) for key in parts[0]}

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
                       t_addnoise: int = -1, sample_type: str = "ddim", dt_lambda: float = 1.0,
                       dt_end: int = 999, compute_dtype=torch.float32,
                       collect: Tuple[str, ...] = ()) -> Callable:
    """Asymmetric edited generation: Δ injected for t >= t_edit, eta=1
    noise for t < t_addnoise."""
    table = generation_table(seq, t_edit=t_edit, t_addnoise=t_addnoise)
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
        x_lat, _ = sample_chain(_plain_eps(spec, model, compute_dtype), schedule, inv_table, x0,
                                learn_sigma=spec.learn_sigma)
        x_edit, _ = gen_chain(model, edit, x_lat, generator, noise_fn)
        return x_edit

    return run
