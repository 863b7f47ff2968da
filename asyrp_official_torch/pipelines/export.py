"""Ahead-of-time export of the serving engine (`engine.make_invert_edit`) —
the port of the JAX package's `pipelines/export.py`, with `torch.export`.

Design: three per-step programs, not the whole unroll (a 40 + 40-step
trace of a full-width UNet is tens of thousands of nodes): the inversion
step, the edited (dual-decode) generation step and the plain generation
step, each one UNet eval and one K3 DDIM update. `load_serving` walks the
step tables on the host, as `engine._edited_chain` does, with the same
signature as the JAX package's loaded program: `fn(state, edit, x0, key)`.

The programs take the UNet's state dict and the edit's tensors as inputs
(the artifact holds no weights). While `torch.export` traces, the kernel
wrappers call their registered ops (`torch.ops.asyrp.group_norm`,
`.attention`, `.ddim_step`; see `ops/__init__.py`), so each exported graph
names the hand-written kernels, which launch on CUDA when the loaded
program runs (and take their plain versions on the CPU).

Noise: generation step i of a stochastic step table draws
`hostrng.normal(hostrng.fold_in(key, i), x.shape)`, the JAX sampler's
`jax.random.normal(jax.random.fold_in(rng, i), ...)` bit for bit; `key` is a
hostrng key (a `jax.random.PRNGKey`'s value). `engine_noise_fn(key)` gives
the live engine the same draws.

The artifact is `{path}` (a zip of the three `torch.export` programs) and
`{path}.meta.json` (the step tables, the input layout, the state's keys),
each written to a temp file and then moved into place.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from asyrp_official_torch.core.schedule import Schedule
from asyrp_official_torch.core.steptable import generation_table, inversion_table
from asyrp_official_torch.models.delta import EditState
from asyrp_official_torch.models.registry import ModelSpec
from asyrp_official_torch.ops import ddim_step as k3
from asyrp_official_torch.pipelines import engine
from asyrp_official_torch.utils import hostrng

__all__ = ["export_invert_edit", "save_serving", "load_serving", "engine_noise_fn"]

_META_SUFFIX = ".meta.json"
_PROGRAMS = ("invert", "decode", "edit")


def engine_noise_fn(key) -> Callable:
    """The per-step draw of the JAX sampler from `key`, as the port's
    `noise_fn(step, shape)`."""
    key = np.asarray(key, np.uint32)
    return lambda step, shape: hostrng.normal(hostrng.fold_in(key, step), shape)


class _Step(nn.Module):
    """One DDIM step of the UNet (and the edit's DeltaBlocks): the DDIM
    branch of `core/sampler.py`'s loop body for one table row."""

    def __init__(self, spec: ModelSpec, model: nn.Module, blocks, edit: EditState, kind: str,
                 compute_dtype):
        super().__init__()
        self.model = model
        self.blocks = nn.ModuleList(blocks)
        self.spec, self.edit, self.kind, self.compute_dtype = spec, edit, kind, compute_dtype

    def forward(self, x, t, at, at_next, eta=None, noise=None, hs_coeff=None):
        if self.kind == "edit":
            edit = EditState(blocks=tuple(self.blocks), hs_coeff=hs_coeff,
                             flavor=self.edit.flavor, ignore_timestep=self.edit.ignore_timestep)
            eps_fn = engine._gated_eps(self.spec, self.model, edit, self.compute_dtype, False)
        else:
            eps_fn = engine._plain_eps(self.spec, self.model, self.compute_dtype)
        eps, eps_mod = eps_fn(x, t, {"use_delta": float(self.kind == "edit"), "delta_idx": 0})
        if self.spec.learn_sigma:
            c = eps.shape[-1] // 2
            eps = eps[..., :c]
            eps_mod = None if eps_mod is None else eps_mod[..., :c]
        eps_mod = eps if eps_mod is None else eps_mod
        return k3.ddim_step(x, eps, eps_mod, at, at_next, 0.0 if eta is None else eta, noise)[0]


class _Program(nn.Module):
    """`step` as a function of its weights: forward(*weights, *inputs), the
    weights in `keys` order (the step module is hidden from the module
    tree, so the exported program holds no parameter of its own)."""

    def __init__(self, step: _Step, keys: List[str]):
        super().__init__()
        self._step, self.keys = [step], keys

    def forward(self, *flat):
        n = len(self.keys)
        return torch.func.functional_call(self._step[0], dict(zip(self.keys, flat[:n])),
                                          tuple(flat[n:]))


def _edit_tensors(edit: EditState) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The edit's tensors by their names in `_Step`: each DeltaBlock's
    state dict under blocks.{i}., and hs_coeff."""
    if edit.mode != "deltablock" or not edit.blocks:
        raise ValueError(f"export serves the deltablock mode with at least one block, got mode "
                         f"{edit.mode!r} with {len(edit.blocks)} blocks")
    out = {f"blocks.{i}.{k}": v for i, b in enumerate(edit.blocks)
           for k, v in b.state_dict().items()}
    hs = edit.hs_coeff if edit.hs_coeff is not None else torch.ones(len(edit.blocks) + 1)
    return out, torch.as_tensor(hs, dtype=torch.float32)


def _tables(schedule: Schedule, seq_inv, seq_gen, t_edit: int, t_addnoise: int) -> dict:
    acp = np.asarray(schedule.alphas_cumprod_ext)
    out = {}
    for name, tab in (("inversion", inversion_table(seq_inv)),
                      ("generation", generation_table(seq_gen, t_edit=t_edit,
                                                      t_addnoise=t_addnoise))):
        out[name] = {"t": tab.t.tolist(), "at": acp[tab.t + 1].tolist(),
                     "at_next": acp[tab.t_next + 1].tolist(), "eta": tab.eta.tolist(),
                     "use_delta": tab.use_delta.tolist()}
    return out


def export_invert_edit(
    spec: ModelSpec,
    schedule: Schedule,
    seq_inv,
    seq_gen,
    model: nn.Module,
    edit: EditState,
    *,
    t_edit: int,
    t_addnoise: int = -1,
    batch: int = 1,
    image_size: int = 256,
    channels: int = 3,
    compute_dtype=torch.float32,
) -> Tuple[bytes, dict]:
    """Export the serving programs of `make_invert_edit` on `model`'s device
    (example weights: `model` and `edit`, which the artifact does not keep).
    Returns (artifact_bytes, meta)."""
    dev = next(model.parameters()).device
    state_keys = list(model.state_dict())
    block_sd, hs = _edit_tensors(edit)
    f32 = dict(dtype=torch.float32, device=dev)

    def ins(n_coef: int, noise: bool):  # example inputs, no two the same tensor
        x = torch.zeros(batch, image_size, image_size, channels, **f32)
        coefs = tuple(torch.ones(1, **f32) for _ in range(n_coef))
        return (x, torch.zeros(batch, **f32)) + coefs + ((torch.zeros_like(x),) if noise else ())

    model_keys = [f"model.{k}" for k in state_keys]
    weights = list(model.state_dict().values())
    specs = {
        "invert": (model_keys, weights, ins(2, False)),
        "decode": (model_keys, weights, ins(3, True)),
        "edit": (model_keys + list(block_sd), weights + [v.to(dev) for v in block_sd.values()],
                 ins(3, True) + (hs.to(dev),)),
    }
    programs = {}
    with torch.no_grad():
        for kind, (keys, ws, ins) in specs.items():
            step = _Step(spec, model, edit.blocks if kind == "edit" else (), edit, kind,
                         compute_dtype)
            ep = torch.export.export(_Program(step, keys), tuple(ws) + ins)
            ep._example_inputs = None  # the weights: the artifact keeps none
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            programs[kind] = buf.getvalue()
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as z:
        for kind, data in programs.items():
            z.writestr(f"{kind}.pt2", data)
    meta = {
        "state_keys": state_keys,
        "edit_keys": list(block_sd),
        "n_blocks": len(edit.blocks),
        "batch": batch, "image_size": image_size, "channels": channels,
        "t_edit": int(t_edit), "t_addnoise": int(t_addnoise),
        "tables": _tables(schedule, seq_inv, seq_gen, t_edit, t_addnoise),
    }
    return out.getvalue(), meta


def save_serving(path: str, artifact: bytes, meta: dict) -> None:
    """Write `{path}` and `{path}.meta.json`, each to a temp file first and
    then moved into place (a half-written artifact must not load)."""
    for target, mode, write in ((path, "wb", lambda f: f.write(artifact)),
                                (path + _META_SUFFIX, "w", lambda f: json.dump(meta, f))):
        tmp = f"{target}.tmp.{os.getpid()}"
        try:
            with open(tmp, mode) as f:
                write(f)
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def load_serving(path: str) -> Callable:
    """Restore `fn(state, edit, x0, key) -> x_edited` from an artifact of
    `save_serving`: `state` the UNet's state dict, `edit` a deltablock
    EditState, x0 [B, H, W, C] as the engine takes it, `key` a hostrng key.
    The state dict's and the edit's key counts are checked here; shapes and
    dtypes by the loaded programs."""
    with open(path + _META_SUFFIX) as f:
        meta = json.load(f)
    with zipfile.ZipFile(path) as z:
        programs = {k: torch.export.load(io.BytesIO(z.read(f"{k}.pt2"))).module()
                    for k in _PROGRAMS}
    n_state, edit_keys = len(meta["state_keys"]), meta["edit_keys"]

    @torch.no_grad()
    def fn(state, edit: EditState, x0, key):
        block_sd, hs = _edit_tensors(edit)
        if len(state) != n_state or len(block_sd) != len(edit_keys):
            raise ValueError(f"artifact expects {n_state} state entries + {len(edit_keys)} edit "
                             f"entries, got {len(state)} + {len(block_sd)}")
        dev = x0.device
        weights = [state[k] for k in meta["state_keys"]]
        block_w, hs = [block_sd[k].to(dev) for k in edit_keys], hs.to(dev)
        noise_fn = engine_noise_fn(key)

        def col(tab, name):
            return torch.tensor(tab[name], dtype=torch.float32, device=dev).reshape(-1, 1)

        x = x0
        inv = meta["tables"]["inversion"]
        at, at_next = col(inv, "at"), col(inv, "at_next")
        for i, t_i in enumerate(inv["t"]):
            t = torch.full((x.shape[0],), float(t_i), device=dev)
            x = programs["invert"](*weights, x, t, at[i], at_next[i])
        gen = meta["tables"]["generation"]
        at, at_next, eta = col(gen, "at"), col(gen, "at_next"), col(gen, "eta")
        for i, t_i in enumerate(gen["t"]):
            t = torch.full((x.shape[0],), float(t_i), device=dev)
            noise = (torch.as_tensor(noise_fn(i, tuple(x.shape))).to(dev) if gen["eta"][i] != 0
                     else torch.zeros_like(x))
            if gen["use_delta"][i] > 0:
                x = programs["edit"](*weights, *block_w, x, t, at[i], at_next[i], eta[i], noise,
                                     hs)
            else:
                x = programs["decode"](*weights, x, t, at[i], at_next[i], eta[i], noise)
        return x

    fn.meta = meta
    fn.programs = programs
    return fn
