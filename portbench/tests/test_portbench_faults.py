"""A run with the timed path broken underneath comes out not correct. The
harness's look for a card is skipped: each test drives the rest of a run
(`harness.run_cell`: set-up, window, reference, check) at a tiny width on
the CPU, with the cell's own limits, once for each fault the cell can
have: a step that returns its state unchanged, half of a batch left out,
an answer altered where it is produced, and what the edit's schedule
decides: the alphas off by one timestep, the eta noise dropped, noise
other than the seed's, the DeltaBlock applied below t_edit. (No cell
spans chips, so no exchange can be left out.)"""
import contextlib
import dataclasses
import time
from unittest import mock

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.tiny import cells, full_cell, tiny_cell

EDIT = cells()


@contextlib.contextmanager
def step_unchanged():
    """Every fifth DDIM step of the sampler hands back its input state."""
    from asyrp_official_torch.core import sampler

    real, calls = sampler.k3.ddim_step, [0]

    def broken(x, *a, **kw):
        out = real(x, *a, **kw)
        calls[0] += 1
        return (x, out[1]) if calls[0] % 5 == 0 else out

    with mock.patch.object(sampler.k3, "ddim_step", broken):
        yield


def _wrap_serving(change):
    """The serving path of `engine.make_invert_edit` with `change(run,
    model, edit, x0, **kw)` in place of its call."""
    from asyrp_official_torch.pipelines import engine

    real = engine.make_invert_edit

    def make(*a, **kw):
        run = real(*a, **kw)
        return lambda model, edit, x0, **k: change(run, model, edit, x0, **k)

    return mock.patch.object(engine, "make_invert_edit", make)


def half_batch():
    """Only the first half of each batch is edited; its answers stand in
    for the rest."""
    def change(run, model, edit, x0, **kw):
        half = x0.shape[0] // 2
        noise_fn = kw.pop("noise_fn")
        out = run(model, edit, x0[:half], noise_fn=lambda s, sh: noise_fn(s, sh)[:half], **kw)
        return torch.cat([out, out])

    return _wrap_serving(change)


def answer_altered():
    """Each edited image's top half is shifted by 1 where it is produced."""
    def change(run, model, edit, x0, **kw):
        out = run(model, edit, x0, **kw).clone()
        out[:, : out.shape[1] // 2] += 1.0
        return out

    return _wrap_serving(change)


@contextlib.contextmanager
def schedule_shifted():
    """The program's alphas table is off by one timestep: step t reads the
    alpha of t - 1."""
    from asyrp_official_torch.core import schedule

    real = schedule.make_schedule

    def make(*a, **kw):
        s = real(*a, **kw)
        ext = s.alphas_cumprod_ext
        return dataclasses.replace(s, alphas_cumprod_ext=np.concatenate([ext[:1], ext[:-1]]))

    with mock.patch.object(schedule, "make_schedule", make):
        yield


def _table_changed(**changed):
    """The serving path's generation table built with `changed` in place
    of the traffic's own arguments."""
    from asyrp_official_torch.pipelines import engine

    real = engine.generation_table
    return mock.patch.object(engine, "generation_table",
                             lambda seq, **kw: real(seq, **{**kw, **changed}))


def eta_dropped():
    """No step draws eta noise (t_addnoise ignored)."""
    return _table_changed(t_addnoise=-1)


def edit_below_t_edit():
    """The DeltaBlock edits every generation step, below t_edit too."""
    return _table_changed(t_edit=0)


def noise_other():
    """The eta noise reaching the chain is not the seed's: its sign is
    flipped."""
    def change(run, model, edit, x0, **kw):
        noise_fn = kw.pop("noise_fn")
        return run(model, edit, x0, noise_fn=lambda s, sh: -noise_fn(s, sh), **kw)

    return _wrap_serving(change)


def _run(cell):
    return harness.run_cell(cell, seed=2 ** 33 + 17, seconds=0.01, trace=False,
                            t_start=time.perf_counter(), device="cpu")


FAULTS = (step_unchanged, answer_altered, schedule_shifted, eta_dropped, noise_other,
          edit_below_t_edit)
CASES = ([(w, f) for w in EDIT for f in FAULTS]
         + [(w, half_batch) for w in EDIT if full_cell(w).traffic["batch"] > 1])


def _batch(workload):
    return 4 if full_cell(workload).traffic["batch"] > 1 else 0


@pytest.mark.parametrize("workload,fault", CASES, ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(workload, fault):
    cell = tiny_cell(workload, steps=8, batch=_batch(workload))
    with fault():
        result = _run(cell)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", EDIT)
def test_sound_run_is_correct(workload):
    cell = tiny_cell(workload, steps=8, batch=_batch(workload))
    cell.traffic["dtype"] = "float32"
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
