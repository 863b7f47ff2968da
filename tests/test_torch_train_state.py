"""The port's train-state sidecar (`pipelines/checkpoint.py`): a round trip
of the state dict, optimizer state, counter and `extra`; an absent file
reads as None; a mismatched layout raises; no temp file is left; and base
training resumed from the sidecar after step 2 takes step 3 bit for bit as
the uninterrupted run (parameters, EMA and loss), on the 16^2 DDPM++ of the
base-training tests with Adam."""
import os

import numpy as np
import pytest
import torch

from asyrp_official_torch.core import gaussian as PG
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines.base_train import (
    init_train_state, make_base_train_step, unet_eps_fn)
from asyrp_official_torch.pipelines.checkpoint import load_train_state, save_train_state

from test_torch_gaussian import _DDPMPP16

TAB = PG.make_tables(np.linspace(1e-4, 0.02, 50))


def _fresh(seed=0):
    torch.manual_seed(seed)
    model = spec_from_config(_DDPMPP16).build()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model, ema, opt = init_train_state(model, opt)
    return model, ema, opt, make_base_train_step(unet_eps_fn, TAB, opt, ema_rate=0.9)


def _batch(i):
    rng = np.random.RandomState(i)
    x0 = torch.from_numpy(np.clip(rng.randn(2, 3, 16, 16) * 0.5, -1, 1).astype(np.float32))
    return (x0, torch.from_numpy(rng.randint(0, 50, 2)),
            torch.from_numpy(rng.randn(2, 3, 16, 16).astype(np.float32)), torch.ones(2))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_round_trip_absent_file_and_layout_check(tmp_path):
    path = str(tmp_path / "state.pt")
    assert load_train_state(path, like={}) is None
    model, ema, opt, step = _fresh()
    step(model, ema, *_batch(0))
    save_train_state(path, trainable=model.state_dict(), opt_state=opt.state_dict(), it_out=7,
                     extra={"ema": ema.state_dict(), "note": "base"})
    assert os.listdir(tmp_path) == ["state.pt"]  # written, then moved into place
    got = load_train_state(path, like={"trainable": model.state_dict()})
    assert got["meta"]["it_out"] == 7 and got["extra"]["note"] == "base"
    _same(got["trainable"], model.state_dict())
    _same(got["extra"]["ema"], ema.state_dict())
    assert got["opt_state"]["state"][0]["step"] == 1
    save_train_state(path, trainable={"w": torch.zeros(2)}, opt_state={}, it_out=0)
    assert load_train_state(path, like={})["extra"] is None
    with pytest.raises(ValueError, match="does not match"):
        load_train_state(path, like={"trainable": model.state_dict()})


def test_resume_after_step_two_is_bit_exact(tmp_path):
    path = str(tmp_path / "state.pt")
    model, ema, opt, step = _fresh()
    for i in range(2):
        step(model, ema, *_batch(i))
    save_train_state(path, trainable=model.state_dict(), opt_state=opt.state_dict(), it_out=2,
                     extra={"ema": ema.state_dict()})
    want = step(model, ema, *_batch(2))

    model2, ema2, opt2, step2 = _fresh(seed=1)  # other weights until the restore
    state = load_train_state(path, like={"trainable": model2.state_dict()})
    model2.load_state_dict(state["trainable"])
    ema2.load_state_dict(state["extra"]["ema"])
    opt2.load_state_dict(state["opt_state"])
    assert state["meta"]["it_out"] == 2
    got = step2(model2, ema2, *_batch(2))
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["loss_per_sample"], want["loss_per_sample"])
    _same(model2.state_dict(), model.state_dict())
    _same(ema2.state_dict(), ema.state_dict())
