"""The port's multi-edit serving modes against the JAX CLI, on the CPU at
the tiny DDPM++ workspace (`asyrp_official_tpu.utils.tinyws`), each JAX run
once per module:

  * `--multiple_attr` (per-attribute checkpoints, the CLIP text-cosine pick
    of the interval's prompts, 1/sqrt(n) scaling) with
    `--multiple_hs_coeff`, alone and under `--delta_interpolation` (the
    3-coefficient grid, 9 pairs);
  * a `--delta_interpolation` sweep against the JAX per-coefficient loop,
    and, with the eta noise window on, each pass drawing the seeded noise
    of a one-coefficient run;
  * the mean-of-Δh harvest (`--num_mean_of_delta_hs`): the saved rows, the
    test split served from them, the accumulation over sweep passes (two
    identical coefficients give exactly 2x) and the reference's
    "saves nothing" quirk;
  * `--load_random_noise --saved_random_noise` latents and their cache;
  * the process dumps (`--save_process_origin`, `--save_process_delta_h`)
    and `--pass_editing`.

Tolerance: grids within one uint8 level; saved rows and cached latents
within 1e-4 of scale (`close_to_scale`).
"""
import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image

from parity_utils import close_to_scale

from asyrp_official_torch.losses import clip_model as pm
from asyrp_official_tpu.compat.delta_ckpt import load_delta_checkpoint, save_delta_checkpoint
from asyrp_official_tpu.models.delta import delta_block_init
from asyrp_official_tpu.utils import hostrng
from asyrp_official_tpu.utils.tinyws import tiny_base_argv, write_tiny_workspace

RUN = "LC_CUSTOM_t999_ninv4_ngen4"
# the tiny CLIP of the port's training tests (tests/test_torch_train.py)
CLIP_CFG = pm.CLIPConfig(embed_dim=32, image_resolution=16, vision_layers=1, vision_width=64,
                         vision_patch_size=8, context_length=16, transformer_width=64,
                         transformer_heads=1, transformer_layers=1)

# exp name -> the mode flags of one run (the JAX and the port CLI alike)
SERVE = ["--run_test", "--train_delta_block", "--do_train", "0"]
MULTI = ["--load_from_checkpoint", "attribute", "--multiple_attr", "smiling angry",
         "--multiple_hs_coeff", "1.0 0.5", "--get_h_num", "2", "--save_x_origin"]
HARVEST = ["--run_test", "--train_delta_block", "--load_from_checkpoint", "blk",
           "--num_mean_of_delta_hs", "1", "--do_train", "1", "--do_test", "1"]
RUNS = {
    "multi": SERVE + MULTI,
    "multi9": SERVE + MULTI + ["--delta_interpolation", "--num_delta", "3",
                               "--min_delta", "0.5", "--max_delta", "1.5"],
    "sweep": SERVE + ["--load_from_checkpoint", "blk", "--delta_interpolation", "--num_delta", "3",
                      "--min_delta", "-0.5", "--max_delta", "1.0", "--save_x_origin"],
    "harvest": HARVEST,
    "harvest2": HARVEST[:-4] + ["--do_train", "1", "--do_test", "0", "--delta_interpolation",
                                "--num_delta", "2", "--min_delta", "1.0", "--max_delta", "1.0"],
    "harvest1": HARVEST[:-4] + ["--do_train", "1", "--do_test", "0"],
    "noise": SERVE + ["--load_from_checkpoint", "blk", "--load_random_noise",
                      "--saved_random_noise", "--n_precomp_img", "2", "--save_x_origin"],
    "process": SERVE + ["--load_from_checkpoint", "blk", "--save_x_origin",
                        "--save_process_origin", "--save_process_delta_h"],
    "pass": SERVE + ["--load_from_checkpoint", "blk", "--save_x_origin", "--pass_editing"],
}
# port-only runs with the eta noise window on (t < 700: two of the four steps draw)
NOISE = ["--user_defined_t_addnoise", "700"]
PORT_RUNS = {
    "sweep_noise": RUNS["sweep"] + NOISE,
    "single_noise": SERVE + ["--load_from_checkpoint", "blk", "--save_x_origin"] + NOISE,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workspace(ws):
    """The tiny workspace, its seeded block checkpoints (one per attribute
    and one plain) and the tiny CLIP's weights."""
    write_tiny_workspace(ws)
    for i, name in enumerate(("smiling", "angry", "blk")):
        save_delta_checkpoint(os.path.join(ws, "checkpoint", f"{name}_{RUN}_0.pth"),
                              blocks=[delta_block_init(hostrng.PRNGKey(100 + i), 64, 128)],
                              flavor="ddpm")
    torch.save(pm.CLIP(CLIP_CFG, seed=1).state_dict(), os.path.join(ws, "clip_tiny.pt"))


def _argv(ws, exp, extra):
    return tiny_base_argv(os.path.join(ws, "tiny.yml"), os.path.join(ws, "imgs"), ws,
                          os.path.join(ws, "runs", exp), bs_train=1,
                          extra=["--clip_ckpt", os.path.join(ws, "clip_tiny.pt"), *extra])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of RUNS through the JAX CLI (its per-coefficient loop for
    the sweeps) and through the port's CLI (`--device cpu`), one workspace
    per package; the port also runs PORT_RUNS."""
    from asyrp_official_torch.cli.main import main as port_main
    from asyrp_official_tpu.cli.main import main as jax_main

    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("ASYRP_TPU_NO_BATCHED_SWEEP", "1")  # the JAX runner's loop
    try:
        for name, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
            ws = str(tmp_path_factory.mktemp(f"multi_{name}"))
            _workspace(ws)
            for exp, flags in RUNS.items():
                assert main(_argv(ws, exp, flags + extra)) == 0, (name, exp)
            out[name] = ws
    finally:
        mp.undo()
    for exp, flags in PORT_RUNS.items():
        assert port_main(_argv(out["port"], exp, flags + ["--device", "cpu"])) == 0, exp
    return out


def _grids(ws, exp):
    d = os.path.join(ws, "runs", f"{exp}_{RUN}")
    out = {}
    for r, _, fs in os.walk(d):
        for f in sorted(fs):
            if f.endswith(".png"):
                out[os.path.relpath(os.path.join(r, f), d)] = np.asarray(
                    Image.open(os.path.join(r, f))).astype(np.int16)
    return out


def _is_frame(key):
    return os.path.basename(key).startswith(("origin_", "delta_h_"))


def _rows_of_grid(grid, n_rows):
    """Whether a grid of 32^2 images with 1-pixel padding is n_rows high."""
    return grid.shape[0] == 33 * n_rows + 1


@pytest.mark.parametrize("exp,n_rows", [("multi", 2), ("multi9", 10), ("sweep", 4),
                                        ("harvest", 1), ("noise", 2), ("pass", 1)])
def test_grids_match_the_jax_cli(runs, exp, n_rows):
    want, got = _grids(runs["jax"], exp), _grids(runs["port"], exp)
    assert sorted(want) == sorted(got) and got, (sorted(want), sorted(got))
    for k in got:
        assert _rows_of_grid(got[k], n_rows), (k, got[k].shape)
        assert np.abs(want[k] - got[k]).max() <= 1, (exp, k, int(np.abs(want[k] - got[k]).max()))


def test_sweep_passes_share_the_seeded_noise(runs):
    """With the eta noise window on, every pass of a sweep draws the seeded
    noise a one-coefficient run draws: the sweep's last row (coefficient
    1.0, the default) is that run's edited row bit for bit, and both plain
    rows agree."""
    sweep, single = _grids(runs["port"], "sweep_noise"), _grids(runs["port"], "single_noise")
    assert sorted(sweep) == sorted(single) and sweep
    for k in sweep:
        s, o = sweep[k], single[k]
        assert _rows_of_grid(s, 4) and _rows_of_grid(o, 2), (k, s.shape, o.shape)
        np.testing.assert_array_equal(s[:34], o[:34])  # the plain generation
        np.testing.assert_array_equal(s[99:], o[33:])  # coefficient 1.0
        assert np.abs(s[33:67] - o[33:]).max() > 0  # coefficient -0.5 edits otherwise


def test_process_frames_match_the_jax_cli(runs):
    """Per-step [x; x0_t] frames of the plain and the edited generation."""
    want, got = _grids(runs["jax"], "process"), _grids(runs["port"], "process")
    frames = [k for k in got if _is_frame(k)]
    assert sorted(want) == sorted(got)
    assert sum("origin_" in k for k in frames) == sum("delta_h_" in k for k in frames) == 8
    for k in got:
        assert np.abs(want[k] - got[k]).max() <= 1, k


def _mean_rows(ws, exp):
    return load_delta_checkpoint(os.path.join(ws, "checkpoint_latent",
                                              f"{exp}_{RUN}_4_1.pth"))["delta_rows"]


def test_harvested_rows_match_the_jax_cli(runs):
    """The per-timestep mean Δh of the first training image (t >= t_edit)
    and their mean as row 0; the rest of the run is served from them."""
    want, got = _mean_rows(runs["jax"], "harvest"), _mean_rows(runs["port"], "harvest")
    assert sorted(want) == sorted(got) == [0, 666, 999]
    for t in want:
        assert np.isfinite(got[t]).all()
        close_to_scale(want[t], got[t], f"mean row {t}")


def test_harvest_sums_the_sweep_passes(runs):
    """Two identical sweep coefficients: the rows come out exactly 2x the
    single pass's (the harvest divides by the image count only)."""
    one, two = _mean_rows(runs["port"], "harvest1"), _mean_rows(runs["port"], "harvest2")
    assert sorted(one) == sorted(two) and len(one) > 1
    for t in one:
        np.testing.assert_allclose(two[t], 2.0 * one[t], rtol=1e-4, atol=1e-5)


def test_harvest_ending_on_the_last_training_image_saves_nothing(runs, caplog):
    from asyrp_official_torch.cli.main import main as port_main

    ws = runs["port"]
    with caplog.at_level(logging.WARNING):
        assert port_main(_argv(ws, "meq", HARVEST[:-6] + [
            "--num_mean_of_delta_hs", "2", "--do_train", "1", "--do_test", "0",
            "--device", "cpu"])) == 0
    assert not any(f.startswith("meq_") for f in os.listdir(os.path.join(ws, "checkpoint_latent")))
    assert any("NOT saved" in r.getMessage() for r in caplog.records)


def test_random_noise_latents_match_the_jax_cli(runs):
    """The seeded Gaussian latents bit for bit and their plain generation
    within 1e-4 of scale, cached under the random_noise_ name."""
    name = os.path.join("precomputed", "CUSTOM_test_random_noise_nim2_ninv4_pairs.npz")
    with np.load(os.path.join(runs["jax"], name)) as w, np.load(os.path.join(runs["port"], name)) as g:
        np.testing.assert_array_equal(w["x_lat"], g["x_lat"])
        for k in ("x0", "x_rec"):
            close_to_scale(w[k], g[k], k)
