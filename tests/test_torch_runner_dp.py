"""The port's runner on a mesh of gloo ranks on the CPU, through the CLI on
the tiny workspace, against its own single-process run of the same flags
(the JAX package's `tests/test_runner_dp.py` holds its mesh runs to its
single-device run the same way, with these tolerances):

  * `--dp 2` on 2 ranks, every runner mode: Δ-training of a DeltaBlock with
    the CLIP directional term (a batch-mean loss: `Mesh.batch_mean`) and of
    the Δh rows, then serving blocks and rows (the masked slerp),
    `--multiple_attr`, `--delta_interpolation`, the mean-of-Δh harvest,
    `--load_random_noise`, the process dumps, the eta noise window on,
    `--lpips` (a padded last batch), `--run_fidelity` (padded) and
    `--diff_style` (batch-1 images padded): the Δ leaves within 5e-5, every
    grid within 2/255, the harvested rows and the LPIPS curves within 1e-5
    of scale;
  * `--dp 4 --tp_spatial` and `--dp 2 --sp 2` serving on 4 ranks (the
    precompute's inversion sharded too): the grids within 2/255 of the
    single-process run, the harvested rows within 2e-4 of scale (JAX's
    bound for sharded runs);
  * under each of `--dp 4 --tp_spatial` and `--dp 2 --sp 2` on 4 ranks,
    Δ-training of a DeltaBlock (CLIP + L1; and L1 + the ArcFace ID term at
    256²) and of the Δh rows, `--lpips`, `--run_fidelity` and
    `--diff_style`: the Δ leaves within 5e-5, every grid within 2/255 and
    the LPIPS curves within 5e-3 of the single-process run (the bounds of JAX's `tests/test_runner_dp.py`
    `test_tp_spatial_training`, `test_dp_sp_2d_mesh` and its `--lpips`
    test);
  * base training (`pipelines/base_train.py`): one `--dp 2`-style step on
    2 ranks, each with its rows of a global batch whose timesteps and noise
    were drawn once, against one process stepping on the whole batch; both
    ranks then save the train-state sidecar to one path
    (`pipelines/checkpoint.py`), which holds rank 0's state whole.
"""
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from parity_utils import close_to_scale, tiny_lpips_ckpt
from torch_ranks import run_ranks

from asyrp_official_torch.cli.main import main as port_main
from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint, save_delta_checkpoint
from asyrp_official_torch.losses.id_loss import IRSE50
from asyrp_official_torch.losses import clip_model as pm
from asyrp_official_torch.models.delta import delta_block_init
from asyrp_official_torch.utils import hostrng
from asyrp_official_torch.utils.tinyws import tiny_base_argv, write_tiny_workspace

RUN = "LC_CUSTOM_t999_ninv4_ngen4"
CLIP_CFG = pm.CLIPConfig(embed_dim=32, image_resolution=16, vision_layers=1, vision_width=64,
                         vision_patch_size=8, context_length=16, transformer_width=64,
                         transformer_heads=1, transformer_layers=1)
NOISE = ["--user_defined_t_addnoise", "700"]  # eta noise on two of the four steps
SERVE = ["--run_test", "--train_delta_block", "--do_train", "0"]
MULTI = ["--load_from_checkpoint", "attribute", "--multiple_attr", "smiling angry",
         "--multiple_hs_coeff", "1.0 0.5", "--get_h_num", "2", "--save_x_origin"]
# (exp, flags): every mode of the runner
RUNS = [
    ("train", ["--run_train", "--train_delta_block", "--n_iter", "2", "--clip_loss_w", "1",
               "--do_test", "1"] + NOISE),
    ("rows", ["--run_train", "--train_delta_h", "--delta_injection", "add", "--n_iter", "2",
              "--do_test", "0"]),
    ("rows", ["--run_test", "--train_delta_h", "--n_iter", "2", "--delta_injection", "slerp",
              "--masked_h", "--do_train", "0", "--save_x_origin"] + NOISE),
    ("multi", SERVE + MULTI + NOISE),
    ("sweep", SERVE + ["--load_from_checkpoint", "blk", "--delta_interpolation", "--num_delta",
                       "2", "--save_x_origin"] + NOISE),
    ("harvest", ["--run_test", "--train_delta_block", "--load_from_checkpoint", "blk",
                 "--num_mean_of_delta_hs", "2", "--do_train", "1", "--do_test", "1"]),
    ("noise", SERVE + ["--load_from_checkpoint", "blk", "--load_random_noise",
                       "--saved_random_noise", "--n_precomp_img", "2", "--save_x_origin"]),
    ("process", SERVE + ["--load_from_checkpoint", "blk", "--save_x_origin",
                         "--save_process_origin", "--save_process_delta_h"] + NOISE),
    ("fidelity", ["--run_fidelity", "--train_delta_block", "--manual_checkpoint_name",
                  f"blk_{RUN}_0.pth", "--n_test_img", "3"] + NOISE),
    ("style", ["--diff_style", "--content_dir", "{ws}/contents", "--style_dir", "{ws}/styles",
               "--save_dir", "{ws}/styled", "--n_gen_step", "6", "--hs_coeff", "0.7"]),
    ("lpips", ["--lpips", "--lpips_ckpt", "{ws}/lpips.npz", "--n_train_img", "2"]),
]
# Δ-training with the ArcFace ID term (`--id_loss_w`, a random IR-SE50) on
# the tiny DDPM++ at 256², where the face crop [35:223, 32:220] is whole;
# three steps, so that its latent cache and its run's name are its own. It
# is held by its Δ leaves and writes no images
ID_TAG = "LC_CUSTOM_t999_ninv3_ngen3"
ID_RUN = ("id", ["--config", "{ws}/tiny256.yml", "--run_train", "--train_delta_block",
                 "--n_iter", "2", "--do_test", "0", "--save_train_image", "0", "--id_loss_w",
                 "1", "--ir_se50_ckpt", "{ws}/ir_se50.pth", "--n_inv_step", "3",
                 "--n_train_step", "3", "--n_test_step", "3", "--n_train_img", "2"])
# on 4 ranks: (exp, flags, mesh flags) — serving under spatial sharding
SPATIAL_RUNS = [
    ("multi", SERVE + MULTI + NOISE, ["--dp", "4", "--tp_spatial"]),
    ("rows", RUNS[2][1], ["--dp", "4", "--tp_spatial"]),
    ("process", RUNS[7][1], ["--dp", "2", "--sp", "2"]),
    ("harvest", RUNS[5][1], ["--dp", "2", "--sp", "2"]),
]

# on 4 ranks under each spatial layout: training (blocks, rows) and the
# other modes, from a fresh workspace
SPATIAL_MESHES = {"tp4": ["--dp", "4", "--tp_spatial"], "sp22": ["--dp", "2", "--sp", "2"]}
SPATIAL_TRAIN_RUNS = [RUNS[i] for i in (0, 1, 8, 9, 10)] + [ID_RUN]

WORKER = r'''
import json
from asyrp_official_torch.cli.main import main

for argv in json.loads(ARGS[0]):
    rc = main(argv)
    assert rc == 0, (argv, rc)
'''


def _workspace(ws):
    """The tiny workspace (4 images), seeded block checkpoints (one per
    attribute and one plain), the tiny CLIP, content and style images, a
    random LPIPS npz, and the ID run's 256² config and random IR-SE50."""
    write_tiny_workspace(ws)
    with open(os.path.join(ws, "tiny.yml")) as f:
        config = yaml.safe_load(f)
    config["data"]["image_size"] = 256
    config["model"].update(ch_mult=[1, 1, 2], attn_resolutions=[])
    with open(os.path.join(ws, "tiny256.yml"), "w") as f:
        yaml.safe_dump(config, f)
    torch.manual_seed(0)
    torch.save(IRSE50().state_dict(), os.path.join(ws, "ir_se50.pth"))
    for i, name in enumerate(("smiling", "angry", "blk")):
        save_delta_checkpoint(os.path.join(ws, "checkpoint", f"{name}_{RUN}_0.pth"),
                              blocks=[delta_block_init(hostrng.PRNGKey(100 + i), 64, 128)],
                              flavor="ddpm")
    torch.save(pm.CLIP(CLIP_CFG, seed=1).state_dict(), os.path.join(ws, "clip_tiny.pt"))
    rng = np.random.RandomState(7)
    for sub, n in (("contents", 1), ("styles", 1)):
        os.makedirs(os.path.join(ws, sub))
        for i in range(n):
            Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(
                os.path.join(ws, sub, f"{i}.png"))
    tiny_lpips_ckpt(os.path.join(ws, "lpips.npz"))


def _argv(ws, exp, flags, mesh=()):
    flags = [f.replace("{ws}", ws) for f in flags]
    return tiny_base_argv(os.path.join(ws, "tiny.yml"), os.path.join(ws, "imgs"), ws,
                          os.path.join(ws, "runs", exp), n_img=4, bs_train=2,
                          extra=["--clip_ckpt", os.path.join(ws, "clip_tiny.pt"), *flags,
                                 "--device", "cpu", *mesh])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("dp_single"))
    _workspace(ws)
    for exp, flags in RUNS + [ID_RUN]:
        assert port_main(_argv(ws, exp, flags)) == 0, exp
    return ws


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("dp_two"))
    _workspace(ws)
    runs = [_argv(ws, exp, flags, ["--dp", "2"]) for exp, flags in RUNS]
    run_ranks(WORKER, 2, [json.dumps(runs)], timeout=180)
    return ws


@pytest.fixture(scope="module")
def spatial4(single, tmp_path_factory):
    """The single-process workspace copied, its outputs, latent caches and
    harvest removed, then served again on 4 ranks under spatial sharding."""
    ws = str(tmp_path_factory.mktemp("dp_spatial") / "ws")
    shutil.copytree(single, ws)
    for p in glob.glob(os.path.join(ws, "runs", "**", "*.png"), recursive=True):
        os.remove(p)
    for d in ("precomputed", "checkpoint_latent"):
        shutil.rmtree(os.path.join(ws, d), ignore_errors=True)
    runs = [_argv(ws, exp, flags, mesh) for exp, flags, mesh in SPATIAL_RUNS]
    run_ranks(WORKER, 4, [json.dumps(runs)], timeout=180)
    return ws


@pytest.fixture(scope="module", params=sorted(SPATIAL_MESHES))
def spatial_train(request, tmp_path_factory):
    """Training and the other modes on 4 ranks under one spatial layout,
    from a fresh workspace."""
    ws = str(tmp_path_factory.mktemp(f"dp_{request.param}"))
    _workspace(ws)
    runs = [_argv(ws, exp, flags, SPATIAL_MESHES[request.param])
            for exp, flags in SPATIAL_TRAIN_RUNS]
    run_ranks(WORKER, 4, [json.dumps(runs)], timeout=300)
    return ws


def _pngs(ws, sub="runs"):
    root = os.path.join(ws, sub)
    return {os.path.relpath(p, root): np.asarray(Image.open(p)).astype(np.int16)
            for p in sorted(glob.glob(os.path.join(root, "**", "*.png"), recursive=True))}


def _grids_match(got, want, what):
    assert got, f"{what}: no images written"
    assert sorted(got) == sorted(want), what
    worst = {k: int(np.abs(got[k] - want[k]).max()) for k in got}
    assert max(worst.values()) <= 2, (what, worst)


def _delta_leaves(ws, exp, it=1):
    d = os.path.join(ws, "checkpoint")
    tag = ID_TAG if exp == ID_RUN[0] else RUN
    name = [c for c in os.listdir(d) if c.startswith(f"{exp}_{tag}") and c.endswith(f"_{it}.pth")]
    assert len(name) == 1, (exp, os.listdir(d))
    loaded = load_delta_checkpoint(os.path.join(d, name[0]))
    if "blocks" in loaded:
        return [np.asarray(v) for blk in loaded["blocks"] for g in sorted(blk)
                for v in (blk[g].values() if isinstance(blk[g], dict) else [blk[g]])]
    return [np.asarray(loaded["delta_rows"][t]) for t in sorted(loaded["delta_rows"])]


@pytest.mark.parametrize("exp", ["train", "rows"])
def test_dp_training_lands_on_the_single_process_delta(single, dp2, exp):
    a, b = _delta_leaves(single, exp), _delta_leaves(dp2, exp)
    assert len(a) == len(b) > 0
    init = _delta_leaves(single, exp, it=0)
    assert max(np.abs(x - y).max() for x, y in zip(a, init)) > 1e-4, "the Δ did not train"
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, atol=5e-5)


def test_dp_grids_match_the_single_process_grids(single, dp2):
    for sub in ("runs", "styled"):
        _grids_match(_pngs(dp2, sub), _pngs(single, sub), sub)


def test_dp_harvest_and_lpips_curves_match(single, dp2):
    d = "checkpoint_latent"
    names = sorted(os.listdir(os.path.join(single, d)))
    assert names and names == sorted(os.listdir(os.path.join(dp2, d)))
    for n in names:
        a = load_delta_checkpoint(os.path.join(single, d, n))["delta_rows"]
        b = load_delta_checkpoint(os.path.join(dp2, d, n))["delta_rows"]
        assert sorted(a) == sorted(b)
        for t in a:
            close_to_scale(b[t], a[t], f"harvested row {t}", bound=1e-5)
    tsvs = sorted(glob.glob(os.path.join(single, "utils", "*.tsv")))
    assert len(tsvs) == 4
    for p in tsvs:
        a = np.loadtxt(p)
        b = np.loadtxt(os.path.join(dp2, "utils", os.path.basename(p)))
        close_to_scale(b, a, os.path.basename(p), bound=1e-5)


@pytest.mark.parametrize("exp", ["train", "rows", "id"])
def test_spatial_training_lands_on_the_single_process_delta(single, spatial_train, exp):
    """Each rank backpropagates its share of the loss through the exchanges'
    adjoints and the gradients are summed over the spatial ranks: the Δ
    lands where one process's does (5e-5; with the CLIP term not weighted
    1/S the block lands 2.0e-3 to 3.9e-3 off, a mutation check made on a
    copy of the port). `id`: the ArcFace term on the gathered 256² images
    (it moves the loss, not the block: x0_t's features are detached)."""
    a, b = _delta_leaves(single, exp), _delta_leaves(spatial_train, exp)
    assert len(a) == len(b) > 0
    init = _delta_leaves(single, exp, it=0)
    assert max(np.abs(x - y).max() for x, y in zip(a, init)) > 1e-4, "the Δ did not train"
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, atol=5e-5)


def test_spatial_modes_match_the_single_process_outputs(single, spatial_train):
    """The grids of training, `--run_fidelity` and `--diff_style` within
    2/255, the `--lpips` curves within 5e-3 (JAX's bound)."""
    got = _pngs(spatial_train)
    exps = {k.split(os.sep)[0] for k in got}
    assert exps == {f"{e}_{RUN}" for e, _ in SPATIAL_TRAIN_RUNS if e not in ("style", "id")} - {
        f"lpips_{RUN}"}, exps
    _grids_match(got, {k: v for k, v in _pngs(single).items() if k in got}, "spatial modes")
    _grids_match(_pngs(spatial_train, "styled"), _pngs(single, "styled"), "spatial --diff_style")
    tsvs = sorted(glob.glob(os.path.join(single, "utils", "*.tsv")))
    assert len(tsvs) == 4
    for p in tsvs:
        a = np.loadtxt(p)
        b = np.loadtxt(os.path.join(spatial_train, "utils", os.path.basename(p)))
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=5e-3, err_msg=os.path.basename(p))


def test_spatial_serving_matches_the_single_process_grids(single, spatial4):
    got = _pngs(spatial4)
    want = {k: v for k, v in _pngs(single).items() if k in got}
    exps = {k.split(os.sep)[0] for k in got}
    assert exps == {f"{e}_{RUN}" for e, _, _ in SPATIAL_RUNS}, exps
    _grids_match(got, want, "spatial serving")
    d = "checkpoint_latent"
    names = sorted(os.listdir(os.path.join(spatial4, d)))
    assert names and names == sorted(os.listdir(os.path.join(single, d)))
    for n in names:  # the harvest over the gathered Δh rows; 2e-4 of scale (JAX's
        # bound for its sharded runs: the norms' statistics sum in another order)
        a = load_delta_checkpoint(os.path.join(single, d, n))["delta_rows"]
        b = load_delta_checkpoint(os.path.join(spatial4, d, n))["delta_rows"]
        assert sorted(a) == sorted(b)
        for t in a:
            close_to_scale(b[t], a[t], f"spatial harvest row {t}", bound=2e-4)


BASE_WORKER = r'''
import numpy as np
import torch
from asyrp_official_torch.core import gaussian as G
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.parallel import mesh as pmesh
from asyrp_official_torch.pipelines import base_train as bt
from asyrp_official_torch.pipelines.checkpoint import save_train_state
from asyrp_official_torch.utils.tinyws import TINY_DDPMPP_CONFIG

src, out = ARGS[0], ARGS[1]
batch = np.load(src)
spec = spec_from_config(TINY_DDPMPP_CONFIG)
model = spec.build()
model.load_state_dict(torch.load(src + ".pt"))
m = pmesh.make_mesh(WORLD, 1)
opt = torch.optim.SGD(model.parameters(), lr=0.5)
model, ema, opt = bt.init_train_state(model, opt)
tab = G.make_tables(np.linspace(1e-4, 0.02, 50))
step = bt.make_base_train_step(bt.unet_eps_fn, tab, opt, ema_rate=0.9,
                               sync_grads=m.sync_grads if WORLD > 1 else None)
x0, t, noise, w = (torch.from_numpy(m.local(batch[k], height_dim=None)) for k in ("x0", "t", "noise", "w"))
step(model, ema, x0, t, noise, w)
if RANK == 0:
    np.savez(out, **{k: v.detach().numpy() for k, v in model.state_dict().items()})
# every rank saves the train state to one path (per-process temp file, then a rename)
save_train_state(out + ".state.pt", trainable=model.state_dict(), opt_state=opt.state_dict(),
                 it_out=1, extra={"ema": ema.state_dict()})
'''


def test_dp_base_training_step_matches_one_process(tmp_path):
    """The global batch of 4 (its timesteps and noise drawn once, as one
    process draws them) split over 2 ranks, gradients averaged: the same
    parameters after one SGD step as one process on the whole batch (5e-5,
    the Δ tolerance)."""
    from asyrp_official_torch.models.registry import spec_from_config
    from asyrp_official_torch.utils.tinyws import TINY_DDPMPP_CONFIG

    spec = spec_from_config(TINY_DDPMPP_CONFIG)
    torch.save(spec.state_dict_from_jax(spec.init(hostrng.PRNGKey(0))), tmp_path / "b.npz.pt")
    rng = np.random.RandomState(0)
    np.savez(tmp_path / "b.npz", x0=rng.randn(4, 3, 32, 32).astype(np.float32),
             t=rng.randint(0, 50, 4).astype(np.int64),
             noise=rng.randn(4, 3, 32, 32).astype(np.float32),
             w=(0.5 + rng.rand(4)).astype(np.float32))
    outs = {}
    for world in (1, 2):
        outs[world] = str(tmp_path / f"w{world}.npz")
        run_ranks(BASE_WORKER, world, [str(tmp_path / "b.npz"), outs[world]], timeout=120)
    a, b = np.load(outs[1]), np.load(outs[2])
    init = torch.load(tmp_path / "b.npz.pt")
    moved = max(float(np.abs(a[k] - init[k].numpy()).max()) for k in a.files)
    assert moved > 1e-3, "the step moved nothing"
    for k in a.files:
        np.testing.assert_allclose(b[k], a[k], atol=5e-5, err_msg=k)
    # the sidecar both ranks wrote to one path: a whole file of rank 0's state
    state = torch.load(outs[2] + ".state.pt", weights_only=True)
    assert state["meta"]["it_out"] == 1 and not glob.glob(outs[2] + ".state.pt.tmp*")
    for k in a.files:
        np.testing.assert_array_equal(state["trainable"][k].numpy(), b[k], err_msg=k)
