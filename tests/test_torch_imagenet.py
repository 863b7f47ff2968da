"""The port's IMAGENET path (`imagenet.yml`: the class-conditional ADM 256^2
UNet) against the JAX package, on the CPU: the class-conditional init and
forward on a tiny config (32^2, ch 32, mult (1, 2), 4 heads of 16 at 16^2,
10 classes, learn_sigma), the full-width parameter count and `label_emb`
draw, the load of a state dict without `label_emb.weight` (ADM's released
unconditional checkpoint), the ImageNet reader, the class-named latent
caches, and `--run_test` / `--run_train` with `--target_class_num` through
both CLIs on a tiny IMAGENET workspace.

Tolerance: `close_to_scale` 1e-4 (max error relative to the array's scale)
in float32; grids within one uint8 level; readers and inits bit for bit.
"""
import dataclasses
import os
import random
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from parity_utils import close_to_scale, tiny_lpips_ckpt
from test_torch_openai import CLIP_CFG, perturbed

from asyrp_official_torch.compat import delta_ckpt as tckpt
from asyrp_official_torch.compat.from_jax import openai_unet_state_dict_from_jax
from asyrp_official_torch.configs.paths import DATASET_PATHS as T_PATHS
from asyrp_official_torch.data import datasets as tdata
from asyrp_official_torch.losses import clip_model as pm
from asyrp_official_torch.models import openai_unet as toai
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import precompute as tpc
from asyrp_official_tpu.compat import delta_ckpt as jckpt
from asyrp_official_tpu.configs.paths import DATASET_PATHS as J_PATHS
from asyrp_official_tpu.data import datasets as jdata
from asyrp_official_tpu.models import common as jcm
from asyrp_official_tpu.models import delta as jdelta
from asyrp_official_tpu.models import openai_unet as joai
from asyrp_official_tpu.pipelines import precompute as jpc
from asyrp_official_tpu.utils import hostrng

SMALL_CC = dict(image_size=32, model_channels=32, out_channels=6, num_res_blocks=1,
                attention_ds=(2,), channel_mult=(1, 2), num_heads=4, num_head_channels=16,
                num_classes=10)
CLASS = 1  # n01443537 goldfish
# the tiny IMAGENET workspace's yml: imagenet.yml's keys at the tiny widths
IMAGENET_TINY_CONFIG = {
    "data": {"dataset": "IMAGENET", "category": "IMAGENET", "image_size": 32, "channels": 3},
    "model": {"family": "openai", "in_channels": 3, "out_ch": 6, "ch": 32, "ch_mult": [1, 2],
              "num_res_blocks": 1, "attn_resolutions": [16], "dropout": 0.0,
              "var_type": "fixedsmall", "learn_sigma": True, "num_head_channels": 16,
              "use_scale_shift_norm": True, "resblock_updown": True, "class_cond": True},
    "diffusion": {"beta_schedule": "linear", "beta_start": 0.0001, "beta_end": 0.02,
                  "num_diffusion_timesteps": 1000},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    j = joai.OpenAIUNetConfig(**{**SMALL_CC, **over})
    t = toai.OpenAIUNetConfig(**{f.name: getattr(j, f.name)
                                 for f in dataclasses.fields(toai.OpenAIUNetConfig)})
    return j, t


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(p))


# ---------------------------------------------------------------------------
# the class-conditional init, the forward with and without labels, the load
# ---------------------------------------------------------------------------


def test_class_conditional_init_bit_identical_to_jax():
    """`label_emb` (0.02 N(0, 1)) from the third key of the split: every
    leaf after it, and it, equal the JAX init bit for bit."""
    jcfg, tcfg = _cfgs()
    jp = joai.init(hostrng.PRNGKey(3), jcfg)
    tp = toai.init_params(hostrng.PRNGKey(3), tcfg)
    assert tp["label_emb"]["w"].shape == (10, 128) and tp["label_emb"]["w"].dtype == np.float32
    _leaves_equal(jp, tp)
    assert 0.015 < float(np.std(tp["label_emb"]["w"])) < 0.025


def test_full_width_parameter_count_and_label_emb_draw():
    """imagenet.yml builds 553,838,086 parameters (on the meta device); its
    `label_emb` [1000, 1024] is JAX's draw at the same key. The other
    leaves are stubbed on both sides (a full-width draw is a chip-size job);
    each leaf has a key of its own, so the stubs move no key."""
    spec = spec_from_config(yaml.safe_load(open(os.path.join(
        os.path.dirname(toai.__file__), "..", "configs", "imagenet.yml"))))
    with torch.device("meta"):
        model = spec.build()
    assert sum(p.numel() for p in model.parameters()) == 553_838_086
    cfg = spec.config
    assert (cfg.num_classes, cfg.temb_ch, cfg.model_channels) == (1000, 1024, 256)
    stub = lambda *a, **k: {}  # noqa: E731
    with mock.patch.object(toai.hostinit, "conv_init", stub), \
            mock.patch.object(toai.hostinit, "linear_init", stub):
        got = toai.init_params(hostrng.PRNGKey(0), cfg)["label_emb"]["w"]
    jcfg = joai.OpenAIUNetConfig(**{f.name: getattr(cfg, f.name)
                                    for f in dataclasses.fields(toai.OpenAIUNetConfig)})
    with mock.patch.object(jcm, "conv_init", stub), mock.patch.object(jcm, "linear_init", stub):
        want = np.asarray(joai.init(hostrng.PRNGKey(0), jcfg)["label_emb"]["w"])
    assert got.shape == (1000, 1024)
    np.testing.assert_array_equal(got, want)


def _model(sd, tcfg):
    m = toai.OpenAIUNet(tcfg)
    m.load_state_dict(sd)
    return m.eval().requires_grad_(False)


def _inputs(b=2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 32, 32, 3).astype(np.float32),
            np.array([999.0, 400.0][:b], np.float32), np.array([3, 7][:b]))


@pytest.mark.parametrize("with_y", [False, True])
def test_apply_matches_jax_with_and_without_labels(with_y):
    """The label path (`get_temb(t, y)`: the class row added to the time
    embedding) and the unlabelled one, single and edited dual decode; the
    labels move eps."""
    jcfg, tcfg = _cfgs()
    params = perturbed(joai.init(hostrng.PRNGKey(0), jcfg))
    model = _model(openai_unet_state_dict_from_jax(params, tcfg), tcfg)
    jp = jax.tree.map(jnp.asarray, params)
    x, t, y = _inputs()
    block = jdelta.delta_block_init(hostrng.PRNGKey(3), 64, 128, flavor="openai")
    from asyrp_official_torch.models import delta as tdelta

    tb = tdelta.delta_block_from_tree(block, 64, 128, flavor="openai").eval()
    coeff = np.array([1.0, 1.5], np.float32)
    jedit = jdelta.EditState(blocks=(jax.tree.map(jnp.asarray, block),),
                             hs_coeff=jnp.asarray(coeff), flavor="openai")
    tedit = tdelta.EditState(blocks=(tb,), hs_coeff=torch.from_numpy(coeff), flavor="openai")
    jy = jnp.asarray(y) if with_y else None
    ty = torch.from_numpy(y) if with_y else None
    with torch.no_grad():
        plain = model.apply(torch.from_numpy(x), torch.from_numpy(t), y=ty)
        got = model.apply(torch.from_numpy(x), torch.from_numpy(t), edit=tedit, y=ty)
        unlabelled = model.apply(torch.from_numpy(x), torch.from_numpy(t))
    close_to_scale(np.asarray(joai.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t), y=jy)[0]),
                   plain[0].numpy(), "eps, single decode")
    want = joai.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t), edit=jedit, y=jy)
    for w, g, name in zip(want, got, ("eps", "eps_mod", "delta_h", "middle_h")):
        close_to_scale(np.asarray(w), g.numpy(), name)
    assert float(got[0].std()) > 0.1
    moved = float((plain[0] - unlabelled[0]).abs().max())
    assert (moved > 1e-3) if with_y else (moved == 0.0)


def test_state_dict_without_label_emb_loads_and_gives_jax_eps():
    """A class-conditional UNet loads a state dict without
    `label_emb.weight`, as the JAX converter does (it keeps no leaf, and
    `get_temb` then ignores y): the eps of JAX's params from that state
    dict, with and without labels. Any other missing or extra key raises."""
    jcfg, tcfg = _cfgs()
    params = perturbed(joai.init(hostrng.PRNGKey(0), jcfg))
    sd = openai_unet_state_dict_from_jax(params, tcfg)
    del sd["label_emb.weight"]
    model = _model(sd, tcfg)
    assert not hasattr(model, "label_emb")
    jp = jax.tree.map(jnp.asarray, joai.params_from_torch({k: v.numpy() for k, v in sd.items()},
                                                          jcfg))
    assert "label_emb" not in jp
    # that tree crosses the bridge back to the same keys
    assert sorted(openai_unet_state_dict_from_jax(jax.tree.map(np.asarray, jp), tcfg)) == sorted(sd)
    x, t, y = _inputs()
    want = np.asarray(joai.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t))[0])
    with torch.no_grad():
        for ty in (None, torch.from_numpy(y)):
            close_to_scale(want, model.apply(torch.from_numpy(x), torch.from_numpy(t), y=ty)[0]
                           .numpy(), "eps without label_emb")
    missing = dict(sd)
    del missing["out.2.bias"]
    with pytest.raises(RuntimeError, match="out.2.bias"):
        toai.OpenAIUNet(tcfg).load_state_dict(missing)
    with pytest.raises(RuntimeError, match="label_emb.extra"):
        toai.OpenAIUNet(tcfg).load_state_dict({**sd, "label_emb.extra": torch.zeros(1)})


# ---------------------------------------------------------------------------
# the ImageNet reader and the class-named caches
# ---------------------------------------------------------------------------


def _write_imagenet(root, class_num=CLASS, sizes=((80, 60), (45, 120), (300, 200))):
    """Images of `class_num` at odd sizes: `{root}/train/<wnid>/<wnid>/*.jpeg`
    and `{root}/val/<wnid>/<wnid>/*.JPEG`."""
    wnid = tdata.imagenet_classes()[str(class_num)][0]
    rng = np.random.RandomState(class_num)
    for mode, ext in (("train", "jpeg"), ("val", "JPEG")):
        d = os.path.join(root, mode, wnid, wnid)
        os.makedirs(d, exist_ok=True)
        for i, (w, h) in enumerate(sizes):
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
                os.path.join(d, f"{i}.{ext}"))
    return wnid


def _read_all(ds, seed):
    random.seed(seed)
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("crop", ["random", "center", "random_flip"])
def test_imagenet_reader_matches_the_jax_reader(tmp_path, crop):
    """`get_dataset("IMAGENET", ...)` and `ImageNetDataset` read the same
    files in the same order, and with the same `random.seed` give the same
    random crops (and flips) bit for bit; the center crop too."""
    _write_imagenet(str(tmp_path))
    assert tdata.imagenet_classes() == jdata.imagenet_classes()
    if crop == "random":
        paths = {"IMAGENET": str(tmp_path)}
        got = tdata.get_dataset("IMAGENET", paths, category="IMAGENET", image_size=32,
                                target_class_num=CLASS)
        want = jdata.get_dataset("IMAGENET", paths, category="IMAGENET", image_size=32,
                                 target_class_num=CLASS)
    else:
        kw = dict(class_num=CLASS, image_size=32, random_crop=crop != "center",
                  random_flip=crop == "random_flip")
        got = [tdata.ImageNetDataset(str(tmp_path), m, **kw) for m in ("train", "val")]
        want = [jdata.ImageNetDataset(str(tmp_path), m, **kw) for m in ("train", "val")]
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3 and g.paths == w.paths
        a, b = _read_all(g, 5), _read_all(w, 5)
        for x, y in zip(a, b):
            assert x.shape == (32, 32, 3) and x.dtype == np.float32
            np.testing.assert_array_equal(x, y)
        if crop != "center":  # another seed, other crops
            assert any(not np.array_equal(x, y) for x, y in zip(a, _read_all(g, 6)))


def test_imagenet_reader_without_a_class_raises_as_jax():
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="class_num is required"):
            mod.get_dataset("IMAGENET", {"IMAGENET": "/nonexistent"}, category="IMAGENET")


def test_pairs_cache_path_carries_the_class_name():
    for kw in ({}, {"class_name": "goldfish"}, {"class_name": "goldfish", "random_noise": True}):
        got = tpc.pairs_cache_path("c", "IMAGENET", "test", 999, 2, 40, **kw)
        assert got == jpc.pairs_cache_path("c", "IMAGENET", "test", 999, 2, 40, **kw)
    assert os.path.basename(got) == "IMAGENET_goldfish_test_random_noise_nim2_ninv40_pairs"


# ---------------------------------------------------------------------------
# the CLI: --target_class_num serving and training, against the JAX CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The tiny IMAGENET yml, three images of class 1 per split, the
    perturbed class-conditional UNet saved WITHOUT `label_emb.weight` (the
    released unconditional checkpoint's layout) and an OpenAI-flavor Δ
    checkpoint."""
    ws = tmp_path_factory.mktemp("imagenet_ws")
    _write_imagenet(str(ws / "imagenet"), sizes=((40, 36), (64, 48), (33, 50)))
    with open(ws / "imagenet_tiny.yml", "w") as f:
        yaml.safe_dump(IMAGENET_TINY_CONFIG, f)
    spec = spec_from_config(IMAGENET_TINY_CONFIG)
    sd = spec.state_dict_from_jax(perturbed(spec.init(hostrng.PRNGKey(5))))
    del sd["label_emb.weight"]
    torch.save(sd, ws / "imagenet_uncond.pt")
    os.makedirs(ws / "checkpoint")
    jckpt.save_delta_checkpoint(
        str(ws / "checkpoint" / "golden_LC_IMAGENET_t999_ninv4_ngen4_0.pth"),
        blocks=[jdelta.delta_block_init(hostrng.PRNGKey(123), 64, 128, flavor="openai")],
        flavor="openai")
    torch.save(pm.CLIP(CLIP_CFG, seed=1).state_dict(), ws / "clip_tiny.pt")
    return ws


@pytest.fixture
def imagenet_paths(workspace):
    """Both packages' IMAGENET root pointed at the workspace."""
    with mock.patch.dict(T_PATHS, {"IMAGENET": str(workspace / "imagenet")}), \
            mock.patch.dict(J_PATHS, {"IMAGENET": str(workspace / "imagenet")}):
        yield


def _argv(ws, work, *extra):
    from asyrp_official_tpu.utils.tinyws import tiny_base_argv

    return tiny_base_argv(str(ws / "imagenet_tiny.yml"), str(ws / "unused"), str(work),
                          str(work / "runs" / "exp"), bs_train=1, edit_attr=None,
                          extra=["--model_path", str(ws / "imagenet_uncond.pt"), *extra])


def _grids(work):
    out = {}
    for r, _, fs in os.walk(work / "runs"):
        for f in sorted(fs):
            if f.endswith(".png"):
                out[os.path.relpath(os.path.join(r, f), work / "runs")] = np.asarray(
                    Image.open(os.path.join(r, f))).astype(np.int16)
    return out


def _both_clis(ws, name, extra, serve: bool):
    """Each CLI in a work dir of its own; a serving run reads the golden Δ
    checkpoint (a training run writes its own)."""
    from asyrp_official_torch.cli.main import main as port_main
    from asyrp_official_tpu.cli.main import main as jax_main

    works = {}
    for pkg, main, more in (("jax", jax_main, ()), ("port", port_main, ("--device", "cpu"))):
        work = ws / f"{name}_{pkg}"
        os.makedirs(work)
        if serve:
            os.symlink(ws / "checkpoint", work / "checkpoint")
        assert main(_argv(ws, work, *extra, *more)) == 0, pkg
        works[pkg] = work
    return works


def test_cli_serving_target_class_matches_the_jax_cli(workspace, imagenet_paths):
    """`--run_test --target_class_num 1` on imagenet.yml's tiny twin, from a
    `.pt` without `label_emb`: the same grids as the JAX CLI within one
    uint8 level, both latent caches named by the class."""
    works = _both_clis(workspace, "serve", [
        "--run_test", "--train_delta_block", "--load_from_checkpoint", "golden", "--do_train",
        "0", "--save_x_origin", "--target_class_num", str(CLASS)], serve=True)
    caches = [sorted(os.listdir(w / "precomputed")) for w in works.values()]
    assert caches[0] == caches[1] and len(caches[0]) == 1, caches
    assert caches[0][0].startswith("IMAGENET_goldfish_test_t999_"), caches
    want, got = _grids(works["jax"]), _grids(works["port"])
    assert sorted(want) == sorted(got) and len(got) == 2, (sorted(want), sorted(got))
    for k in got:
        assert np.abs(want[k] - got[k]).max() <= 1, k
        assert got[k].shape == (2 * 33 + 1, 34, 3)
        assert np.abs(got[k][1:33] - got[k][34:66]).max() > 0  # the edit moved the image


def test_cli_training_target_class_matches_the_jax_cli(workspace, imagenet_paths):
    """`--run_train --train_delta_block --target_class_num 1` (2 images, 2
    iterations, the L1 and CLIP terms, `--do_test` grids): the trained
    blocks within 1e-4 of scale of the JAX CLI's (their update within
    1e-3), every grid within one uint8 level, the caches named by the
    class."""
    works = _both_clis(workspace, "train", [
        "--run_train", "--train_delta_block", "--target_class_num", str(CLASS), "--n_iter", "2",
        "--do_test", "1", "--save_x_origin", "--edit_attr", "dog_smiling", "--clip_ckpt",
        str(workspace / "clip_tiny.pt"), "--clip_loss_w", "1"], serve=False)
    name = "exp_LC_IMAGENET_t999_ninv4_ngen4_1.pth"
    (jb,), (tb,) = (tckpt.load_delta_checkpoint(str(w / "checkpoint" / name))["blocks"]
                    for w in (works["jax"], works["port"]))
    init = jdelta.delta_block_init(hostrng.PRNGKey(1234), 64, 128, flavor="openai")
    for g in init:
        for k in init[g]:
            close_to_scale(jb[g][k], tb[g][k], f"trained {g}/{k}")
            assert np.abs(tb[g][k] - init[g][k]).max() > 0
            close_to_scale(jb[g][k] - init[g][k], tb[g][k] - init[g][k], f"update {g}/{k}",
                           bound=1e-3)
    caches = [sorted(os.listdir(w / "precomputed")) for w in works.values()]
    assert caches[0] == caches[1] and len(caches[0]) == 2, caches
    assert [c[:len("IMAGENET_goldfish_test_")] for c in caches[0]] == [
        "IMAGENET_goldfish_test_", "IMAGENET_goldfish_train"], caches
    want, got = _grids(works["jax"]), _grids(works["port"])
    assert sorted(want) == sorted(got) and len(got) >= 2, (sorted(want), sorted(got))
    for k in got:
        assert np.abs(want[k] - got[k]).max() <= 1, k


@pytest.mark.parametrize("mode", ["--lpips", "--run_fidelity"])
def test_stages_without_a_class_raise_on_imagenet_as_jax(workspace, imagenet_paths, tmp_path,
                                                         mode):
    """The LPIPS stage and the fidelity runbook read the dataset without
    `--target_class_num` in JAX: on IMAGENET both raise the reader's
    ValueError, and the CLIs exit 1; the port keeps that scope."""
    from asyrp_official_torch.cli.main import build_parser, load_config, main as port_main
    from asyrp_official_torch.runner import AsyrpRunner
    from asyrp_official_tpu.cli.main import main as jax_main

    npz = tiny_lpips_ckpt(tmp_path / "lpips.npz")
    extra = [mode, "--lpips_ckpt", npz, "--target_class_num", str(CLASS)]
    if mode == "--run_fidelity":
        extra += ["--train_delta_block", "--load_from_checkpoint", "golden"]
    os.symlink(workspace / "checkpoint", tmp_path / "checkpoint")
    assert jax_main(_argv(workspace, tmp_path, *extra)) == 1
    assert port_main(_argv(workspace, tmp_path, *extra, "--device", "cpu")) == 1
    args = build_parser().parse_args(_argv(workspace, tmp_path, *extra, "--device", "cpu"))
    from asyrp_official_torch.losses.lpips import LPIPS

    runner = AsyrpRunner(args, load_config(args.config), lpips_net=LPIPS().eval(),
                         work_dir=str(tmp_path))
    with pytest.raises(ValueError, match="class_num is required"):
        runner.run_lpips() if mode == "--lpips" else runner.run_fidelity()
