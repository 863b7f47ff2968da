"""The port's LPIPS net and the `--lpips` calibration stage against the JAX
package, float32 on the CPU:

  * `losses.lpips.LPIPS` (weights of the JAX init, bridged by
    `compat.from_jax.lpips_state_dict_from_jax`) against `lpips_jax.lpips`
    at 64² and 256², B = 2; identical inputs give exactly 0;
  * the port's `params_from_torch` gives the JAX tree;
  * `compute_lpips_distance` against the JAX stage on the tiny DDPM++ (the
    one of tests/test_lpips_metric_parity.py) and on the tiny learn_sigma
    OpenAI UNet (tests/test_torch_openai.py), 5 inversion steps, bs 2 over
    2 images and over 3 (a partial last batch): the curves' keys and values
    and the four tsvs (names, t column, values);
  * `--lpips` through the port's CLI on `--device cpu` against the JAX CLI:
    the same tsvs; the bad `--lpips_ckpt` npz raises the JAX CLI's
    ValueError.

Tolerance: `close_to_scale` 1e-4 (max error relative to the scale).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale, tiny_lpips_ckpt

from asyrp_official_torch.compat.from_jax import lpips_state_dict_from_jax
from asyrp_official_torch.core.schedule import make_schedule as p_make_schedule
from asyrp_official_torch.losses import lpips as plp
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import lpips_stage as pstage
from asyrp_official_torch.utils import hostrng
from asyrp_official_tpu.core.schedule import make_schedule as j_make_schedule
from asyrp_official_tpu.losses import lpips_jax
from asyrp_official_tpu.pipelines import lpips_stage as jstage
from asyrp_official_tpu.runner import spec_from_config as j_spec_from_config
from asyrp_official_tpu.utils.assets import load_lpips_tsv
from asyrp_official_tpu.utils.tinyws import TINY_DDPMPP_CONFIG, tiny_base_argv, write_tiny_workspace

from test_torch_openai import OPENAI_TINY_CONFIG, perturbed

KINDS = ("x", "x_std", "x0_t", "x0_t_std")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_lpips(tree) -> plp.LPIPS:
    net = plp.LPIPS()
    net.load_state_dict(lpips_state_dict_from_jax(tree))
    return net.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def nets():
    tree = jax.tree.map(np.asarray, lpips_jax.init(jax.random.PRNGKey(0)))
    return tree, port_lpips(tree)


@pytest.mark.parametrize("size", [64, 256])
def test_lpips_matches_jax(nets, size):
    tree, net = nets
    rng = np.random.RandomState(size)
    x0 = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    x1 = np.clip(x0 + 0.3 * rng.randn(*x0.shape), -1, 1).astype(np.float32)
    want = np.asarray(lpips_jax.lpips(tree, jnp.asarray(x0), jnp.asarray(x1)))
    with torch.no_grad():
        got = net(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x0, x1))).numpy()
    assert got.shape == (2,) and want.min() > 0
    close_to_scale(want, got, f"lpips {size}")
    with torch.no_grad():
        same = net(*(torch.from_numpy(x0).permute(0, 3, 1, 2),) * 2)
    assert torch.equal(same, torch.zeros(2))


def test_params_from_torch_gives_the_jax_tree():
    rng = np.random.RandomState(3)
    alex_sd, cin = {}, 3
    for j, (cout, k, _, _) in zip([0, 3, 6, 8, 10], plp.ALEX_CONVS):
        alex_sd[f"features.{j}.weight"] = rng.randn(cout, cin, k, k).astype(np.float32)
        alex_sd[f"features.{j}.bias"] = rng.randn(cout).astype(np.float32)
        cin = cout
    lin_sd = {f"lin{i}.model.1.weight": rng.rand(1, c, 1, 1).astype(np.float32)
              for i, (c, *_) in enumerate(plp.ALEX_CONVS)}
    got, want = plp.params_from_torch(alex_sd, lin_sd), lpips_jax.params_from_torch(alex_sd, lin_sd)
    g, w = jax.tree_util.tree_flatten_with_path(got)[0], jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=str(p))


class _DS:
    def __init__(self, x0):
        self.x0 = x0

    def __len__(self):
        return len(self.x0)

    def __getitem__(self, i):
        return self.x0[i]


def _stage_models(family):
    if family == "ddpmpp":
        spec = spec_from_config(TINY_DDPMPP_CONFIG)
        jspec = j_spec_from_config(TINY_DDPMPP_CONFIG)
        tree = spec.init(hostrng.PRNGKey(0))
    else:
        spec = spec_from_config(OPENAI_TINY_CONFIG)
        jspec = j_spec_from_config(OPENAI_TINY_CONFIG)
        tree = perturbed(spec.init(hostrng.PRNGKey(5)))
    model = spec.build()
    model.load_state_dict(spec.state_dict_from_jax(tree))
    return spec, jspec, model.eval().requires_grad_(False), jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("family", ["ddpmpp", "openai"])
@pytest.mark.parametrize("n_img", [2, 3], ids=["full_batches", "partial_batch"])
def test_compute_lpips_distance_matches_jax(nets, tmp_path, family, n_img):
    tree, net = nets
    spec, jspec, model, params = _stage_models(family)
    assert spec.learn_sigma == (family == "openai")
    x0 = np.random.RandomState(2).uniform(-1, 1, (n_img, 32, 32, 3)).astype(np.float32)
    kw = dict(n_img=n_img, n_inv_step=5, t_0=999, batch_size=2, dataset_name="tiny")
    want = jstage.compute_lpips_distance(jspec, params, j_make_schedule(), _DS(x0), tree,
                                         out_dir=str(tmp_path / "jax"), **kw)
    got = pstage.compute_lpips_distance(spec, model, p_make_schedule(), _DS(x0), net,
                                        out_dir=str(tmp_path / "port"), **kw)
    assert sorted(got) == sorted(want) == sorted(KINDS)
    for kind in KINDS:
        assert list(got[kind]) == list(want[kind]) == [249, 499, 749, 999], kind
        close_to_scale(np.asarray(list(want[kind].values())),
                       np.asarray(list(got[kind].values())), kind)
    assert min(want["x0_t"].values()) > 0 and max(want["x0_t_std"].values()) > 0
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        w, g = (load_lpips_tsv(str(tmp_path / side / name)) for side in ("jax", "port"))
        assert list(g) == list(w), name
        close_to_scale(np.asarray(list(w.values())), np.asarray(list(g.values())), name)


def test_lpips_cli_matches_the_jax_cli(tmp_path):
    from asyrp_official_torch.cli.main import main as p_main
    from asyrp_official_tpu.cli.main import main as j_main

    cfg, imgs = write_tiny_workspace(str(tmp_path))
    ckpt = tiny_lpips_ckpt(tmp_path / "lpips.npz")
    tsvs = {}
    for side, main, extra in (("jax", j_main, []), ("port", p_main, ["--device", "cpu"])):
        ws = tmp_path / side
        argv = tiny_base_argv(cfg, imgs, str(ws), str(ws / "runs" / "calib"), n_img=2,
                              bs_train=2, extra=["--lpips", "--lpips_ckpt", ckpt] + extra)
        assert main(argv) == 0, side
        tsvs[side] = {f: load_lpips_tsv(str(ws / "utils" / f))
                      for f in sorted(os.listdir(ws / "utils"))}
    # the reference's n_train_img + 1 images (3, in a full and a partial batch)
    assert list(tsvs["port"]) == [f"celeba_LPIPS_distance_{k}.tsv" for k in sorted(KINDS)]
    assert list(tsvs["port"]) == list(tsvs["jax"])
    for name, w in tsvs["jax"].items():
        g = tsvs["port"][name]
        assert list(g) == list(w) == [333, 666, 999], name
        close_to_scale(np.asarray(list(w.values())), np.asarray(list(g.values())), name)


def test_bad_lpips_ckpt_is_loud(tmp_path):
    from asyrp_official_torch.cli.main import build_contexts, build_parser

    bad = tmp_path / "lpips.npz"
    np.savez(bad, weights=np.zeros(3))
    args = build_parser().parse_args(["--config", "celeba.yml", "--lpips_ckpt", str(bad)])
    with pytest.raises(ValueError, match="'params' entry"):
        build_contexts(args, torch.device("cpu"))
