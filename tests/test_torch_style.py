"""DiffStyle in the port (`pipelines/style_transfer.py`, `engine.make_invert_with_h`,
`precompute.precompute_with_h`, `runner.run_style_transfer`, `--diff_style`)
against the JAX package, float32 on the CPU: the tiny DDPM++ config (ch 32,
mult (1, 2), 32^2) and the tiny OpenAI config of `tests/test_torch_openai.py`
(learn_sigma, 4 heads; perturbed so that eps is not zero), weights from the
JAX init through `compat/from_jax.py`, inputs from a numpy seed.

Tolerance: `close_to_scale` 1e-4 (max error relative to the array's scale);
the CLI's PNGs within 1/255 per pixel after quantization.
"""
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from parity_utils import close_to_scale
from test_torch_openai import OPENAI_TINY_CONFIG, perturbed

from asyrp_official_torch import runner as trunner
from asyrp_official_torch.cli.main import main as port_cli
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import engine as tengine, precompute as tpc
from asyrp_official_torch.pipelines import style_transfer as tst
from asyrp_official_tpu import runner as jrunner
from asyrp_official_tpu.cli.main import main as jax_cli
from asyrp_official_tpu.core.schedule import make_schedule, uniform_seq
from asyrp_official_tpu.pipelines import engine as jengine, precompute as jpc
from asyrp_official_tpu.pipelines import style_transfer as jst
from asyrp_official_tpu.runner import spec_from_config as j_spec_from_config
from asyrp_official_tpu.utils import hostrng
from asyrp_official_tpu.utils.tinyws import TINY_DDPMPP_CONFIG

SCHED = make_schedule()
CONFIGS = {"ddpmpp": TINY_DDPMPP_CONFIG, "openai": OPENAI_TINY_CONFIG}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def families():
    """{family: (port spec, port model, JAX spec, JAX params)}."""
    out = {}
    for fam, config in CONFIGS.items():
        spec = spec_from_config(config)
        params = spec.init(hostrng.PRNGKey(0))
        if fam == "openai":
            params = perturbed(params)
        model = spec.build()
        model.load_state_dict(spec.state_dict_from_jax(params))
        out[fam] = (spec, model.eval().requires_grad_(False), j_spec_from_config(config), params)
    return out


def _x(seed=0, b=2):
    return np.random.RandomState(seed).uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("family", ["ddpmpp", "openai"])
def test_invert_with_h_matches_jax(families, family):
    spec, model, jspec, params = families[family]
    seq = uniform_seq(5, 999)
    x0 = _x()
    want_lat, want_h = jengine.make_invert_with_h(jspec, SCHED, seq)(params, jnp.asarray(x0))
    got_lat, got_h = tengine.make_invert_with_h(spec, SCHED, seq)(model, torch.from_numpy(x0))
    hw, ch = spec.bottleneck_hw, spec.bottleneck_ch
    assert got_h.shape == (len(seq) - 1, 2, ch, hw, hw) and got_h.dtype == torch.float32
    close_to_scale(np.asarray(want_lat), got_lat.numpy(), "x_lat")
    close_to_scale(np.asarray(want_h), got_h.permute(0, 1, 3, 4, 2).numpy(), "h_traj")
    # the inversion alone is make_invert's
    lat, _ = tengine.make_invert(spec, SCHED, seq)(model, torch.from_numpy(x0))
    assert torch.equal(lat, got_lat)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_precompute_with_h_cache_is_read_across_packages(families, tmp_path, writer):
    spec, model, jspec, params = families["ddpmpp"]
    x0 = _x(1, b=1)
    kw = dict(n_inv_step=4, cache_key="img0", category="CUSTOM", cache_dir=str(tmp_path))
    port = lambda: tpc.precompute_with_h(spec, model, SCHED, x0, device=torch.device("cpu"), **kw)
    jax_ = lambda: jpc.precompute_with_h(jspec, params, SCHED, x0, **kw)
    first, second = (port, jax_) if writer == "port" else (jax_, port)
    written = first()
    assert os.listdir(tmp_path) == ["CUSTOM_inv4_img0.npz"]
    recompute = AssertionError("recomputed")
    with mock.patch.object(jengine, "make_invert_with_h", side_effect=recompute), \
            mock.patch.object(tengine, "make_invert_with_h", side_effect=recompute):
        read = second()
    assert sorted(read) == sorted(written) == ["h_times", "h_traj", "x0", "x_lat"]
    for k in written:
        np.testing.assert_array_equal(np.asarray(read[k]), np.asarray(written[k]), err_msg=k)
    assert read["h_traj"].shape == (3, 1, 16, 16, 64)  # NHWC on disk
    np.testing.assert_array_equal(read["h_times"], uniform_seq(4, 999)[:-1])
    # and the other package's fresh computation agrees with what was cached
    os.remove(tmp_path / "CUSTOM_inv4_img0.npz")
    fresh = second()
    for k in ("x_lat", "h_traj"):
        close_to_scale(np.asarray(written[k]), np.asarray(fresh[k]), k)


ST_KW = dict(n_inv_step=6, n_gen_step=5, t_edit=400, hs_coeff=0.8, content_replace_step=50,
             dt_lambda=0.9985, dt_end=950)


@pytest.mark.parametrize("use_mask", [False, True])
def test_style_transfer_generate_matches_jax(families, use_mask):
    spec, model, jspec, params = families["ddpmpp"]
    content, style = _x(2), _x(3, b=1)
    j = jst.make_style_transfer(jspec, SCHED, use_mask=use_mask, **ST_KW)
    want_lat = j.invert_content(params, jnp.asarray(content))
    want_h = j.invert_style(params, jnp.asarray(style))
    want = j.generate(params, want_lat, want_h)
    t = tst.make_style_transfer(spec, SCHED, use_mask=use_mask, **ST_KW)
    got_lat = t.invert_content(model, torch.from_numpy(content))
    got_h = t.invert_style(model, torch.from_numpy(style))
    got = t.generate(model, got_lat, got_h)
    close_to_scale(np.asarray(want_lat), got_lat.numpy(), "content latent")
    close_to_scale(np.asarray(want), got.numpy(), "stylized")
    # the injection moved the output away from the un-edited reconstruction
    recon, _ = tengine.make_generate(spec, SCHED, uniform_seq(ST_KW["n_gen_step"], 999))(
        model, got_lat)
    assert float((got - recon).abs().max()) > 1e-3 * float(recon.abs().max())
    # the one-shot wrapper gives the same result
    one, lat = tst.style_transfer(spec, model, SCHED, torch.from_numpy(content),
                                  torch.from_numpy(style), use_mask=use_mask, **ST_KW)
    assert torch.equal(one, got) and torch.equal(lat, got_lat)


@pytest.mark.parametrize("n_inv,n_gen,t_edit,replace", [
    (6, 5, 400, 50), (40, 13, 513, 50), (7, 40, 300, 600), (40, 40, 513, 700), (10, 1000, 0, 0)])
def test_row_map_matches_jax(families, n_inv, n_gen, t_edit, replace):
    spec, _, jspec, _ = families["ddpmpp"]
    kw = dict(n_inv_step=n_inv, n_gen_step=n_gen, t_edit=t_edit, content_replace_step=replace)
    j = jst.StyleTransfer(jspec, SCHED, **kw)
    t = tst.StyleTransfer(spec, SCHED, **kw)
    assert t.row_idx == j._row_idx
    gate = max(t_edit, replace)
    assert len(t.row_idx) == sum(s >= gate for s in uniform_seq(n_gen, 999))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_no_generation_step_at_the_gate_raises(families, pkg):
    spec, _, jspec, _ = families["ddpmpp"]
    cls, s = (tst.StyleTransfer, spec) if pkg == "port" else (jst.StyleTransfer, jspec)
    with pytest.raises(ValueError, match="nothing to inject"):
        cls(s, SCHED, n_inv_step=4, n_gen_step=4, t_edit=1000)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_style_batch_other_than_one_is_refused(families, pkg):
    spec, model, jspec, params = families["ddpmpp"]
    content, style = _x(4, b=1), _x(5, b=2)
    with pytest.raises(ValueError, match="style batch must be 1"):
        if pkg == "port":
            tst.style_transfer(spec, model, SCHED, torch.from_numpy(content),
                               torch.from_numpy(style))
        else:
            jst.style_transfer(jspec, params, SCHED, jnp.asarray(content), jnp.asarray(style))


def _style_workspace(root):
    rng = np.random.RandomState(0)
    for sub, n in (("imgs", 2), ("contents", 2), ("styles", 1)):
        os.makedirs(root / sub)
        for i in range(n):
            Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(
                root / sub / f"{i}.png")
    with open(root / "tiny.yml", "w") as f:
        yaml.safe_dump(TINY_DDPMPP_CONFIG, f)


def _style_argv(root, pkg, extra=()):
    return ["--config", str(root / "tiny.yml"), "--exp", str(root / "runs" / pkg),
            "--diff_style", "--allow_random_weights", "--work_dir", str(root),
            "--content_dir", str(root / "contents"), "--style_dir", str(root / "styles"),
            "--save_dir", str(root / f"styled_{pkg}"), "--n_inv_step", "5",
            "--n_gen_step", "6", "--user_defined_t_edit", "400",
            "--user_defined_t_addnoise", "100", "--hs_coeff", "0.7", "--seed", "3", "--ni",
            *extra]


def test_diff_style_cli_writes_the_jax_clis_files(tmp_path):
    _style_workspace(tmp_path)
    assert jax_cli(_style_argv(tmp_path, "jax")) == 0
    assert port_cli(_style_argv(tmp_path, "port", ["--device", "cpu"])) == 0
    names = sorted(os.listdir(tmp_path / "styled_jax"))
    assert names == ["content0_style0.png", "content1_style0.png"]
    assert sorted(os.listdir(tmp_path / "styled_port")) == names
    for n in names:
        want = np.asarray(Image.open(tmp_path / "styled_jax" / n), np.int16)
        got = np.asarray(Image.open(tmp_path / "styled_port" / n), np.int16)
        assert want.shape == got.shape == (32, 32, 3)
        assert np.abs(want - got).max() <= 1, n
        assert want.std() > 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_run_test_takes_precedence_over_diff_style(tmp_path, pkg):
    """JAX dispatches run_train > run_test > lpips > run_fidelity >
    diff_style: `--run_test --diff_style` serves."""
    _style_workspace(tmp_path)
    runner_mod, cli = (trunner, port_cli) if pkg == "port" else (jrunner, jax_cli)
    calls = []
    with mock.patch.object(runner_mod.AsyrpRunner, "run_test",
                           lambda self: calls.append("run_test")), \
            mock.patch.object(runner_mod.AsyrpRunner, "run_style_transfer",
                              lambda self: calls.append("run_style_transfer")):
        extra = ["--run_test"] + (["--device", "cpu"] if pkg == "port" else [])
        assert cli(_style_argv(tmp_path, pkg, extra)) == 0
        assert cli(_style_argv(tmp_path, pkg, extra[1:])) == 0
    assert calls == ["run_test", "run_style_transfer"]
