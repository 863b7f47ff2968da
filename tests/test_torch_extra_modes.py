"""The edit modes no CLI path reaches, in the port (`models/delta.py`: the
`global` mode with `DeltaBlockGlobal` and the `interp_batch` mode;
`pipelines/engine.py` `make_image_noise_generate`) against the JAX package,
float32 on the CPU: the tiny DDPM++ config (ch 32, mult (1, 2), 32^2; h is
[B, 64, 16, 16]) and the tiny OpenAI config of `tests/test_torch_openai.py`
(perturbed), weights from the JAX init through `compat/from_jax.py`, inputs
from a numpy seed.

Tolerance: `close_to_scale` 1e-4 (max error relative to the array's scale);
the DeltaBlockGlobal init bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale
from test_torch_openai import OPENAI_TINY_CONFIG, perturbed

from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import engine as tengine
from asyrp_official_tpu.core.schedule import make_schedule, uniform_seq
from asyrp_official_tpu.models import delta as jdelta
from asyrp_official_tpu.pipelines import engine as jengine
from asyrp_official_tpu.runner import spec_from_config as j_spec_from_config
from asyrp_official_tpu.utils import hostrng
from asyrp_official_tpu.utils.tinyws import TINY_DDPMPP_CONFIG

SCHED = make_schedule()
CONFIGS = {"ddpmpp": TINY_DDPMPP_CONFIG, "openai": OPENAI_TINY_CONFIG}
CLIP_CH = 32


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


def _global_block(spec, seed=4):
    hw, ch = spec.bottleneck_hw, spec.bottleneck_ch
    tree = jdelta.delta_block_global_init(hostrng.PRNGKey(seed), ch, spec.temb_ch, CLIP_CH, hw)
    return tree, tdelta.delta_block_global_from_tree(tree).eval()


def _x(seed=0, b=2):
    return np.random.RandomState(seed).uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)


def test_delta_block_global_init_is_bit_identical_to_jax(families):
    spec = families["ddpmpp"][0]
    hw, ch = spec.bottleneck_hw, spec.bottleneck_ch
    want = jdelta.delta_block_global_init(hostrng.PRNGKey(9), ch, spec.temb_ch, CLIP_CH, hw)
    got = tdelta.delta_block_global_init(hostrng.PRNGKey(9), ch, spec.temb_ch, CLIP_CH, hw)
    assert sorted(got) == sorted(want)
    for name in want:
        for leaf in want[name]:
            np.testing.assert_array_equal(got[name][leaf], np.asarray(want[name][leaf]),
                                          err_msg=f"{name}.{leaf}")
    block = tdelta.delta_block_global_from_tree(got)
    assert sum(p.numel() for p in block.parameters()) == sum(
        np.size(v) for p in want.values() for v in p.values())


@pytest.mark.parametrize("batch", [1, 3])
def test_delta_block_global_matches_jax(families, batch):
    spec = families["ddpmpp"][0]
    tree, block = _global_block(spec)
    rng = np.random.RandomState(batch)
    hw, ch = spec.bottleneck_hw, spec.bottleneck_ch
    h = rng.randn(batch, hw, hw, ch).astype(np.float32)
    temb = rng.randn(batch, spec.temb_ch).astype(np.float32)
    d = rng.randn(1, CLIP_CH).astype(np.float32)
    want = jdelta.delta_block_global_apply(tree, jnp.asarray(h), jnp.asarray(temb), d)
    with torch.no_grad():
        got = block(torch.from_numpy(h).permute(0, 3, 1, 2), torch.from_numpy(temb),
                    torch.from_numpy(d))
    close_to_scale(np.asarray(want), got.permute(0, 2, 3, 1).numpy(), "global Δh")
    # temb is an input: another timestep embedding gives another Δh
    with torch.no_grad():
        other = block(torch.from_numpy(h).permute(0, 3, 1, 2), torch.from_numpy(temb) + 1.0,
                      torch.from_numpy(d))
    assert float((other - got).abs().max()) > 1e-3 * float(got.abs().max())


def _edits(spec, mode, batch):
    """The JAX and port EditStates of a `global` or `interp_batch` edit."""
    if mode == "global":
        tree, block = _global_block(spec)
        d = np.random.RandomState(7).randn(1, CLIP_CH).astype(np.float32)
        return (jdelta.EditState(mode="global", blocks=(tree,), clip_direction=jnp.asarray(d)),
                tdelta.EditState(mode="global", blocks=(block,),
                                 clip_direction=torch.from_numpy(d)))
    alpha = np.linspace(0.0, 1.0, batch).astype(np.float32)
    return (jdelta.EditState(mode="interp_batch", alpha=jnp.asarray(alpha)),
            tdelta.EditState(mode="interp_batch", alpha=torch.from_numpy(alpha)))


@pytest.mark.parametrize("mode", ["global", "interp_batch"])
@pytest.mark.parametrize("family", ["ddpmpp", "openai"])
def test_edited_eval_matches_jax(families, family, mode):
    """One dual eval at batch 3 (eps, eps_mod, Δh, h) against the JAX apply."""
    spec, model, jspec, params = families[family]
    jedit, tedit = _edits(spec, mode, 3)
    x, t = _x(1, b=3), np.array([700.0, 500.0, 300.0], np.float32)
    want = jax.jit(lambda x, t: jspec.apply(params, x, t, edit=jedit))(jnp.asarray(x),
                                                                       jnp.asarray(t))
    with torch.no_grad():
        got = spec.apply(model, torch.from_numpy(x), torch.from_numpy(t), edit=tedit)
    for name, w, g in zip(("eps", "eps_mod", "delta_h", "h"), want, got):
        assert (w is None) == (g is None), name
        if w is not None:
            close_to_scale(np.asarray(w), g.numpy(), f"{mode} {name}")
    assert float((got[1] - got[0]).abs().max()) > 1e-3 * float(got[0].abs().max())


def test_interp_batch_end_points_and_midpoint(families):
    spec = families["ddpmpp"][0]
    rng = np.random.RandomState(3)
    hw, ch = spec.bottleneck_hw, spec.bottleneck_ch
    h = rng.randn(3, hw, hw, ch).astype(np.float32)
    alpha = np.array([0.0, 0.5, 1.0], np.float32)
    want, want_d = jdelta.apply_edit(jdelta.EditState(mode="interp_batch",
                                                      alpha=jnp.asarray(alpha)),
                                     jnp.asarray(h), None)
    got, got_d = tdelta.apply_edit(tdelta.EditState(mode="interp_batch",
                                                    alpha=torch.from_numpy(alpha)),
                                   torch.from_numpy(h).permute(0, 3, 1, 2), None)
    assert want_d is None and got_d is None
    got = got.permute(0, 2, 3, 1).numpy()
    close_to_scale(np.asarray(want), got, "interp_batch h2")
    np.testing.assert_array_equal(got[0], h[0])
    np.testing.assert_array_equal(got[2], h[2])
    np.testing.assert_allclose(got[1], 0.5 * (h[0] + h[2]), rtol=1e-6, atol=1e-6)
    # the gate: off, h2 is h
    off, _ = tdelta.apply_edit(tdelta.EditState(mode="interp_batch", alpha=torch.from_numpy(alpha),
                                                use_delta=0.0),
                               torch.from_numpy(h).permute(0, 3, 1, 2), None)
    np.testing.assert_array_equal(off.permute(0, 2, 3, 1).numpy(), h)


def test_unknown_edit_mode_raises(families):
    h = torch.zeros(1, 64, 16, 16)
    with pytest.raises(ValueError, match="unknown edit mode"):
        tdelta.apply_edit(tdelta.EditState(mode="warp"), h, None)


@pytest.mark.parametrize("family", ["ddpmpp", "openai"])
def test_image_noise_generate_and_its_gradient_match_jax(families, family):
    """The output against the JAX engine's, and the gradient w.r.t.
    `noise_param` against `jax.grad`. JAX cannot differentiate the OpenAI
    UNet's chain ("Linearization failed", ROADMAP Queue 3): there the
    gradient is held to central differences of the JAX forward along two
    random directions (step 1e-2; tolerance 1e-3 of the derivative)."""
    spec, model, jspec, params = families[family]
    seq = uniform_seq(4, 999)
    rng = np.random.RandomState(11)
    x_lat = rng.randn(1, 32, 32, 3).astype(np.float32)
    noise = (0.1 * rng.randn(32, 32, 3)).astype(np.float32)
    w = rng.randn(1, 32, 32, 3).astype(np.float32)
    kw = dict(t_edit=500, coeff=0.5)
    jrun = jengine.make_image_noise_generate(jspec, SCHED, seq, **kw)

    def jloss(n):
        return jnp.sum(jrun(params, n, jnp.asarray(x_lat), jax.random.PRNGKey(0))[0] * w)

    want, _ = jrun(params, jnp.asarray(noise), jnp.asarray(x_lat), jax.random.PRNGKey(0))
    trun = tengine.make_image_noise_generate(spec, SCHED, seq, **kw)
    n_t = torch.from_numpy(noise).requires_grad_(True)
    got, _ = trun(model, n_t, torch.from_numpy(x_lat))
    (got_g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), n_t)
    close_to_scale(np.asarray(want), got.detach().numpy(), "x")
    assert float(got_g.abs().max()) > 0
    if family == "ddpmpp":
        close_to_scale(np.asarray(jax.grad(jloss)(jnp.asarray(noise))), got_g.numpy(),
                       "d x / d noise_param")
    else:
        for v in rng.randn(2, 32, 32, 3).astype(np.float32):
            fd = (float(jloss(noise + 1e-2 * v)) - float(jloss(noise - 1e-2 * v))) / 2e-2
            ad = float((got_g * torch.from_numpy(v)).sum())
            assert abs(fd - ad) <= 1e-3 * abs(ad), (fd, ad)
    # the noise moved the output, and below t_edit it is not injected
    plain, _ = tengine.make_generate(spec, SCHED, seq)(model, torch.from_numpy(x_lat))
    assert float((got.detach() - plain).abs().max()) > 1e-3 * float(plain.abs().max())
    none, _ = tengine.make_image_noise_generate(spec, SCHED, seq, t_edit=1000)(
        model, n_t, torch.from_numpy(x_lat))
    close_to_scale(plain.numpy(), none.detach().numpy(), "t_edit above every step")
