"""The port's engines (pipelines/engine.py, core/sampler.py) against the JAX
engines on 4- and 8-step chains of the tiny DDPM++ config, float32 on the
CPU. Eta noise cannot match across frameworks, so the JAX draws
(`jax.random.normal(fold_in(rng, step))`) are fed to the port through
`noise_fn`.

Tolerance: `close_to_scale` 1e-4 (max error relative to the array's scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.compat.from_jax import (
    ddpmpp_state_dict_from_jax,
    delta_block_state_dict_from_jax,
)
from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import engine as tengine
from asyrp_official_tpu.core.schedule import make_schedule, uniform_seq
from asyrp_official_tpu.core.steptable import generation_table
from asyrp_official_tpu.models import ddpmpp as jddpmpp
from asyrp_official_tpu.models import delta as jdelta
from asyrp_official_tpu.models.registry import ModelSpec as JModelSpec
from asyrp_official_tpu.pipelines import engine as jengine
from asyrp_official_tpu.utils import hostrng
from asyrp_official_tpu.utils.tinyws import TINY_DDPMPP_CONFIG

SPEC = spec_from_config(TINY_DDPMPP_CONFIG)
CFG = SPEC.config
JCFG = jddpmpp.DDPMppConfig(ch=CFG.ch, ch_mult=CFG.ch_mult, num_res_blocks=CFG.num_res_blocks,
                            attn_resolutions=CFG.attn_resolutions, resolution=CFG.resolution)
JSPEC = JModelSpec("ddpmpp", JCFG, False, "ddpm")
SCHED = make_schedule()
T_EDIT, T_ADDNOISE = 500, 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool on top of them oversubscribes the CPU, and these small
    convolutions then spend their time synchronising threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jparams = jddpmpp.init(hostrng.PRNGKey(0), JCFG)
    model = SPEC.build()
    model.load_state_dict(ddpmpp_state_dict_from_jax(jparams))
    jblock = jdelta.delta_block_init(hostrng.PRNGKey(3), CFG.bottleneck_ch, CFG.temb_ch)
    tblock = tdelta.DeltaBlock(CFG.bottleneck_ch, CFG.temb_ch)
    tblock.load_state_dict(delta_block_state_dict_from_jax(jblock))
    coeff = np.array([1.0, 1.5], np.float32)
    jedit = jdelta.EditState(blocks=(jblock,), hs_coeff=jnp.asarray(coeff))
    tedit = tdelta.EditState(blocks=(tblock.eval(),), hs_coeff=torch.from_numpy(coeff))
    return jparams, model.eval(), jedit, tedit


def _x(seed=0, b=2):
    return np.random.RandomState(seed).randn(b, 32, 32, 3).astype(np.float32)


def _jax_noise(rng):
    """The JAX sampler's draw for a step, as the port's noise_fn."""
    return lambda step, shape: np.array(
        jax.random.normal(jax.random.fold_in(rng, step), shape, jnp.float32))


@pytest.mark.parametrize("n_steps", [4])
def test_invert_matches_jax(weights, n_steps):
    jparams, model, _, _ = weights
    seq = uniform_seq(n_steps, 999)
    x0 = _x()
    want, jys = jengine.make_invert(JSPEC, SCHED, seq, collect=("x",))(jparams, jnp.asarray(x0))
    got, tys = tengine.make_invert(SPEC, SCHED, seq, collect=("x",))(model, torch.from_numpy(x0))
    close_to_scale(np.asarray(want), got.numpy(), "x_lat")
    close_to_scale(np.asarray(jys["x"]), tys["x"].numpy(), "trajectory")
    assert tys["x"].shape == (n_steps - 1, 2, 32, 32, 3)


def test_generate_with_noise_matches_jax(weights):
    jparams, model, _, _ = weights
    seq = uniform_seq(8, 999)
    x = _x(1)
    rng = jax.random.PRNGKey(11)
    want, _ = jengine.make_generate(JSPEC, SCHED, seq, t_addnoise=T_ADDNOISE)(jparams, jnp.asarray(x), rng)
    got, _ = tengine.make_generate(SPEC, SCHED, seq, t_addnoise=T_ADDNOISE)(
        model, torch.from_numpy(x), noise_fn=_jax_noise(rng))
    close_to_scale(np.asarray(want), got.numpy(), "x_gen")


@pytest.mark.parametrize("n_steps", [4, 8])
def test_edit_generate_two_segment_split_matches_jax(weights, n_steps):
    jparams, model, jedit, tedit = weights
    seq = uniform_seq(n_steps, 999)
    table = generation_table(seq, t_edit=T_EDIT, t_addnoise=T_ADDNOISE)
    k = table.edit_prefix_len()
    assert 0 < k < table.num_steps  # both segments run
    x = _x(2)
    rng = jax.random.PRNGKey(7)
    collect = ("x", "x0_t")
    want, jys = jengine.make_edit_generate(JSPEC, SCHED, seq, t_edit=T_EDIT, t_addnoise=T_ADDNOISE,
                                           collect=collect)(jparams, jedit, jnp.asarray(x), rng)
    run = tengine.make_edit_generate(SPEC, SCHED, seq, t_edit=T_EDIT, t_addnoise=T_ADDNOISE,
                                     collect=collect)
    got, tys = run(model, tedit, torch.from_numpy(x), noise_fn=_jax_noise(rng))
    close_to_scale(np.asarray(want), got.numpy(), "x_edit")
    for key in collect:
        assert tys[key].shape == (n_steps, 2, 32, 32, 3)
        close_to_scale(np.asarray(jys[key]), tys[key].numpy(), key)


def test_edit_generate_every_step_edited(weights):
    """t_edit = 0: the gate covers the whole table (one segment)."""
    jparams, model, jedit, tedit = weights
    seq = uniform_seq(4, 999)
    x = _x(3)
    want, _ = jengine.make_edit_generate(JSPEC, SCHED, seq, t_edit=0)(
        jparams, jedit, jnp.asarray(x), None)
    got, _ = tengine.make_edit_generate(SPEC, SCHED, seq, t_edit=0)(model, tedit, torch.from_numpy(x))
    close_to_scale(np.asarray(want), got.numpy(), "x_edit")


def test_invert_edit_matches_jax(weights):
    jparams, model, jedit, tedit = weights
    seq = uniform_seq(6, 999)
    x0 = _x(4, b=1)
    rng = jax.random.PRNGKey(5)
    want = jengine.make_invert_edit(JSPEC, SCHED, seq, seq, t_edit=T_EDIT, t_addnoise=T_ADDNOISE)(
        jparams, jedit, jnp.asarray(x0), rng)
    got = tengine.make_invert_edit(SPEC, SCHED, seq, seq, t_edit=T_EDIT, t_addnoise=T_ADDNOISE)(
        model, tedit, torch.from_numpy(x0), noise_fn=_jax_noise(rng))
    close_to_scale(np.asarray(want), got.numpy(), "x_edit")


def test_generator_noise_is_split_invariant(weights):
    """The two-segment chain draws the same eta noise as one segment: a
    seeded generator gives the split chain and a one-loop chain (every step
    through the edited callback, gate off below t_edit) the same result."""
    from asyrp_official_torch.core.sampler import sample_chain
    from asyrp_official_torch.pipelines.engine import _edited_eps

    _, model, _, tedit = weights
    seq = uniform_seq(6, 999)
    x = torch.from_numpy(_x(5))
    split, _ = tengine.make_edit_generate(SPEC, SCHED, seq, t_edit=T_EDIT, t_addnoise=T_ADDNOISE)(
        model, tedit, x, torch.Generator().manual_seed(3))
    table = generation_table(seq, t_edit=T_EDIT, t_addnoise=T_ADDNOISE)
    with torch.no_grad():
        whole, _ = sample_chain(_edited_eps(SPEC, model, tedit, torch.float32), SCHED,
                                table, x, torch.Generator().manual_seed(3))
    close_to_scale(whole.numpy(), split.numpy(), "split vs whole")


def test_stochastic_chain_without_noise_source_raises(weights):
    _, model, _, _ = weights
    gen = tengine.make_generate(SPEC, SCHED, uniform_seq(4, 999), t_addnoise=T_ADDNOISE)
    with pytest.raises(ValueError, match="generator"):
        gen(model, torch.from_numpy(_x()))


# ---------------------------------------------------------------------------
# the OpenAI family: learn_sigma (2C output channels), `sample_type` ddim and
# ddpm, on the tiny OpenAI config with perturbed weights (the seeded init's
# zero output layers redrawn: test_torch_openai.perturbed)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oai():
    from test_torch_openai import OPENAI_TINY_CONFIG, perturbed

    from asyrp_official_tpu.runner import spec_from_config as jspec_from_config

    spec, jspec = spec_from_config(OPENAI_TINY_CONFIG), jspec_from_config(OPENAI_TINY_CONFIG)
    assert spec.learn_sigma and jspec.learn_sigma
    params = perturbed(spec.init(hostrng.PRNGKey(2)))
    model = spec.build()
    model.load_state_dict(spec.state_dict_from_jax(params))
    jblock = jdelta.delta_block_init(hostrng.PRNGKey(4), spec.bottleneck_ch, spec.temb_ch,
                                     flavor="openai")
    tblock = tdelta.delta_block_from_tree(jblock, spec.bottleneck_ch, spec.temb_ch, flavor="openai")
    coeff = np.array([1.0, 1.5], np.float32)
    jedit = jdelta.EditState(blocks=(jblock,), hs_coeff=jnp.asarray(coeff), flavor="openai")
    tedit = tdelta.EditState(blocks=(tblock.eval(),), hs_coeff=torch.from_numpy(coeff),
                             flavor="openai")
    return spec, jspec, jax.tree.map(jnp.asarray, params), model.eval(), jedit, tedit


def test_openai_invert_matches_jax(oai):
    spec, jspec, jparams, model, _, _ = oai
    seq = uniform_seq(4, 999)
    x0 = _x(6)
    want, _ = jengine.make_invert(jspec, SCHED, seq)(jparams, jnp.asarray(x0))
    got, _ = tengine.make_invert(spec, SCHED, seq)(model, torch.from_numpy(x0))
    close_to_scale(np.asarray(want), got.numpy(), "x_lat")
    assert got.shape == (2, 32, 32, 3)
    assert float((got - torch.from_numpy(x0)).std()) > 0.1  # eps is far from zero


@pytest.mark.parametrize("sample_type", ["ddim", "ddpm"])
def test_openai_generate_matches_jax(oai, sample_type):
    """The plain generation; "ddpm" draws noise at every step (the learned
    log-variance scales it), "ddim" only below t_addnoise."""
    spec, jspec, jparams, model, _, _ = oai
    seq = uniform_seq(6, 999)
    x = _x(7)
    rng = jax.random.PRNGKey(13)
    want, jys = jengine.make_generate(jspec, SCHED, seq, t_addnoise=T_ADDNOISE,
                                      sample_type=sample_type, collect=("x0_t",))(
        jparams, jnp.asarray(x), rng)
    draws = []
    noise = _jax_noise(rng)

    def noise_fn(step, shape):
        draws.append(step)
        return noise(step, shape)

    got, tys = tengine.make_generate(spec, SCHED, seq, t_addnoise=T_ADDNOISE,
                                     sample_type=sample_type, collect=("x0_t",))(
        model, torch.from_numpy(x), noise_fn=noise_fn)
    close_to_scale(np.asarray(want), got.numpy(), f"x_gen {sample_type}")
    close_to_scale(np.asarray(jys["x0_t"]), tys["x0_t"].numpy(), f"x0_t {sample_type}")
    table = generation_table(seq, t_addnoise=T_ADDNOISE)
    stochastic = [i for i in range(6) if sample_type == "ddpm" or table.eta[i] != 0]
    assert draws == stochastic and 0 < len(draws)


@pytest.mark.parametrize("sample_type", ["ddim", "ddpm"])
def test_openai_edit_generate_two_segment_matches_jax(oai, sample_type):
    spec, jspec, jparams, model, jedit, tedit = oai
    seq = uniform_seq(6, 999)
    x = _x(8)
    rng = jax.random.PRNGKey(17)
    kw = dict(t_edit=T_EDIT, t_addnoise=T_ADDNOISE, sample_type=sample_type)
    want, _ = jengine.make_edit_generate(jspec, SCHED, seq, **kw)(jparams, jedit, jnp.asarray(x),
                                                                 rng)
    got, _ = tengine.make_edit_generate(spec, SCHED, seq, **kw)(model, tedit, torch.from_numpy(x),
                                                                noise_fn=_jax_noise(rng))
    plain, _ = tengine.make_generate(spec, SCHED, seq, t_addnoise=T_ADDNOISE,
                                     sample_type=sample_type)(model, torch.from_numpy(x),
                                                              noise_fn=_jax_noise(rng))
    close_to_scale(np.asarray(want), got.numpy(), f"x_edit {sample_type}")
    if sample_type == "ddim":
        assert float((got - plain).abs().max()) > 1e-3  # the edit moved the output
    else:  # the JAX ancestral step reads eps, never eps_mod: the edit changes nothing
        torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_openai_invert_edit_matches_jax(oai):
    spec, jspec, jparams, model, jedit, tedit = oai
    seq = uniform_seq(4, 999)
    x0 = _x(9, b=1)
    rng = jax.random.PRNGKey(19)
    want = jengine.make_invert_edit(jspec, SCHED, seq, seq, t_edit=T_EDIT, t_addnoise=T_ADDNOISE)(
        jparams, jedit, jnp.asarray(x0), rng)
    got = tengine.make_invert_edit(spec, SCHED, seq, seq, t_edit=T_EDIT, t_addnoise=T_ADDNOISE)(
        model, tedit, torch.from_numpy(x0), noise_fn=_jax_noise(rng))
    close_to_scale(np.asarray(want), got.numpy(), "x_edit")
