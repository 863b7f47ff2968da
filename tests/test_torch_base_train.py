"""The port's base diffusion-model training (`pipelines/base_train.py`)
against the JAX package's, on the CPU: three steps on the 16^2 DDPM++ of
the JAX base-training tests (eps, fixedsmall, mse) and on the tiny OpenAI
learn_sigma UNet of `test_torch_openai.py`, with conv up/down resblocks
(the P2 hybrid recipe: learned_range, rescaled_mse, p2_gamma 1), both on
perturbed seeded weights
(every all-zero layer redrawn, so eps is not zero) fed to both packages.

  * `torch.optim.SGD` against `optax.sgd`: the parameters and the EMA after
    each step, per tensor, within 1e-4 of scale; `loss_per_sample` too;
  * `torch.optim.Adam` against `optax.adam` (eps 1e-4, see `ADAM_EPS`):
    the update (params - init) of each tensor within 1e-3 of the whole
    update's scale;
  * `LossSecondMomentResampler` fed each package's per-sample losses draws
    the same timesteps and weights once its histories are warm;
  * a `compute_dtype=bfloat16` step's update no farther from JAX's float32
    update than 2x JAX's own bfloat16 update is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.core import gaussian as PG
from asyrp_official_torch.core.resample import LossSecondMomentResampler as PSampler
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines.base_train import (
    init_train_state, make_base_train_step, unet_eps_fn)
from asyrp_official_tpu.core import gaussian as JG
from asyrp_official_tpu.core.resample import LossSecondMomentResampler as JSampler
from asyrp_official_tpu.pipelines import base_train as jbt
from asyrp_official_tpu.runner import spec_from_config as j_spec_from_config
from asyrp_official_tpu.utils import hostrng

from test_torch_gaussian import _DDPMPP16
from test_torch_openai import OPENAI_TINY_CONFIG, perturbed

# JAX cannot differentiate the resblocks' parameterless up/down (its average
# pool is a general `lax.reduce_window`: "Linearization failed"), so the
# OpenAI recipe runs the tiny config with the conv Downsample / Upsample
OPENAI_TRAIN_CONFIG = {**OPENAI_TINY_CONFIG,
                       "model": {**OPENAI_TINY_CONFIG["model"], "resblock_updown": False}}
BETAS = np.linspace(1e-4, 0.02, 50)
PT, JT = PG.make_tables(BETAS), JG.make_tables(BETAS)
RECIPES = {
    "ddpmpp": (_DDPMPP16, dict(mean_type="eps", var_type="fixedsmall", loss_type="mse")),
    "openai": (OPENAI_TRAIN_CONFIG, dict(mean_type="eps", var_type="learned_range",
                                        loss_type="rescaled_mse", p2_gamma=1.0, p2_k=1.0)),
}
EMA_RATE = 0.9
STEPS = 3
# Adam divides by sqrt(v) + eps per element: at the default 1e-8 a gradient
# that is zero in exact arithmetic (the attention key bias: softmax ignores
# a shift shared by a query's logits) is float noise that Adam scales to
# +-lr in either package. At 1e-4 an element's update reads its gradient's
# noise (~1e-8 here) at most 1e-4 of lr.
ADAM_EPS = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name):
    cfg, kw = RECIPES[name]
    spec, jspec = spec_from_config(cfg), j_spec_from_config(cfg)
    tree = perturbed(spec.init(hostrng.PRNGKey(2)))
    model = spec.build()
    model.load_state_dict(spec.state_dict_from_jax(tree))
    size = cfg["data"]["image_size"]
    return spec, jspec, tree, model, size, kw


def _batches(size, n=STEPS, b=2, seed=0, sampler=None):
    """Per step: (x0, t, noise, weights), numpy NCHW; t from `sampler`
    (a pair of the packages' samplers, fed later) or uniform."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        x0 = np.clip(rng.randn(b, 3, size, size) * 0.5, -1, 1).astype(np.float32)
        noise = rng.randn(b, 3, size, size).astype(np.float32)
        if sampler is None:
            t, w = rng.randint(0, 50, b), np.ones(b, np.float32)
        else:
            t, w = sampler(b, np.random.RandomState(100 + i))
        yield x0, t, noise, w


def _nhwc(a):
    return jnp.asarray(np.transpose(a, (0, 2, 3, 1)))


class _Pair:
    """The same training run in both packages, one step at a time."""

    def __init__(self, name, opt, compute_dtype="float32"):
        self.spec, jspec, tree, self.model, self.size, kw = _setup(name)
        self.init = {k: v.clone() for k, v in self.model.state_dict().items()}
        popt = {"sgd": lambda p: torch.optim.SGD(p, lr=0.05),
                "adam": lambda p: torch.optim.Adam(p, lr=1e-3, eps=ADAM_EPS)}[opt](
                    self.model.parameters())
        jopt = {"sgd": optax.sgd(0.05), "adam": optax.adam(1e-3, eps=ADAM_EPS)}[opt]
        self.model, self.ema, popt = init_train_state(self.model, popt)
        self.pstep = make_base_train_step(unet_eps_fn, PT, popt, ema_rate=EMA_RATE,
                                          compute_dtype=getattr(torch, compute_dtype), **kw)
        self.jstate = jbt.init_train_state(jax.tree.map(jnp.asarray, tree), jopt)
        self.jstep = jbt.make_base_train_step(
            lambda p, x, t: jspec.apply(p, x, t.astype(jnp.float32))[0], JT, jopt,
            ema_rate=EMA_RATE, compute_dtype=getattr(jnp, compute_dtype), **kw)

    def step(self, x0, t, noise, w):
        pm = self.pstep(self.model, self.ema, torch.from_numpy(x0), torch.from_numpy(t),
                        torch.from_numpy(noise), torch.from_numpy(w))
        params, ema, opt_state, jm = self.jstep(*self.jstate, _nhwc(x0),
                                                jnp.asarray(t, jnp.int32), _nhwc(noise),
                                                jnp.asarray(w))
        self.jstate = (params, ema, opt_state)
        return pm, jm

    def jax_sd(self, which: int):
        tree = jax.tree.map(np.asarray, self.jstate[which])
        return self.spec.state_dict_from_jax(tree)


@pytest.mark.parametrize("name", list(RECIPES))
def test_sgd_steps_match_jax(name):
    pair = _Pair(name, "sgd")
    for x0, t, noise, w in _batches(pair.size):
        pm, jm = pair.step(x0, t, noise, w)
        for k in ("loss", "loss_per_sample", "mse") + (("vb",) if "vb" in jm else ()):
            close_to_scale(np.asarray(jm[k]), pm[k].numpy(), k)
        for label, mod, which in (("params", pair.model, 0), ("ema", pair.ema, 1)):
            want = pair.jax_sd(which)
            for k, v in mod.state_dict().items():
                close_to_scale(want[k].numpy(), v.numpy(), f"{label} {k}")
    moved = max(float((pair.model.state_dict()[k] - v).abs().max()) for k, v in pair.init.items())
    assert moved > 1e-4
    assert all(not p.requires_grad for p in pair.ema.parameters())


@pytest.mark.parametrize("name", list(RECIPES))
def test_adam_update_matches_jax(name):
    """The update of every tensor within 1e-3 of the whole update's scale
    (a tensor whose gradient is zero in exact arithmetic moves by float
    noise alone, so its own scale means nothing)."""
    pair = _Pair(name, "adam")
    for batch in _batches(pair.size, seed=1):
        pair.step(*batch)
    for label, mod, which in (("params", pair.model, 0), ("ema", pair.ema, 1)):
        want = pair.jax_sd(which)
        got = mod.state_dict()
        ups = {k: ((want[k] - v).numpy(), (got[k] - v).numpy()) for k, v in pair.init.items()}
        scale = max(np.abs(u_j).max() for u_j, _ in ups.values())
        assert scale > 1e-4, label
        for k, (u_j, u_p) in ups.items():
            err = np.abs(u_j - u_p).max() / scale
            assert err <= 1e-3, (f"{label} update {k}", err, scale)


def test_importance_sampler_draws_the_same_timesteps_after_warm_up():
    pair = _Pair("openai", "sgd")
    samplers = [PSampler(50, history_per_term=2), JSampler(50, history_per_term=2)]
    warm = np.random.RandomState(3).rand(50, 2)
    for s in samplers:  # warm histories, the same in both
        for col in range(2):
            s.update_with_all_losses(np.arange(50), warm[:, col])
    rng = np.random.RandomState(4)
    for i in range(STEPS):
        draws = [s.sample(2, np.random.RandomState(100 + i)) for s in samplers]
        np.testing.assert_array_equal(draws[0][0], draws[1][0])
        np.testing.assert_allclose(draws[0][1], draws[1][1], rtol=1e-4)
        t, w = draws[0]
        x0 = np.clip(rng.randn(2, 3, pair.size, pair.size) * 0.5, -1, 1).astype(np.float32)
        noise = rng.randn(2, 3, pair.size, pair.size).astype(np.float32)
        pm, jm = pair.step(x0, t, noise, w)
        samplers[0].update_with_local_losses(t, pm["loss_per_sample"].numpy())
        samplers[1].update_with_local_losses(t, np.asarray(jm["loss_per_sample"]))
        assert samplers[0]._warmed_up()


@pytest.mark.parametrize("name", list(RECIPES))
def test_bf16_step_is_as_close_to_float32_as_jax_bf16(name):
    f32, bf16 = _Pair(name, "sgd"), _Pair(name, "sgd", "bfloat16")
    batch = next(_batches(f32.size, seed=2))
    f32.step(*batch)
    bf16.step(*batch)
    want = f32.jax_sd(0)  # JAX float32
    jax_bf16 = bf16.jax_sd(0)
    worst = []
    for k, v in bf16.model.state_dict().items():
        ref = want[k] - f32.init[k]
        scale = float(ref.abs().max())
        if scale == 0:
            continue
        d_port = float(((v - bf16.init[k]) - ref).abs().max()) / scale
        d_jax = float(((jax_bf16[k] - bf16.init[k]) - ref).abs().max()) / scale
        worst.append((d_port / max(d_jax, 1e-30), k, d_port, d_jax))
        assert d_port <= 2.0 * d_jax, (k, d_port, d_jax)
    assert max(worst)[0] > 0
