"""`--remat` in the port (`cfg.remat`, `models/common.remat`): the resblocks
recomputed in the backward change the memory a gradient saves, not its
values, in both UNet families, against the port without it and against
the JAX package's `remat=True` gradients (run as `tests/test_remat.py` runs
it, on the CPU).

  * DDPM++ (ch 32, 32²) and the OpenAI UNet (32², 32 channels): eps, the
    input's gradient and every parameter's gradient of mean|eps| with remat
    on and off (the same ops recomputed: equal to 1e-6 of scale), and
    against JAX's `remat=True` gradients (1e-4 of scale). JAX cannot
    differentiate the OpenAI resblocks' parameterless up/down (a general
    `lax.reduce_window`), so the OpenAI JAX comparison takes the conv
    up/down; the port alone is also held at the resblock up/down;
  * a `saved_tensors_hooks` count: the tensors saved for the backward take
    fewer bytes with remat;
  * which blocks are wrapped: DDPM++ the encoder's and decoder's resblocks
    and not `mid.block_1` / `mid.block_2` (where Δh enters; the JAX
    `_block_fn`), the OpenAI family every resblock (the JAX `_apply_layer`);
    without a gradient nothing is wrapped;
  * the runner's `--remat` reaches the built model's config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from parity_utils import close_to_scale

from asyrp_official_torch.cli.main import build_parser
from asyrp_official_torch.models import common as cm
from asyrp_official_torch.models import ddpmpp as tddpmpp
from asyrp_official_torch.models import openai_unet as toai
from asyrp_official_torch.models.registry import ModelSpec
from asyrp_official_torch.runner import AsyrpRunner
from asyrp_official_torch.utils import hostrng
from asyrp_official_torch.utils.tinyws import tiny_base_argv, write_tiny_workspace
from asyrp_official_tpu.models import ddpmpp as jddpmpp
from asyrp_official_tpu.models import openai_unet as joai

DDPMPP = tddpmpp.DDPMppConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
                              resolution=32)
# conv up/down: JAX differentiates those (see the module docstring)
OPENAI = toai.OpenAIUNetConfig(image_size=32, model_channels=32, out_channels=6,
                               num_res_blocks=1, attention_ds=(2,), channel_mult=(1, 2),
                               resblock_updown=False)
OPENAI_UPDOWN = dataclasses.replace(OPENAI, resblock_updown=True)
CASES = {"ddpmpp": (DDPMPP, jddpmpp, "ddpmpp", "ddpm"),
         "openai": (OPENAI, joai, "openai", "openai"),
         "openai_updown": (OPENAI_UPDOWN, joai, "openai", "openai")}
SAME, JAX_TOL = 1e-6, 1e-4


def _perturbed(tree, seed):
    """The JAX init plus noise: the zero-initialised output convolutions
    would make every gradient behind them vanish."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.randn(*np.shape(a)))
                        .astype(np.float32), tree)


def _setup(name):
    cfg, jmod, family, flavor = CASES[name]
    spec = ModelSpec(family=family, config=cfg, learn_sigma=family == "openai",
                     delta_flavor=flavor)
    params = _perturbed(spec.init(hostrng.PRNGKey(0)), 3)
    rng = np.random.RandomState(1)
    x = rng.randn(1, 32, 32, 3).astype(np.float32)
    return spec, params, x


def _port(spec, params, x, remat):
    """eps, and the gradients of mean|eps| w.r.t. the input and every
    parameter (a state dict), of the port's model."""
    cfg = dataclasses.replace(spec.config, remat=remat)
    model = dataclasses.replace(spec, config=cfg).build()
    model.load_state_dict(spec.state_dict_from_jax(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    eps = model.apply(xt, torch.full((1,), 100.0))[0]
    eps.abs().mean().backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None}
    return eps.detach().numpy(), xt.grad.numpy(), grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_changes_no_value_or_gradient(name):
    spec, params, x = _setup(name)
    eps, dx, grads = _port(spec, params, x, remat=False)
    eps_r, dx_r, grads_r = _port(spec, params, x, remat=True)
    close_to_scale(eps, eps_r, f"{name} eps", bound=SAME)
    close_to_scale(dx, dx_r, f"{name} d/dx", bound=SAME)
    assert sorted(grads) == sorted(grads_r) and len(grads) == sum(
        1 for _ in spec.build().parameters())
    for k in grads:
        close_to_scale(grads[k], grads_r[k], f"{name} d/d{k}", bound=SAME)


@pytest.mark.parametrize("name", ["ddpmpp", "openai"])
def test_remat_gradients_match_jax_remat(name):
    """The port's remat gradients against `jax.grad` of the JAX model with
    `remat=True`: the input's and every parameter's (JAX's gradient tree
    mapped to the port's keys by the same bridge as the weights)."""
    spec, params, x = _setup(name)
    jmod = CASES[name][1]
    jcfg_cls = jmod.DDPMppConfig if name == "ddpmpp" else jmod.OpenAIUNetConfig
    jcfg = jcfg_cls(**dataclasses.asdict(dataclasses.replace(spec.config, remat=True)))
    assert jcfg.remat
    t = jnp.full((1,), 100.0)
    jparams = jax.tree.map(jnp.asarray, params)

    def loss(p, xx):
        return jnp.abs(jmod.apply(p, jcfg, xx, t)[0]).mean()

    gp, gx = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
    want = spec.state_dict_from_jax(jax.tree.map(np.asarray, gp))
    _, dx, grads = _port(spec, params, x, remat=True)
    close_to_scale(np.asarray(gx), dx, f"{name} d/dx vs JAX", bound=JAX_TOL)
    # each gradient against the scale of its layer's (a bias's sum over
    # every pixel cancels to far below its weight's scale, and so does
    # JAX's own float32 one: 1e-4 of its own scale from JAX's float64), and
    # a layer whose gradient is zero up to rounding (the 32-channel blocks'
    # temb_proj: a per-channel add before a 32-group norm, which takes it
    # out) against 1e-3 of the largest
    floor = 1e-3 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        layer = k.rsplit(".", 1)[0]
        scale = max(float(np.abs(w.numpy()).max()) for kk, w in want.items()
                    if kk.rsplit(".", 1)[0] == layer)
        err = float(np.abs(want[k].numpy() - g).max()) / max(scale, floor)
        assert err <= JAX_TOL, (f"{name} d/d{k} vs JAX", err)


def _saved_bytes(spec, params, x, remat):
    cfg = dataclasses.replace(spec.config, remat=remat)
    model = dataclasses.replace(spec, config=cfg).build()
    model.load_state_dict(spec.state_dict_from_jax(params))
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    xt = torch.from_numpy(x).requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        eps = model.apply(xt, torch.full((1,), 100.0))[0]
    eps.abs().mean().backward()  # the recompute's own saves are not counted here
    return total[0]


@pytest.mark.parametrize("name", ["ddpmpp", "openai"])
def test_remat_saves_fewer_bytes(name):
    spec, params, x = _setup(name)
    plain, remat = _saved_bytes(spec, params, x, False), _saved_bytes(spec, params, x, True)
    assert 0 < remat < 0.7 * plain, (plain, remat)


def _wrapped(spec, params, x, monkeypatch, grad=True):
    """The blocks that went through `common.remat` in one forward."""
    seen = []
    real = cm.remat

    def spy(block, *args):
        seen.append(block)
        return real(block, *args)

    monkeypatch.setattr(cm, "remat", spy)
    cfg = dataclasses.replace(spec.config, remat=True)
    model = dataclasses.replace(spec, config=cfg).build()
    model.load_state_dict(spec.state_dict_from_jax(params))
    with torch.set_grad_enabled(grad):
        model.apply(torch.from_numpy(x).requires_grad_(grad), torch.full((1,), 100.0))
    return model, seen


def test_ddpmpp_wraps_encoder_and_decoder_blocks_not_the_middle(monkeypatch):
    spec, params, x = _setup("ddpmpp")
    model, seen = _wrapped(spec, params, x, monkeypatch)
    want = [b for lvl in model.down for b in lvl.block]
    want += [b for i in reversed(range(len(model.up))) for b in model.up[i].block]
    assert [id(b) for b in seen] == [id(b) for b in want]
    assert model.mid.block_1 not in seen and model.mid.block_2 not in seen


@pytest.mark.parametrize("name", ["openai", "openai_updown"])
def test_openai_wraps_every_resblock(name, monkeypatch):
    spec, params, x = _setup(name)
    model, seen = _wrapped(spec, params, x, monkeypatch)
    want = [m for m in model.modules() if isinstance(m, toai.ResBlock)]
    assert len(seen) == len(want) and {id(b) for b in seen} == {id(b) for b in want}
    assert all(isinstance(b, toai.ResBlock) for b in seen)


@pytest.mark.parametrize("name", ["ddpmpp", "openai"])
def test_remat_without_grad_runs_the_blocks_as_they_are(name, monkeypatch):
    spec, params, x = _setup(name)
    calls = []
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1))
    _, seen = _wrapped(spec, params, x, monkeypatch, grad=False)
    assert seen and not calls


@pytest.mark.parametrize("flag", [True, False])
def test_runner_remat_reaches_the_built_model(tmp_path, flag):
    write_tiny_workspace(str(tmp_path))
    argv = tiny_base_argv(str(tmp_path / "tiny.yml"), str(tmp_path / "imgs"), str(tmp_path),
                          str(tmp_path / "runs" / "e"),
                          extra=["--device", "cpu"] + (["--remat"] if flag else []))
    config = yaml.safe_load(open(tmp_path / "tiny.yml"))
    runner = AsyrpRunner(build_parser().parse_args(argv), config, work_dir=str(tmp_path))
    assert runner.spec.config.remat is flag
    assert runner.load_pretrained().cfg.remat is flag
