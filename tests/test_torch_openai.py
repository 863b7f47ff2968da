"""The port's OpenAI-family UNet (iDDPM/ADM), its DeltaBlock flavor, weight
bridge, Δ-training step and CLI (serving and training) against the JAX
package, on the tiny OpenAI config of the JAX tests (32^2, ch 32, mult
(1, 2), attention at 16^2 as 4 heads of 16), on the CPU.

The JAX init zeroes every resblock's `out_conv`, every attention `proj_out`
and the final `out_conv`, so the seeded UNet outputs eps == 0 and every
attention output is multiplied by zero. Init parity is checked on that tree;
every other comparison runs on `perturbed(tree)`: the all-zero layers
redrawn from a seeded numpy RandomState within the layer's kaiming bound,
fed to both packages. Each comparison asserts that eps is far from zero and
that the edited output differs from the plain one.

Tolerance: `close_to_scale` 1e-4 (max error relative to the array's scale)
in float32; bfloat16 as stated in `test_apply_bf16_matches_jax` and
`test_openai_train_step_bf16_matches_jax`.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from parity_utils import close_to_scale

from asyrp_official_torch.compat import delta_ckpt as tckpt
from asyrp_official_torch.compat.from_jax import openai_unet_state_dict_from_jax
from asyrp_official_torch.core.schedule import make_schedule as p_make_schedule, train_seq
from asyrp_official_torch.losses import clip_loss as pl, clip_model as pm, tokenizer as ptok
from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models import openai_unet as toai
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import train as ptr
from asyrp_official_tpu.compat import delta_ckpt as jckpt
from asyrp_official_tpu.core import ddim as jddim
from asyrp_official_tpu.core.schedule import make_schedule as j_make_schedule
from asyrp_official_tpu.losses import clip_loss as jl, clip_model as jm, tokenizer as jtok
from asyrp_official_tpu.models import delta as jdelta
from asyrp_official_tpu.models import openai_unet as joai
from asyrp_official_tpu.pipelines import train as jtr
from asyrp_official_tpu.runner import spec_from_config as j_spec_from_config
from asyrp_official_tpu.utils import hostrng

# the JAX tests' SMALL_OAI (tests/test_models_parity.py)
SMALL = dict(image_size=32, model_channels=32, out_channels=6, num_res_blocks=1,
             attention_ds=(2,), channel_mult=(1, 2), num_heads=4, num_head_channels=16)
# the JAX CLI tests' tiny OpenAI workspace config (tests/test_openai_cli_and_dt.py)
OPENAI_TINY_CONFIG = {
    "data": {"dataset": "CelebA_HQ", "category": "CUSTOM", "image_size": 32, "channels": 3},
    "model": {"family": "openai", "in_channels": 3, "out_ch": 6, "ch": 32, "ch_mult": [1, 2],
              "num_res_blocks": 1, "attn_resolutions": [16], "dropout": 0.0,
              "var_type": "fixedsmall", "learn_sigma": True, "num_head_channels": 16,
              "use_scale_shift_norm": True, "resblock_updown": True, "class_cond": False},
    "diffusion": {"beta_schedule": "linear", "beta_start": 0.0001, "beta_end": 0.02,
                  "num_diffusion_timesteps": 1000},
}
# the tiny CLIP of the port's training tests (tests/test_torch_train.py)
CLIP_CFG = pm.CLIPConfig(embed_dim=32, image_resolution=16, vision_layers=1, vision_width=64,
                         vision_patch_size=8, context_length=16, transformer_width=64,
                         transformer_heads=1, transformer_layers=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed(tree, seed: int = 0):
    """`tree` with every all-zero {"w", "b"} layer redrawn uniformly within
    its kaiming bound 1/sqrt(fan_in) (numpy RandomState(seed), in tree
    order); every other leaf unchanged."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"w", "b"} and not (np.any(node["w"]) or np.any(node["b"])):
                w = np.asarray(node["w"])
                bound = 1.0 / math.sqrt(int(np.prod(w.shape[:-1])))
                return {"w": rng.uniform(-bound, bound, w.shape).astype(np.float32),
                        "b": rng.uniform(-bound, bound, np.shape(node["b"])).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node

    return walk(tree)


def _cfgs(**over):
    j = joai.OpenAIUNetConfig(**{**SMALL, **over})
    t = toai.OpenAIUNetConfig(**{f.name: getattr(j, f.name)
                                 for f in dataclasses.fields(toai.OpenAIUNetConfig)})
    return j, t


def _model(params, tcfg, dtype=torch.float32):
    m = toai.OpenAIUNet(tcfg)
    m.load_state_dict(openai_unet_state_dict_from_jax(params, tcfg))
    return m.eval().requires_grad_(False).to(dtype)


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(p))


VARIANTS = {  # name: config overrides
    "legacy_order": {},
    "new_order": {"use_new_attention_order": True},
    "no_scale_shift": {"use_scale_shift_norm": False},
    "no_resblock_updown": {"resblock_updown": False},
}


# ---------------------------------------------------------------------------
# (a) init, (b) the weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_params_bit_identical_to_jax_init(variant):
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    jp = joai.init(hostrng.PRNGKey(0), jcfg)
    tp = toai.init_params(hostrng.PRNGKey(0), tcfg)
    _leaves_equal(jp, tp)
    zero = [k for k, v in jax.tree_util.tree_leaves_with_path(tp) if not np.any(v)]
    assert len(zero) > 0  # the zero_module leaves (and the norm biases) are there


def test_afhq_config_has_the_reference_parameter_count():
    with torch.device("meta"):
        m = toai.OpenAIUNet(toai.AFHQ_CONFIG)
    assert sum(p.numel() for p in m.parameters()) == 93_563_910
    plan = toai.build_plan(toai.AFHQ_CONFIG)
    attn = [s for blk in plan["input"] + [plan["middle"]] + plan["output"] for s in blk
            if s["kind"] == "attn"]
    # 16^2: one in the encoder, two in the decoder; 8^2: the middle block
    assert {(s["ch"], s["heads"]) for s in attn} == {(512, 8)} and len(attn) == 4


@pytest.mark.parametrize("variant", ["legacy_order", "no_scale_shift"])
def test_class_conditional_random_init_bit_identical_to_jax(variant):
    """A class-conditional config's `label_emb` is drawn from the third key,
    before the input blocks, as in the JAX init: every leaf bit for bit."""
    jcfg, tcfg = _cfgs(num_classes=10, **VARIANTS[variant])
    tp = toai.init_params(hostrng.PRNGKey(0), tcfg)
    assert tp["label_emb"]["w"].shape == (10, tcfg.temb_ch)
    _leaves_equal(joai.init(hostrng.PRNGKey(0), jcfg), tp)


@pytest.mark.parametrize("variant", ["legacy_order", "no_resblock_updown"])
def test_state_dict_round_trip_through_convert_openai_unet(variant):
    """port state_dict → JAX convert_openai_unet + params_from_torch → the
    same tree, leaf for leaf; and back through the bridge."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    params = perturbed(toai.init_params(hostrng.PRNGKey(1), tcfg))
    sd = {k: v.numpy() for k, v in _model(params, tcfg).state_dict().items()}
    back = joai.params_from_torch(sd, jcfg)
    _leaves_equal(back, params)
    again = openai_unet_state_dict_from_jax(back, tcfg)
    assert sorted(again) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(again[k].numpy(), sd[k], err_msg=k)


def test_perturbed_weights_make_the_network_non_trivial():
    _, tcfg = _cfgs()
    tp = toai.init_params(hostrng.PRNGKey(0), tcfg)
    x = torch.randn(1, 32, 32, 3)
    with torch.no_grad():
        assert _model(tp, tcfg).apply(x, torch.tensor([500.0]))[0].abs().max() == 0
        assert _model(perturbed(tp), tcfg).apply(x, torch.tensor([500.0]))[0].std() > 0.1


# ---------------------------------------------------------------------------
# (c) the forward, single and dual decode; (d) the DeltaBlock flavor
# ---------------------------------------------------------------------------


def _blocks(ch, temb_ch, seed=3):
    jb = jdelta.delta_block_init(hostrng.PRNGKey(seed), ch, temb_ch, flavor="openai")
    tb = tdelta.delta_block_from_tree(jb, ch, temb_ch, flavor="openai").eval()
    return jb, tb


def _inputs(b=2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 32, 32, 3).astype(np.float32),
            np.array([999.0, 400.0, 10.0][:b], np.float32))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("batch,decode_mode", [(2, "auto"), (2, "split"), (1, "auto")])
def test_apply_matches_jax(variant, batch, decode_mode):
    """Single decode, then the edited dual decode: stacked (2B), split by
    `decode_mode`, and split at batch 1."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    params = perturbed(joai.init(hostrng.PRNGKey(0), jcfg))
    model = _model(params, tcfg)
    jp = jax.tree.map(jnp.asarray, params)
    x, t = _inputs(batch)
    jb, tb = _blocks(tcfg.bottleneck_ch, tcfg.temb_ch)
    coeff = np.array([1.0, 1.5], np.float32)
    jedit = jdelta.EditState(blocks=(jb,), hs_coeff=jnp.asarray(coeff), flavor="openai")
    tedit = tdelta.EditState(blocks=(tb,), hs_coeff=torch.from_numpy(coeff), flavor="openai")
    with torch.no_grad():
        plain = model.apply(torch.from_numpy(x), torch.from_numpy(t))
        got = model.apply(torch.from_numpy(x), torch.from_numpy(t), edit=tedit,
                          decode_mode=decode_mode)
    want_plain = joai.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t))
    want = joai.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t), edit=jedit,
                      decode_mode=decode_mode)
    assert plain[1] is None and plain[2] is None
    close_to_scale(np.asarray(want_plain[0]), plain[0].numpy(), "eps, single decode")
    close_to_scale(np.asarray(want_plain[3]), plain[3].numpy(), "middle_h")
    for w, g, name in zip(want, got, ("eps", "eps_mod", "delta_h", "middle_h")):
        close_to_scale(np.asarray(w), g.numpy(), name)
    assert got[0].shape == (batch, 32, 32, 6)
    assert float(got[0].std()) > 0.1, "eps is (near) zero: the comparison would prove nothing"
    assert float((got[1] - got[0]).abs().max()) > 1e-2 * float(got[0].abs().max())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_edited_decode_gradient_matches_jax(variant):
    """The graph of the edited split decode, from the DeltaBlock through
    every decoder layer (resblocks up, FiLM, the 4-head attention with
    either qkv order, the 2C output): the gradient of a fixed functional of
    eps_mod w.r.t. each DeltaBlock leaf against jax.grad; the frozen UNet
    gets no gradient."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    params = perturbed(joai.init(hostrng.PRNGKey(0), jcfg))
    model = _model(params, tcfg)
    x, t = _inputs(2)
    cot = np.random.RandomState(1).randn(2, 32, 32, 6).astype(np.float32)
    jb = perturbed_block(3, tcfg.bottleneck_ch, tcfg.temb_ch)

    def jloss(blk):
        e = jdelta.EditState(blocks=(blk,), hs_coeff=jnp.array([1.0, 1.0]), flavor="openai")
        out = joai.apply(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x), jnp.asarray(t),
                         edit=e, decode_mode="split")[1]
        return jnp.sum(out * cot)

    want = jax.grad(jloss)(jax.tree.map(jnp.asarray, jb))
    tb = tdelta.delta_block_from_tree(jb, tcfg.bottleneck_ch, tcfg.temb_ch, flavor="openai")
    edit = tdelta.EditState(blocks=(tb.train(),), hs_coeff=torch.tensor([1.0, 1.0]),
                            flavor="openai")
    out = model.apply(torch.from_numpy(x), torch.from_numpy(t), edit=edit, decode_mode="split")[1]
    (out * torch.from_numpy(cot)).sum().backward()
    assert all(p.grad is None for p in model.parameters())
    got = tckpt.convert_delta_block({k: p.grad.numpy() for k, p in tb.named_parameters()})
    for g in want:
        for k in want[g]:
            close_to_scale(np.asarray(want[g][k]), got[g][k], f"{variant} d{g}/{k}")


def _rel_err(want, got) -> float:
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / np.abs(want).max())


def test_apply_bf16_matches_jax():
    """bf16: the two frameworks round at other places (a fused GN+SiLU
    rounds once, JAX's GN then swish twice), so each lands 1.4-2.8e-2 of
    scale from the f32 network (measured over 3 seeds). The port's bf16
    must stay within 1.5x JAX bf16's own distance from the f32 JAX output,
    and within 4e-2 of JAX bf16 (measured 1.8-3.0e-2)."""
    jcfg, tcfg = _cfgs()
    params = perturbed(joai.init(hostrng.PRNGKey(0), jcfg))
    jp = jax.tree.map(jnp.asarray, params)
    x, t = _inputs(1)
    jb, tb = _blocks(tcfg.bottleneck_ch, tcfg.temb_ch)
    coeff = np.array([1.0, 1.5], np.float32)
    jedit = jdelta.EditState(blocks=(jb,), hs_coeff=jnp.asarray(coeff), flavor="openai")
    want = joai.apply(jp, jcfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t), edit=jedit)
    want_f32 = joai.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t), edit=jedit)
    with torch.no_grad():
        got = _model(params, tcfg).apply(
            torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(t),
            edit=tdelta.EditState(blocks=(tb,), hs_coeff=torch.from_numpy(coeff), flavor="openai"))
    assert want[0].dtype == jnp.bfloat16 and got[0].dtype == torch.bfloat16
    for w, w32, g, name in zip(want[:2], want_f32[:2], got[:2], ("eps", "eps_mod")):
        jax_own = _rel_err(w32, w.astype(jnp.float32))
        assert _rel_err(w32, g.float().numpy()) <= 1.5 * jax_own, (name, jax_own)
        close_to_scale(np.asarray(w.astype(jnp.float32)), g.float().numpy(), f"bf16 {name}",
                       bound=4e-2)
    assert float(got[0].float().std()) > 0.1
    assert float((got[1] - got[0]).float().abs().max()) > 1e-2 * float(got[0].float().abs().max())


@pytest.mark.parametrize("with_temb", [True, False])
def test_openai_delta_block_matches_jax(with_temb):
    rng = np.random.RandomState(4)
    h = rng.randn(2, 8, 8, 64).astype(np.float32)
    temb = rng.randn(2, 128).astype(np.float32)
    jb, tb = _blocks(64, 128, seed=11)
    want = jdelta.delta_block_apply(jax.tree.map(jnp.asarray, jb), jnp.asarray(h),
                                    jnp.asarray(temb) if with_temb else None, flavor="openai")
    with torch.no_grad():
        got = tb(torch.from_numpy(np.ascontiguousarray(h.transpose(0, 3, 1, 2))),
                 torch.from_numpy(temb) if with_temb else None)
    close_to_scale(np.asarray(want), got.numpy().transpose(0, 2, 3, 1), "openai DeltaBlock")
    assert sorted(tb.state_dict()) == sorted(jckpt.blocks_to_torch_sd(jb, "openai"))


def test_openai_delta_checkpoint_reads_across_packages(tmp_path):
    """The port's `.pth` is read by the JAX `load_delta_checkpoint`, and the
    JAX package's by the port's: the same trees."""
    jb, _ = _blocks(64, 128, seed=12)
    tb_tree = tdelta.delta_block_init(hostrng.PRNGKey(12), 64, 128, flavor="openai")
    _leaves_equal(jb, tb_tree)
    tckpt.save_delta_checkpoint(str(tmp_path / "port.pth"), blocks=[tb_tree], flavor="openai")
    jckpt.save_delta_checkpoint(str(tmp_path / "jax.pth"), blocks=[jb], flavor="openai")
    _leaves_equal(jckpt.load_delta_checkpoint(str(tmp_path / "port.pth"))["blocks"][0], jb)
    _leaves_equal(tckpt.load_delta_checkpoint(str(tmp_path / "jax.pth"))["blocks"][0], jb)
    (block,) = tdelta.init_delta_blocks(12, 1, 64, 128, flavor="openai")
    assert isinstance(block, tdelta.OpenAIDeltaBlock)
    assert sorted(block.state_dict()) == sorted(
        tckpt.load_state_dict_numpy(str(tmp_path / "jax.pth"))["0"])


# ---------------------------------------------------------------------------
# (e) the Δ-training step
# ---------------------------------------------------------------------------

T_EDIT, LR = 500, 0.05


def perturbed_block(seed: int, ch: int = 64, temb_ch: int = 128):
    """An OpenAI DeltaBlock tree (the JAX init of `seed`) with every leaf
    moved by noise, so its norms' scale and bias are not 1 and 0."""
    rng = np.random.RandomState(seed)
    tree = jdelta.delta_block_init(hostrng.PRNGKey(seed), ch, temb_ch, flavor="openai")
    return {g: {k: (np.asarray(v) + 0.1 * rng.randn(*np.shape(v))).astype(np.float32)
                for k, v in leaves.items()} for g, leaves in tree.items()}


@pytest.fixture(scope="module")
def train_setup():
    """The tiny OpenAI UNet on perturbed weights in both packages, a
    perturbed DeltaBlock, the tiny CLIP (the port's weights read by the JAX
    `params_from_torch`) and a numpy batch."""
    spec = spec_from_config(OPENAI_TINY_CONFIG)
    assert spec.learn_sigma and (spec.bottleneck_ch, spec.temb_ch) == (64, 128)
    params = perturbed(spec.init(hostrng.PRNGKey(5)))
    model = spec.build()
    model.load_state_dict(spec.state_dict_from_jax(params))
    model.eval().requires_grad_(False)
    clip = pm.CLIP(CLIP_CFG, seed=1).eval().requires_grad_(False)
    jclip, jcfg = jm.params_from_torch({k: v.numpy() for k, v in clip.state_dict().items()})
    rng = np.random.RandomState(0)
    return dict(spec=spec, jspec=j_spec_from_config(OPENAI_TINY_CONFIG), model=model,
                params=jax.tree.map(jnp.asarray, params), block=perturbed_block(9),
                pctx=pl.CLIPContext(clip, CLIP_CFG, ptok.HashTokenizer()),
                jctx=jl.CLIPContext(jclip, jcfg, jtok.HashTokenizer()),
                x_lat=rng.randn(2, 32, 32, 3).astype(np.float32),
                x0=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))


def _port_train(s, seq, cached_origin=False, dtype=torch.float32):
    """One `make_train_step` call of the port: (metrics, trained block as a
    JAX-layout tree)."""
    block = tdelta.delta_block_from_tree(s["block"], 64, 128, flavor="openai").train()
    assert len(list(block.parameters())) == 10  # the five leaves' weights and biases
    edit = tdelta.EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0]), flavor="openai")
    extra = pl.train_clip_term(s["pctx"], "dog", "smiling dog", 1.0)
    step = ptr.make_train_step(
        s["spec"], p_make_schedule(), seq, t_edit=T_EDIT, cached_origin=cached_origin,
        compute_dtype=dtype,
        loss_fn=lambda a, b, c: ptr.default_loss(a, b, c, l1_w=3.0, cosine=0.9, extra=extra))
    opt = ptr.make_optimizer(block.parameters(), 1.0)
    x_lat, x0 = torch.from_numpy(s["x_lat"]), torch.from_numpy(s["x0"])
    origins = [step.compute_origins(s["model"], x_lat)] if cached_origin else []
    metrics = step(s["model"], edit, opt, x_lat, x0, LR, *origins)
    return metrics, tckpt.convert_delta_block({k: v.detach().numpy()
                                               for k, v in block.state_dict().items()})


def _jax_train(s, seq, dtype=jnp.float32):
    """The JAX `make_train_step` on the same inputs: (losses, trained tree)."""
    edit = jdelta.EditState(blocks=(jax.tree.map(jnp.asarray, s["block"]),),
                            hs_coeff=jnp.array([1.0, 1.0]), flavor="openai")
    extra = jl.train_clip_term(s["jctx"], "dog", "smiling dog", 1.0)
    opt = jtr.make_optimizer(LR)
    step = jtr.make_train_step(
        s["jspec"], j_make_schedule(), seq, t_edit=T_EDIT, optimizer=opt, compute_dtype=dtype,
        loss_fn=lambda a, b, c: jtr.default_loss(a, b, c, l1_w=3.0, cosine=0.9, extra=extra))
    edit, _, metrics = step(s["params"], edit, opt.init(edit.blocks), jnp.asarray(s["x_lat"]),
                            jnp.asarray(s["x0"]), LR)
    return np.asarray(metrics["loss_per_step"]), jax.tree.map(np.asarray, edit.blocks[0])


def _update(tree, init):
    """The SGD update itself (trained - init), leaf by leaf."""
    return {f"{g}/{k}": tree[g][k] - init[g][k] for g in init for k in init[g]}


@pytest.mark.parametrize("cached_origin", [False, True])
def test_openai_train_step_matches_jax(train_setup, cached_origin):
    """Four edited timesteps (999 -> 856 -> 713 -> 570 -> x0) of the tiny
    learn_sigma UNet with the L1 and CLIP terms: the per-step losses and the
    block's update against the JAX `make_train_step`, with and without the
    origin cache; the 4-head attention backward and the learn_sigma split
    are on the gradient's path."""
    s = train_setup
    seq = train_seq(8, 999, T_EDIT)[0]
    want_losses, want = _jax_train(s, seq)
    got, tree = _port_train(s, seq, cached_origin)
    assert got["loss_per_step"].shape == (4,)
    close_to_scale(want_losses, got["loss_per_step"].numpy(), "losses")
    want_up, got_up = _update(want, s["block"]), _update(tree, s["block"])
    for k in want_up:
        assert np.abs(want_up[k]).max() > 0, k
        close_to_scale(want_up[k], got_up[k], k)


def test_openai_train_step_one_timestep_matches_jax(train_setup):
    """One edited timestep (999 -> x0): the loss, the updated leaves and
    x_next, against the JAX step and, for x_next, the JAX forward and DDIM
    update on the first C of the 2C output channels."""
    s = train_setup
    seq = train_seq(2, 999, T_EDIT)[0]
    want_losses, want = _jax_train(s, seq)
    got, tree = _port_train(s, seq)
    close_to_scale(want_losses, got["loss_per_step"].numpy(), "loss")
    for k, w in _update(want, s["block"]).items():
        close_to_scale(w, _update(tree, s["block"])[k], k)
    acp = np.asarray(j_make_schedule().alphas_cumprod_ext)
    x = jnp.asarray(s["x_lat"])
    jedit = jdelta.EditState(blocks=(jax.tree.map(jnp.asarray, s["block"]),),
                             hs_coeff=jnp.array([1.0, 1.0]), flavor="openai")
    eps, eps_mod, _, _ = s["jspec"].apply(s["params"], x, jnp.full((2,), 999.0), edit=jedit,
                                          decode_mode="split")
    want_x, _ = jddim.ddim_step(x, eps[..., :3], eps_mod[..., :3], jnp.full((2,), acp[1000]),
                                jnp.full((2,), acp[0]), 0.0, jnp.zeros_like(x))
    assert eps.shape == (2, 32, 32, 6)
    close_to_scale(np.asarray(want_x), got["x_next"].numpy(), "x_next")


@pytest.mark.parametrize("cached_origin", [False, True])
def test_openai_train_step_bf16_matches_jax(train_setup, cached_origin):
    """--bf16: the UNet, the block and hs_coeff in bfloat16 on the grad
    path, the DDIM update and CLIP in float32, in both frameworks. They
    round at other places, so the per-step losses agree to 5e-3 of scale
    (measured 2.7e-3), and the bf16 update of each leaf must be no farther
    from the float32 JAX update than 1.5x JAX bf16's own distance from it
    (JAX bf16: 7-19% of scale per leaf; the port: 0.55-1.0x of that)."""
    s = train_setup
    seq = train_seq(8, 999, T_EDIT)[0]
    want_losses, want = _jax_train(s, seq, jnp.bfloat16)
    got, tree = _port_train(s, seq, cached_origin, torch.bfloat16)
    assert np.isfinite(got["loss_per_step"].numpy()).all()
    close_to_scale(want_losses, got["loss_per_step"].numpy(), "bf16 losses", bound=5e-3)
    ref = _update(_jax_train(s, seq)[1], s["block"])
    jax_bf, port_bf = _update(want, s["block"]), _update(tree, s["block"])
    for k in ref:
        jax_own = np.abs(jax_bf[k] - ref[k]).max()
        assert np.abs(port_bf[k] - ref[k]).max() <= 1.5 * jax_own, (k, jax_own)


# ---------------------------------------------------------------------------
# (h) serving and training through the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The tiny OpenAI yml, 3 random 32^2 images, a perturbed iDDPM-layout
    `.pt` state dict (the port's keys) and an OpenAI-flavor Δ checkpoint."""
    ws = tmp_path_factory.mktemp("oai_ws")
    (ws / "imgs").mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(ws / "imgs" / f"{i}.png")
    with open(ws / "oai.yml", "w") as f:
        yaml.safe_dump(OPENAI_TINY_CONFIG, f)
    spec = spec_from_config(OPENAI_TINY_CONFIG)
    params = perturbed(spec.init(hostrng.PRNGKey(5)))
    torch.save(spec.state_dict_from_jax(params), ws / "oai_unet.pt")
    os.makedirs(ws / "checkpoint")
    jckpt.save_delta_checkpoint(
        str(ws / "checkpoint" / "golden_LC_CUSTOM_t999_ninv4_ngen4_0.pth"),
        blocks=[jdelta.delta_block_init(hostrng.PRNGKey(123), spec.bottleneck_ch, spec.temb_ch,
                                        flavor="openai")], flavor="openai")
    return ws


def _argv(ws, work, *extra):
    from asyrp_official_tpu.utils.tinyws import tiny_base_argv

    return tiny_base_argv(
        str(ws / "oai.yml"), str(ws / "imgs"), str(work), str(work / "runs" / "exp"),
        bs_train=1, edit_attr=None,
        extra=["--run_test", "--train_delta_block", "--load_from_checkpoint", "golden",
               "--do_train", "0", "--model_path", str(ws / "oai_unet.pt"), "--save_x_origin",
               *extra])


def _grids(work):
    out = {}
    for r, _, fs in os.walk(work / "runs"):
        for f in sorted(fs):
            if f.endswith(".png"):
                out[os.path.relpath(os.path.join(r, f), work / "runs")] = np.asarray(
                    Image.open(os.path.join(r, f)))
    return out


def _serve_work(ws, name):
    work = ws / name
    os.makedirs(work, exist_ok=True)
    if not (work / "checkpoint").exists():
        os.symlink(ws / "checkpoint", work / "checkpoint")
    return work


def test_cli_serving_matches_the_jax_cli(workspace):
    from asyrp_official_torch.cli.main import main as port_main
    from asyrp_official_tpu.cli.main import main as jax_main

    jwork, twork = _serve_work(workspace, "jax"), _serve_work(workspace, "port")
    assert jax_main(_argv(workspace, jwork)) == 0
    assert port_main(_argv(workspace, twork, "--device", "cpu")) == 0
    want, got = _grids(jwork), _grids(twork)
    assert sorted(want) == sorted(got) and len(got) == 2, (sorted(want), sorted(got))
    for k in got:
        diff = np.abs(want[k].astype(np.int16) - got[k].astype(np.int16))
        assert diff.max() <= 1, (k, int(diff.max()))
        assert (diff > 0).mean() < 0.01, (k, float((diff > 0).mean()))
        # two rows of 32^2 images, 1-pixel padding: the plain and the edited
        # generation, which must differ
        assert got[k].shape == (2 * 33 + 1, 34, 3)
        assert np.abs(got[k][1:33].astype(np.int16) - got[k][34:66]).max() > 0


def test_cli_serving_ddpm_sample_type(workspace):
    """`--sample_type ddpm` serves (its noise is the port's generator, so
    the grids are not the JAX package's; the step itself is held to JAX in
    test_torch_engine.py with the same draws)."""
    from asyrp_official_torch.cli.main import main as port_main

    work = _serve_work(workspace, "port_ddpm")
    assert port_main(_argv(workspace, work, "--device", "cpu", "--sample_type", "ddpm")) == 0
    got = _grids(work)
    assert len(got) == 2 and all(g.shape == (2 * 33 + 1, 34, 3) for g in got.values())


def test_rows_train_step_on_an_openai_config_matches_jax(train_setup):
    """`--train_delta_h` rows on the OpenAI family: one `make_train_step(
    train_target="rows")` call (four rows of [16, 16, 64], the L1 and CLIP
    terms, the learn_sigma split and the 4-head attention backward on the
    gradient's path) against JAX's, the per-step losses and the rows'
    update within 1e-4 of scale; every row moved."""
    s = train_setup
    seq = train_seq(8, 999, T_EDIT)[0]
    rows = np.float32(0.2) * np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4, 16, 16, 64)))
    jedit = jdelta.EditState(mode="input", delta_rows=jnp.asarray(rows),
                             hs_coeff=jnp.array([1.0, 1.0]), input_style="add", times=tuple(seq))
    opt = jtr.make_optimizer(LR)
    jextra = jl.train_clip_term(s["jctx"], "dog", "smiling dog", 1.0)
    jstep = jtr.make_train_step(
        s["jspec"], j_make_schedule(), seq, t_edit=T_EDIT, optimizer=opt, train_target="rows",
        loss_fn=lambda a, b, c: jtr.default_loss(a, b, c, l1_w=3.0, cosine=0.9, extra=jextra))
    jedit, _, jm_ = jstep(s["params"], jedit, opt.init(jedit.delta_rows), jnp.asarray(s["x_lat"]),
                          jnp.asarray(s["x0"]), LR)
    leaf = tdelta.rows_to_nchw(rows).requires_grad_(True)
    tedit = tdelta.EditState(mode="input", delta_rows=leaf, hs_coeff=torch.tensor([1.0, 1.0]),
                             input_style="add", times=tuple(seq))
    textra = pl.train_clip_term(s["pctx"], "dog", "smiling dog", 1.0)
    tstep = ptr.make_train_step(
        s["spec"], p_make_schedule(), seq, t_edit=T_EDIT, train_target="rows",
        loss_fn=lambda a, b, c: ptr.default_loss(a, b, c, l1_w=3.0, cosine=0.9, extra=textra))
    got = tstep(s["model"], tedit, ptr.make_optimizer([leaf], LR), torch.from_numpy(s["x_lat"]),
                torch.from_numpy(s["x0"]), LR)
    close_to_scale(np.asarray(jm_["loss_per_step"]), got["loss_per_step"].numpy(), "losses")
    want_up = np.asarray(jedit.delta_rows) - rows
    got_up = tdelta.rows_to_nhwc(leaf) - rows
    assert all(np.abs(want_up[i]).max() > 0 for i in range(4))
    close_to_scale(want_up, got_up, "row updates")


def _train_argv(ws, work, clip_ckpt, *extra):
    """`--run_train --train_delta_block` on the tiny OpenAI workspace: 2
    images, 2 iterations (the origin cache on), 4-step grids, the L1 and
    the CLIP directional term of a dog attribute, then `--do_test` grids."""
    from asyrp_official_tpu.utils.tinyws import tiny_base_argv

    return tiny_base_argv(
        str(ws / "oai.yml"), str(ws / "imgs"), str(work), str(work / "runs" / "exp"),
        bs_train=1, edit_attr="dog_smiling",
        extra=["--run_train", "--train_delta_block", "--model_path", str(ws / "oai_unet.pt"),
               "--clip_ckpt", clip_ckpt, "--clip_loss_w", "1", "--n_iter", "2",
               "--do_test", "1", "--save_x_origin", *extra])


def test_cli_training_matches_the_jax_cli(workspace):
    """`--run_train --train_delta_block --do_test 1` through the port's CLI
    (`--device cpu`) and the JAX CLI: each package reads the other's trained
    `.pth`, the blocks agree within 1e-4 of scale and moved from their init,
    and every grid (training-time and test) within one uint8 level."""
    from asyrp_official_torch.cli.main import build_parser, main as port_main
    from asyrp_official_tpu.cli.main import main as jax_main

    clip_ckpt = str(workspace / "clip_tiny.pt")
    torch.save(pm.CLIP(CLIP_CFG, seed=1).state_dict(), clip_ckpt)
    jwork, twork = workspace / "jax_train", workspace / "port_train"
    assert jax_main(_train_argv(workspace, jwork, clip_ckpt)) == 0
    assert port_main(_train_argv(workspace, twork, clip_ckpt, "--device", "cpu")) == 0
    name = "exp_LC_CUSTOM_t999_ninv4_ngen4_1.pth"
    jpath, tpath = (str(w / "checkpoint" / name) for w in (jwork, twork))
    want, got = jckpt.load_delta_checkpoint(jpath), tckpt.load_delta_checkpoint(tpath)
    for a, b in ((want, tckpt.load_delta_checkpoint(jpath)), (got, jckpt.load_delta_checkpoint(tpath))):
        _leaves_equal(a, b)  # each package reads the other's file as its own
    seed = build_parser().parse_args(["--config", "afhq.yml"]).seed
    init = tdelta.delta_block_init(hostrng.PRNGKey(seed), 64, 128, flavor="openai")
    (jb,), (tb,) = want["blocks"], got["blocks"]
    assert set(tb) == {"in_norm", "in_conv", "emb", "out_norm", "out_conv"}
    for g in init:
        for k in init[g]:
            close_to_scale(jb[g][k], tb[g][k], f"trained {g}/{k}")
            # the update itself (lr 0.01: ~1e-3 of the weights), through 16
            # SGD steps whose float32 sums run in other orders: measured
            # 1.3e-4 of its scale
            close_to_scale(jb[g][k] - init[g][k], tb[g][k] - init[g][k], f"update {g}/{k}",
                           bound=1e-3)
    want_g, got_g = _grids(jwork), _grids(twork)
    assert sorted(want_g) == sorted(got_g) and len(got_g) >= 2, (sorted(want_g), sorted(got_g))
    assert any(k.startswith(os.path.join("exp_LC_CUSTOM_t999_ninv4_ngen4", "test_images"))
               for k in got_g), sorted(got_g)
    for k in got_g:
        diff = np.abs(want_g[k].astype(np.int16) - got_g[k].astype(np.int16))
        assert diff.max() <= 1, (k, int(diff.max()))


def test_afhq_and_ffhq_datasets_read_as_the_jax_readers(tmp_path):
    """`{root}/{mode}/dog/*.png` for AFHQ; the last 500 files of a folder
    are FFHQ's test split."""
    from asyrp_official_torch.data import datasets as tdata
    from asyrp_official_tpu.data import datasets as jdata

    rng = np.random.RandomState(1)
    for mode in ("train", "test"):
        os.makedirs(tmp_path / "afhq" / mode / "dog")
        for i in range(2):
            Image.fromarray((rng.rand(40, 40, 3) * 255).astype(np.uint8)).save(
                tmp_path / "afhq" / mode / "dog" / f"{i}.png")
    os.makedirs(tmp_path / "ffhq")
    for i in range(502):
        Image.fromarray(np.full((8, 8, 3), i % 256, np.uint8)).save(tmp_path / "ffhq" / f"{i}.png")
    paths = {"AFHQ": str(tmp_path / "afhq"), "FFHQ": str(tmp_path / "ffhq")}
    for name in ("AFHQ", "FFHQ"):
        got = tdata.get_dataset(name, paths, category=name, image_size=32)
        want = jdata.get_dataset(name, paths, category=name, image_size=32)
        for g, w in zip(got, want):
            assert len(g) == len(w) > 0
            for i in (0, len(w) - 1):
                np.testing.assert_array_equal(g[i], w[i])
