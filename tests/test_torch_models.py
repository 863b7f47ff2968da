"""The port's DDPM++ UNet, DeltaBlock and weight bridge against the JAX
package on the tiny DDPM++ config (utils/tinyws.py: 32^2, ch 32, attention
at 16^2), float32 on the CPU. Both sides start from the same seeded
`hostrng` init, bridged into the port by compat/from_jax.py.

Tolerance: `close_to_scale` 1e-4 (max error relative to the array's scale).
"""
import dataclasses

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
from asyrp_official_torch.models import ddpmpp as tddpmpp
from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_tpu.compat.torch_convert import convert_ddpmpp
from asyrp_official_tpu.models import common as jcm
from asyrp_official_tpu.models import ddpmpp as jddpmpp
from asyrp_official_tpu.models import delta as jdelta
from asyrp_official_tpu.utils import hostrng
from asyrp_official_tpu.utils.tinyws import TINY_DDPMPP_CONFIG

SPEC = spec_from_config(TINY_DDPMPP_CONFIG)
CFG = SPEC.config
JCFG = jddpmpp.DDPMppConfig(**{f: getattr(CFG, f) for f in (
    "ch", "out_ch", "ch_mult", "num_res_blocks", "attn_resolutions", "dropout", "in_channels",
    "resolution", "resamp_with_conv")})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool on top of them oversubscribes the CPU, and these small
    convolutions then spend their time synchronising threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.fixture(scope="module")
def jparams():
    return jddpmpp.init(hostrng.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def model(jparams):
    m = SPEC.build()
    m.load_state_dict(ddpmpp_state_dict_from_jax(jparams))
    return m.eval().requires_grad_(False)


def _blocks(n=1, seed=5):
    jblocks = tuple(jdelta.delta_block_init(hostrng.PRNGKey(seed + i), CFG.bottleneck_ch,
                                            CFG.temb_ch) for i in range(n))
    tblocks = []
    for jb in jblocks:
        b = tdelta.DeltaBlock(CFG.bottleneck_ch, CFG.temb_ch)
        b.load_state_dict(delta_block_state_dict_from_jax(jb))
        tblocks.append(b.eval())
    return jblocks, tuple(tblocks)


def test_port_init_is_bit_identical_to_jax_init(jparams):
    tparams = tddpmpp.init_params(hostrng.PRNGKey(0), CFG)
    assert jax.tree_util.tree_structure(tparams) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(_leaves(jparams), _leaves(tparams)):
        np.testing.assert_array_equal(np.asarray(a), b)
    jb = jdelta.delta_block_init(hostrng.PRNGKey(9), 64, 128)
    tb = tdelta.delta_block_init(hostrng.PRNGKey(9), 64, 128)
    for a, b in zip(_leaves(jb), _leaves(tb)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_state_dict_round_trip(model):
    """port state_dict → convert_ddpmpp (JAX layout) → from_jax → identical."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = ddpmpp_state_dict_from_jax(convert_ddpmpp(sd, JCFG))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_timestep_embedding_matches_jax():
    from asyrp_official_torch.models import common as tcm

    t = np.array([0.0, 17.0, 500.0, 999.0], np.float32)
    close_to_scale(np.asarray(jcm.timestep_embedding_ddpm(jnp.asarray(t), 128)),
                   tcm.timestep_embedding_ddpm(torch.from_numpy(t), 128).numpy(), "temb")


def _inputs(b=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 32, 32, 3).astype(np.float32)
    t = np.array([999.0, 400.0][:b] + [10.0] * max(0, b - 2), np.float32)
    return x, t


def test_apply_without_edit_matches_jax(jparams, model):
    x, t = _inputs()
    eps_j, _, _, mid_j = jddpmpp.apply(jparams, JCFG, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        eps_t, none1, none2, mid_t = model.apply(torch.from_numpy(x), torch.from_numpy(t))
    assert none1 is None and none2 is None
    close_to_scale(np.asarray(eps_j), eps_t.numpy(), "eps")
    close_to_scale(np.asarray(mid_j), mid_t.numpy(), "middle_h")


@pytest.mark.parametrize("decode_mode", ["auto", "split"])
@pytest.mark.parametrize("use_delta", [0.0, 1.0])
@pytest.mark.parametrize("per_sample", [False, True])
def test_apply_with_edit_matches_jax(jparams, model, decode_mode, use_delta, per_sample):
    x, t = _inputs()
    jblocks, tblocks = _blocks()
    coeff = np.array([[1.0, 0.7], [0.9, 1.3]], np.float32) if per_sample else np.array([1.0, 0.8], np.float32)
    jedit = jdelta.EditState(blocks=jblocks, hs_coeff=jnp.asarray(coeff), use_delta=use_delta)
    tedit = tdelta.EditState(blocks=tblocks, hs_coeff=torch.from_numpy(coeff), use_delta=use_delta)
    want = jddpmpp.apply(jparams, JCFG, jnp.asarray(x), jnp.asarray(t), edit=jedit,
                         decode_mode=decode_mode)
    with torch.no_grad():
        got = model.apply(torch.from_numpy(x), torch.from_numpy(t), edit=tedit,
                          decode_mode=decode_mode)
    for w, g, name in zip(want, got, ("eps", "eps_mod", "delta_h", "middle_h")):
        close_to_scale(np.asarray(w), g.numpy(), name)
    if use_delta == 0.0:
        np.testing.assert_array_equal(got[0].numpy(), got[1].numpy())


@pytest.mark.parametrize("n_blocks", [1, 2])
@pytest.mark.parametrize("ignore_timestep", [False, True])
def test_apply_edit_matches_jax(n_blocks, ignore_timestep):
    rng = np.random.RandomState(7)
    h = rng.randn(2, 16, 16, CFG.bottleneck_ch).astype(np.float32)
    temb = rng.randn(2, CFG.temb_ch).astype(np.float32)
    jblocks, tblocks = _blocks(n_blocks)
    coeff = np.linspace(0.5, 1.5, n_blocks + 1).astype(np.float32)
    jh2, jdh = jdelta.apply_edit(
        jdelta.EditState(blocks=jblocks, hs_coeff=jnp.asarray(coeff), ignore_timestep=ignore_timestep),
        jnp.asarray(h), jnp.asarray(temb))
    with torch.no_grad():
        th2, tdh = tdelta.apply_edit(
            tdelta.EditState(blocks=tblocks, hs_coeff=torch.from_numpy(coeff),
                             ignore_timestep=ignore_timestep),
            torch.from_numpy(np.ascontiguousarray(h.transpose(0, 3, 1, 2))), torch.from_numpy(temb))
    close_to_scale(np.asarray(jh2), th2.numpy().transpose(0, 2, 3, 1), "h2")
    close_to_scale(np.asarray(jdh), tdh.numpy().transpose(0, 2, 3, 1), "delta_h")


def test_apply_edit_casts_coefficients_to_bf16():
    _, tblocks = _blocks()
    h = torch.randn(1, CFG.bottleneck_ch, 16, 16, dtype=torch.bfloat16)
    temb = torch.randn(1, CFG.temb_ch, dtype=torch.bfloat16)
    tblocks[0].to(torch.bfloat16)
    h2, dh = tdelta.apply_edit(tdelta.EditState(blocks=tblocks, hs_coeff=torch.tensor([1.0, 0.5])),
                               h, temb)
    assert h2.dtype == torch.bfloat16 and dh.dtype == torch.bfloat16


def test_unported_modes_raise():
    # every edit mode of the JAX package is ported (the global and
    # interp_batch modes: tests/test_torch_extra_modes.py); another raises
    with pytest.raises(ValueError, match="unknown edit mode"):
        tdelta.apply_edit(tdelta.EditState(mode="global_v2"), torch.zeros(1, 8, 2, 2), None)
    from asyrp_official_torch.models.registry import resolve

    # the OpenAI family serves (its own tests: test_torch_openai.py,
    # test_torch_imagenet.py); the class-conditional IMAGENET UNet's random
    # init is JAX's, here at IMAGENET's depth and attention levels, narrow
    assert resolve("FFHQ").family == "openai" and resolve("FFHQ").learn_sigma
    spec = resolve("IMAGENET")
    assert spec.config.num_classes == 1000 and spec.learn_sigma
    narrow = dataclasses.replace(spec.config, image_size=64, model_channels=32, num_classes=10)
    from asyrp_official_tpu.models import openai_unet as joai

    jnarrow = joai.OpenAIUNetConfig(**dataclasses.asdict(narrow))
    got = dataclasses.replace(spec, config=narrow).init(hostrng.PRNGKey(0))
    want = joai.init(hostrng.PRNGKey(0), jnarrow)
    la, lb = jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in la] == [p for p, _ in lb] and "label_emb" in got
    for (path, w), (_, g) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(w), g, err_msg=str(path))
    assert resolve("CelebA_HQ").config == tddpmpp.CELEBA_CONFIG
