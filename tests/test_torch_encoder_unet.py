"""The port's ADM library models (`models/encoder_unet.py`: EncoderUNet with
its four pool heads, SuperRes) against the JAX package's `encoder_unet`, on
the CPU, on the tiny config of tests/test_encoder_unet_parity.py (32^2, ch
32, mult (1, 2), heads of 16, attention at 16^2, 10 classes). The inits
are compared bit for bit; the forwards run on the init with its all-zero
layers (the resblocks' output convs, the attention `proj_out`, the
adaptive head) redrawn (`perturbed`), at 1e-4 of scale (`close_to_scale`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale
from test_torch_openai import perturbed

from asyrp_official_torch.compat.from_jax import (encoder_state_dict_from_jax,
                                                  openai_unet_state_dict_from_jax)
from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models import encoder_unet as tenc
from asyrp_official_torch.models import openai_unet as toai
from asyrp_official_tpu.models import delta as jdelta
from asyrp_official_tpu.models import encoder_unet as jenc
from asyrp_official_tpu.models import openai_unet as joai
from asyrp_official_tpu.utils import hostrng

TINY = dict(image_size=32, in_channels=3, model_channels=32, out_channels=10,
            num_res_blocks=1, channel_mult=(1, 2), num_head_channels=16,
            use_scale_shift_norm=True, resblock_updown=True, dropout=0.0)
POOLS = ["adaptive", "attention", "spatial", "spatial_v2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(pool):
    return (jenc.EncoderUNetConfig(attention_ds=(2,), pool=pool, **TINY),
            tenc.EncoderUNetConfig(attention_ds=(2,), pool=pool, **TINY))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _leaves_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(p))


def _encoder(params, cfg):
    m = tenc.EncoderUNet(cfg)
    m.load_state_dict(encoder_state_dict_from_jax(params, cfg))  # strict: every key
    return m.eval().requires_grad_(False)


@pytest.mark.parametrize("pool", POOLS)
def test_encoder_init_bit_identical_to_jax(pool):
    """The same draws in the same order, the attention pool's normal
    positional embedding ([T+1, C] = [257, 64]) included."""
    jcfg, tcfg = _cfgs(pool)
    tp = tenc.encoder_init(hostrng.PRNGKey(0), tcfg)
    _leaves_equal(jenc.encoder_init(hostrng.PRNGKey(0), jcfg), tp)
    if pool == "attention":
        pe = tp["out"]["pool"]["positional_embedding"]
        assert pe.shape == (257, 64) and 0.09 < float(pe.std()) < 0.16  # N(0, 1) / 8


@pytest.mark.parametrize("pool", POOLS)
def test_encoder_apply_matches_jax(pool):
    jcfg, tcfg = _cfgs(pool)
    params = perturbed(tenc.encoder_init(hostrng.PRNGKey(0), tcfg))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32) * 0.5
    t = np.array([300.0, 700.0], np.float32)
    want = np.asarray(jenc.encoder_apply(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x),
                                         jnp.asarray(t)))
    with torch.no_grad():
        got = _encoder(params, tcfg).apply(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, 10)
    assert np.abs(want).max() > 0.05
    close_to_scale(want, got, f"{pool} logits")


@pytest.mark.parametrize("pool", POOLS)
def test_encoder_state_dict_round_trips_through_the_jax_converter(pool):
    """`encoder_state_dict_from_jax` → the module's state dict under the
    reference's keys → JAX `encoder_params_from_torch` → the same tree."""
    jcfg, tcfg = _cfgs(pool)
    params = perturbed(tenc.encoder_init(hostrng.PRNGKey(1), tcfg))
    sd = {k: v.numpy() for k, v in _encoder(params, tcfg).state_dict().items()}
    assert sorted(sd) == sorted(encoder_state_dict_from_jax(params, tcfg))
    _leaves_equal(jenc.encoder_params_from_torch(sd, jcfg), params)


@pytest.mark.parametrize("low", [(16, 16), (8, 8), (12, 20), (32, 32)])
def test_bilinear_upsample_matches_jax_image_resize(low):
    """`F.interpolate(bilinear, align_corners=False, antialias=False)` is
    `jax.image.resize(..., "bilinear")` for an upsample (2x, 4x, uneven
    factors, and the identity)."""
    rng = np.random.RandomState(2)
    lr = rng.randn(2, *low, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(lr), (2, 32, 32, 3), method="bilinear"))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(lr).permute(0, 3, 1, 2), size=(32, 32), mode="bilinear",
        align_corners=False, antialias=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_superres_apply_matches_jax():
    """SuperRes: the UNet on [x ; bilinear(low_res)], plain and edited."""
    j = joai.OpenAIUNetConfig(image_size=32, model_channels=32, out_channels=6, num_res_blocks=1,
                              attention_ds=(2,), channel_mult=(1, 2), num_head_channels=16)
    t_cfg = toai.OpenAIUNetConfig(**{f.name: getattr(j, f.name)
                                     for f in dataclasses.fields(toai.OpenAIUNetConfig)})
    jcfg, tcfg = jenc.superres_config(j), tenc.superres_config(t_cfg)
    assert tcfg.in_channels == 6
    params = perturbed(toai.init_params(hostrng.PRNGKey(4), tcfg))
    model = toai.OpenAIUNet(tcfg)
    model.load_state_dict(openai_unet_state_dict_from_jax(params, tcfg))
    model.eval().requires_grad_(False)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    low = rng.randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([900.0, 100.0], np.float32)
    block = jdelta.delta_block_init(hostrng.PRNGKey(3), 64, 128, flavor="openai")
    coeff = np.array([1.0, 1.5], np.float32)
    edits = (
        (None, None),
        (jdelta.EditState(blocks=(jax.tree.map(jnp.asarray, block),),
                          hs_coeff=jnp.asarray(coeff), flavor="openai"),
         tdelta.EditState(blocks=(tdelta.delta_block_from_tree(block, 64, 128,
                                                               flavor="openai").eval(),),
                          hs_coeff=torch.from_numpy(coeff), flavor="openai")))
    for jedit, tedit in edits:
        want = jenc.superres_apply(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x),
                                   jnp.asarray(t), jnp.asarray(low), edit=jedit)
        with torch.no_grad():
            got = tenc.superres_apply(model, torch.from_numpy(x), torch.from_numpy(t),
                                      torch.from_numpy(low), edit=tedit)
        for w, g, name in zip(want, got, ("eps", "eps_mod", "delta_h", "middle_h")):
            if w is None:
                assert g is None
                continue
            close_to_scale(np.asarray(w), g.numpy(), f"superres {name}")
        assert got[0].shape == (2, 32, 32, 6) and float(got[0].std()) > 0.1
    with pytest.raises(ValueError, match="upsample"):
        tenc.superres_apply(model, torch.from_numpy(low), torch.from_numpy(t),
                            torch.from_numpy(x))
