"""The CLIP loss terms beyond the directional one, in the port
(`losses/clip_resnet.py`, the RN50 tower; `losses/clip_loss.py`:
`global_loss`, `angle_loss`, `texture_loss`, `patch_directional_loss`)
against the JAX package, float32 on the CPU.

The towers are tiny: a ViT whose random weights are the port's `state_dict()`
read by the JAX `clip_model.params_from_torch`, and an RN50 of layers
(1, 1, 1, 1), width 16 (the JAX tests' TINY) from a synthetic OpenAI
`visual.*` state dict with non-trivial BatchNorm statistics, read by the
port's `clip_resnet.from_state_dict` and the JAX `params_from_torch`.
The patch term takes explicit centers (the port's own draw is not JAX's).

Tolerance: `close_to_scale` 1e-4 (max error relative to scale), values and
input gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.losses import clip_loss as pl, clip_model as pm, clip_resnet as prn
from asyrp_official_torch.losses import tokenizer as ptok
from asyrp_official_tpu.losses import clip_loss as jl, clip_model as jm, clip_resnet as jrn
from asyrp_official_tpu.losses import tokenizer as jtok

VIT = pm.CLIPConfig(embed_dim=32, image_resolution=16, vision_layers=1, vision_width=64,
                    vision_patch_size=8, context_length=16, transformer_width=64,
                    transformer_heads=1, transformer_layers=1)
RN = prn.RN50Config(layers=(1, 1, 1, 1), width=16, embed_dim=32, heads=4, image_resolution=64)
JRN = jrn.RN50Config(layers=(1, 1, 1, 1), width=16, embed_dim=32, heads=4, image_resolution=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthetic_rn50_sd(cfg, seed=0):
    """An OpenAI-layout `visual.*` RN50 state dict with random weights and
    BatchNorm statistics away from identity."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(k, cin, cout, ks):
        sd[f"visual.{k}.weight"] = (rng.randn(cout, cin, ks, ks)
                                    * (cin * ks * ks) ** -0.5).astype(np.float32)

    def bn(k, c):
        sd[f"visual.{k}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"visual.{k}.bias"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"visual.{k}.running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"visual.{k}.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        sd[f"visual.{k}.num_batches_tracked"] = np.array(7)

    w = cfg.width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)), 1):
        conv(f"conv{i}", cin, cout, 3)
        bn(f"bn{i}", cout)
    inplanes = w
    for li, n in enumerate(cfg.layers):
        planes = w * 2 ** li
        for bi in range(n):
            b = f"layer{li + 1}.{bi}"
            conv(f"{b}.conv1", inplanes, planes, 1)
            bn(f"{b}.bn1", planes)
            conv(f"{b}.conv2", planes, planes, 3)
            bn(f"{b}.bn2", planes)
            conv(f"{b}.conv3", planes, planes * 4, 1)
            bn(f"{b}.bn3", planes * 4)
            if (li > 0 and bi == 0) or inplanes != planes * 4:
                conv(f"{b}.downsample.0", inplanes, planes * 4, 1)
                bn(f"{b}.downsample.1", planes * 4)
            inplanes = planes * 4
    c = w * 32
    ap = "visual.attnpool."
    sd[ap + "positional_embedding"] = (rng.randn(cfg.spacial_dim ** 2 + 1, c)
                                       * c ** -0.5).astype(np.float32)
    for k, out in (("q_proj", c), ("k_proj", c), ("v_proj", c), ("c_proj", cfg.embed_dim)):
        sd[ap + f"{k}.weight"] = (rng.randn(out, c) * c ** -0.5).astype(np.float32)
        sd[ap + f"{k}.bias"] = (0.1 * rng.randn(out)).astype(np.float32)
    sd["logit_scale"] = np.array(4.6, np.float32)  # a text-side entry: ignored
    return sd


@pytest.fixture(scope="module")
def contexts():
    vit = pm.CLIP(VIT, seed=3).eval().requires_grad_(False)
    vsd = {k: v.numpy() for k, v in vit.state_dict().items()}
    vparams, vcfg = jm.params_from_torch(vsd)
    rsd = synthetic_rn50_sd(RN)
    rn = prn.from_state_dict(rsd, RN).requires_grad_(False)
    return {"vit": (pl.CLIPContext(vit, VIT, ptok.HashTokenizer()),
                    jl.CLIPContext(vparams, vcfg, jtok.HashTokenizer())),
            "rn50": (pl.CLIPContext(rn, RN), jl.CLIPContext(jrn.params_from_torch(rsd, JRN), JRN))}


def _images(seed, size=32, b=2):
    return np.random.RandomState(seed).uniform(-1.2, 1.2, (b, size, size, 3)).astype(np.float32)


def test_rn50_encode_image_matches_jax(contexts):
    pctx, jctx = contexts["rn50"]
    x = _images(0, 64)
    want = jrn.encode_image(jctx.params, JRN, jnp.asarray(x))
    got = pctx.model.encode_image(torch.from_numpy(x))
    assert got.shape == (2, 32)
    close_to_scale(np.asarray(want), got.numpy(), "RN50 encode_image")
    # the BatchNorms read their statistics: train() does not switch them
    pctx.model.train()
    assert torch.equal(pctx.model.encode_image(torch.from_numpy(x)), got)


def test_rn50_random_init_and_full_config():
    with torch.device("meta"):
        m = prn.ModifiedResNet(prn.RN50, seed=None)
    # OpenAI's RN50 visual tower: 38,316,896 parameters (the BN statistics are buffers)
    assert sum(p.numel() for p in m.parameters()) == 38_316_896
    tiny = prn.ModifiedResNet(RN, seed=1)
    out = tiny.encode_image(torch.from_numpy(_images(1, 64)))
    assert out.shape == (2, 32) and torch.isfinite(out).all() and out.std() > 0


@pytest.mark.parametrize("norm", [True, False])
def test_encode_images_matches_jax(contexts, norm):
    for name in ("vit", "rn50"):
        pctx, jctx = contexts[name]
        x = _images(1)
        want = jctx.encode_images(jnp.asarray(x), norm=norm)
        got = pctx.encode_images(torch.from_numpy(x), norm=norm)
        close_to_scale(np.asarray(want), got.numpy(), f"{name} encode_images norm={norm}")
        assert np.allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5) == norm


def _terms(contexts):
    """{term: (port loss of (src, trg), JAX loss of (src, trg))}."""
    pv, jv = contexts["vit"]
    pr, jr = contexts["rn50"]
    words = ["a smiling face", "a face", "an angry face"]
    tf = {"p": pv.encode_text(words), "j": jv.encode_text(words)}
    dirs = {"p": tf["p"][:2] - tf["p"][2:], "j": tf["j"][:2] - tf["j"][2:]}
    dirs = {k: v / (v ** 2).sum(-1, keepdims=True) ** 0.5 for k, v in dirs.items()}
    centers = (np.array([12, 20, 16, 14]), np.array([20, 12, 16, 18]))
    return {
        "global": (lambda s, t: pl.global_loss(pv, t, tf["p"][:1]),
                   lambda s, t: jl.global_loss(jv, t, tf["j"][:1])),
        "angle": (lambda s, t: pl.angle_loss(pv, s, t, tf["p"][1:2], tf["p"][:1]),
                  lambda s, t: jl.angle_loss(jv, s, t, tf["j"][1:2], tf["j"][:1])),
        "texture": (lambda s, t: pl.texture_loss(pr, s, t),
                    lambda s, t: jl.texture_loss(jr, s, t)),
        "patch": (lambda s, t: pl.patch_directional_loss(pv, s, t, dirs["p"], patch_size=16,
                                                         num_patches=2, centers=centers),
                  lambda s, t: jl.patch_directional_loss(jv, s, t, dirs["j"], None,
                                                         patch_size=16, num_patches=2,
                                                         centers=centers)),
    }


@pytest.mark.parametrize("term", ["global", "angle", "texture", "patch"])
def test_loss_term_and_its_input_gradients_match_jax(contexts, term):
    p_loss, j_loss = _terms(contexts)[term]
    src, trg = _images(2), _images(3)
    want, (want_gs, want_gt) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(
        jnp.asarray(src), jnp.asarray(trg))
    s, t = (torch.from_numpy(a).requires_grad_(True) for a in (src, trg))
    got = p_loss(s, t)
    got_gs, got_gt = torch.autograd.grad(got, (s, t), allow_unused=True)
    close_to_scale(np.asarray(want), got.detach().numpy().reshape(()), f"{term} value")
    close_to_scale(np.asarray(want_gt), got_gt.numpy(), f"{term} d/d trg")
    if term == "global":  # the source image is not an input of the global term
        assert got_gs is None and not np.any(np.asarray(want_gs))
    else:
        close_to_scale(np.asarray(want_gs), got_gs.numpy(), f"{term} d/d src")


def test_texture_loss_is_zero_on_equal_images(contexts):
    pctx, _ = contexts["rn50"]
    a = torch.from_numpy(_images(4))
    assert float(pl.texture_loss(pctx, a, a)) == 0.0


def test_patch_centers_drawn_from_a_generator(contexts):
    """Without centers the patches are drawn from a torch.Generator: the same
    seed gives the same loss, and every patch lies inside the image."""
    pctx, _ = contexts["vit"]
    p_loss = _terms(contexts)["patch"][0]
    src, trg = torch.from_numpy(_images(5)), torch.from_numpy(_images(6))
    gen = torch.Generator().manual_seed(0)
    d = torch.nn.functional.normalize(torch.randn(2, 32, generator=gen), dim=-1)
    draw = lambda seed: pl.patch_directional_loss(
        pctx, src, trg, d, torch.Generator().manual_seed(seed), patch_size=16, num_patches=3)
    assert float(draw(1)) == float(draw(1))
    assert np.isfinite(float(draw(2)))
    assert np.isfinite(float(p_loss(src, trg)))
