"""The port's CLIP (asyrp_official_torch.losses) against the JAX package's,
on a tiny ViT whose random weights are the port's `state_dict()` read by
the JAX `clip_model.params_from_torch`: both image and text towers, the
bicubic CLIP preprocess, the text direction, the directional loss and its
gradient with respect to the edited image, and the training CLIP term.

Tolerance: `close_to_scale` 1e-4 (max error relative to scale), float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.losses import clip_loss as pl, clip_model as pm, tokenizer as ptok
from asyrp_official_tpu.losses import clip_loss as jl, clip_model as jm, tokenizer as jtok

TINY = pm.CLIPConfig(embed_dim=32, image_resolution=16, vision_layers=2, vision_width=64,
                     vision_patch_size=8, context_length=16, transformer_width=128,
                     transformer_heads=2, transformer_layers=2)
PROMPTS = ["a photo of a smiling face", "face", "a sad person with glasses"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def towers():
    model = pm.CLIP(TINY, seed=3).eval().requires_grad_(False)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, cfg = jm.params_from_torch(sd)
    return (pl.CLIPContext(model, TINY, ptok.HashTokenizer()),
            jl.CLIPContext(params, cfg, jtok.HashTokenizer()), sd)


def _images(seed, size=32):
    return np.random.RandomState(seed).uniform(-1.2, 1.2, (2, size, size, 3)).astype(np.float32)


def test_config_from_torch_matches_jax(towers):
    _, _, sd = towers
    got, want = pm.config_from_torch(sd), jm.config_from_torch(sd)
    assert dataclass_items(got) == dataclass_items(want)
    assert got == TINY


def dataclass_items(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


@pytest.mark.parametrize("size", [16, 24, 32])
def test_clip_preprocess_matches_jax(size):
    img = _images(1, size)
    close_to_scale(np.asarray(jl.clip_preprocess(jnp.asarray(img), 16)),
                   pl.clip_preprocess(torch.from_numpy(img), 16).numpy(), f"preprocess {size}")


def test_encode_image_matches_jax(towers):
    pctx, jctx, _ = towers
    x = np.array(jl.clip_preprocess(jnp.asarray(_images(2)), 16))
    want = jm.encode_image(jctx.params, jctx.cfg, jnp.asarray(x))
    got = pctx.model.encode_image(torch.from_numpy(x))
    close_to_scale(np.asarray(want), got.numpy(), "encode_image")


def test_encode_text_matches_jax(towers):
    pctx, jctx, _ = towers
    tokens = jtok.tokenize(PROMPTS, jtok.HashTokenizer(), TINY.context_length)
    np.testing.assert_array_equal(tokens, pctx.tokenize(PROMPTS).numpy())
    want = jm.encode_text(jctx.params, jctx.cfg, jnp.asarray(tokens))
    got = pctx.model.encode_text(torch.from_numpy(tokens.astype(np.int64)))
    close_to_scale(np.asarray(want), got.numpy(), "encode_text")


def test_text_direction_and_cosine_match_jax(towers):
    pctx, jctx, _ = towers
    close_to_scale(np.asarray(jctx.compute_text_direction("face", "smiling face")),
                   pctx.compute_text_direction("face", "smiling face").numpy(), "text direction")
    want = jctx.text_cosine(PROMPTS[:1], PROMPTS[1:2])
    assert abs(pctx.text_cosine(PROMPTS[:1], PROMPTS[1:2]) - want) <= 1e-5 * max(1.0, abs(want))


def test_directional_loss_and_its_image_gradient_match_jax(towers):
    pctx, jctx, _ = towers
    src, trg = _images(3), _images(4)
    direction = np.array(jctx.compute_text_direction("face", "smiling face"))

    def jloss(t):
        return jl.directional_loss(jctx, jnp.asarray(src), t, jnp.asarray(direction))

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(trg))
    trg_t = torch.from_numpy(trg).requires_grad_()
    got = pl.directional_loss(pctx, torch.from_numpy(src), trg_t, torch.from_numpy(direction))
    got.backward()
    close_to_scale(np.asarray(want)[None], got.detach().numpy()[None], "directional loss")
    close_to_scale(np.asarray(want_grad), trg_t.grad.numpy(), "d loss / d image")


def test_train_clip_term_matches_jax(towers):
    pctx, jctx, _ = towers
    src, trg = _images(5), _images(6)
    want = jl.train_clip_term(jctx, "face", "smiling face", 0.7)(jnp.asarray(src), jnp.asarray(trg))
    got = pl.train_clip_term(pctx, "face", "smiling face", 0.7)(torch.from_numpy(src),
                                                                torch.from_numpy(trg))
    close_to_scale(np.asarray(want)[None], got.numpy()[None], "train clip term")
