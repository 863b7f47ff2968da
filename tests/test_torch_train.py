"""The port's Δ-training against the JAX package, float32 on the CPU:

  * the tiny `--run_train --train_delta_block --do_test 0 --n_iter 2` recipe
    of tests/test_train_determinism.py through the port's CLI on
    `--device cpu` reproduces the JAX package's committed trained block
    tests/golden/tiny_delta_golden.npz;
  * one `make_train_step` call with a tiny CLIP directional term matches the
    JAX `pipelines/train.make_train_step` on the same (bridged) UNet, CLIP
    and DeltaBlock weights: the per-step losses and the trained block, in
    float32 and (at the looser bounds stated there) with --bf16;
  * the origin cache gives the same training as recomputing the origins.

Tolerance: `close_to_scale` 1e-4 (max error relative to scale) in
float32, the golden's own bound.
"""
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.compat.from_jax import ddpmpp_state_dict_from_jax
from asyrp_official_torch.core.schedule import make_schedule as p_make_schedule
from asyrp_official_torch.losses import clip_loss as pl, clip_model as pm, tokenizer as ptok
from asyrp_official_torch.models.delta import EditState as PEdit, init_delta_blocks
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import train as ptr
from asyrp_official_tpu.core.schedule import make_schedule, train_seq
from asyrp_official_tpu.losses import clip_loss as jl, clip_model as jm, tokenizer as jtok
from asyrp_official_tpu.models import ddpmpp as jddpmpp
from asyrp_official_tpu.models.delta import EditState as JEdit, delta_block_init
from asyrp_official_tpu.models.registry import ModelSpec
from asyrp_official_tpu.pipelines import train as jtr
from asyrp_official_tpu.utils import hostrng
from asyrp_official_tpu.utils.tinyws import TINY_DDPMPP_CONFIG, tiny_base_argv, write_tiny_workspace

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "tiny_delta_golden.npz"
SPEC = spec_from_config(TINY_DDPMPP_CONFIG)
CFG = SPEC.config
JSPEC = ModelSpec("ddpmpp", jddpmpp.DDPMppConfig(**{f: getattr(CFG, f) for f in (
    "ch", "out_ch", "ch_mult", "num_res_blocks", "attn_resolutions", "dropout", "in_channels",
    "resolution", "resamp_with_conv")}), False, "ddpm")
CLIP_CFG = pm.CLIPConfig(embed_dim=32, image_resolution=16, vision_layers=1, vision_width=64,
                         vision_patch_size=8, context_length=16, transformer_width=64,
                         transformer_heads=1, transformer_layers=1)
T_EDIT, LR, SEED = 500, 0.05, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_training_reproduces_the_jax_golden(tmp_path):
    from asyrp_official_torch.cli.main import main
    from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint

    cfg, imgs = write_tiny_workspace(str(tmp_path))
    assert main(tiny_base_argv(cfg, imgs, str(tmp_path), str(tmp_path / "runs" / "exp"), extra=[
        "--run_train", "--train_delta_block", "--do_test", "0", "--n_iter", "2",
        "--device", "cpu"])) == 0
    blocks = load_delta_checkpoint(
        os.path.join(tmp_path, "checkpoint", "exp_LC_CUSTOM_t999_ninv4_ngen4_1.pth"))["blocks"]
    g = np.load(GOLDEN)
    assert len(g.files) == 8
    for k in g.files:
        i, group, leaf = k.split("/")
        close_to_scale(g[k], blocks[int(i)][group][leaf], k)


@pytest.fixture(scope="module")
def setup():
    params = SPEC.init(hostrng.PRNGKey(0))  # JAX-layout numpy, the JAX init's draws
    model = SPEC.build()
    model.load_state_dict(ddpmpp_state_dict_from_jax(params))
    model.eval().requires_grad_(False)
    clip = pm.CLIP(CLIP_CFG, seed=1).eval().requires_grad_(False)
    jclip, jcfg = jm.params_from_torch({k: v.numpy() for k, v in clip.state_dict().items()})
    rng = np.random.RandomState(0)
    x_lat = rng.randn(2, 32, 32, 3).astype(np.float32)
    x0 = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    return dict(params=jax.tree.map(jnp.asarray, params), model=model,
                pctx=pl.CLIPContext(clip, CLIP_CFG, ptok.HashTokenizer()),
                jctx=jl.CLIPContext(jclip, jcfg, jtok.HashTokenizer()),
                seq=train_seq(8, 999, T_EDIT)[0], x_lat=x_lat, x0=x0)


def _port_step(s, cached_origin, compute_dtype=torch.float32, l1_w=3.0):
    (block,) = init_delta_blocks(SEED, 1, CFG.bottleneck_ch, CFG.temb_ch)
    edit = PEdit(blocks=(block.train(),), hs_coeff=torch.tensor([1.0, 1.0]))
    extra = pl.train_clip_term(s["pctx"], "face", "smiling face", 1.0)
    step = ptr.make_train_step(
        SPEC, p_make_schedule(), s["seq"], t_edit=T_EDIT, cached_origin=cached_origin,
        compute_dtype=compute_dtype,
        loss_fn=lambda a, b, c: ptr.default_loss(a, b, c, l1_w=l1_w, cosine=0.9, extra=extra))
    opt = ptr.make_optimizer(block.parameters(), 1.0)
    x_lat, x0 = torch.from_numpy(s["x_lat"]), torch.from_numpy(s["x0"])
    origins = step.compute_origins(s["model"], x_lat) if cached_origin else None
    metrics = step(s["model"], edit, opt, x_lat, x0, LR, *([origins] if cached_origin else []))
    return metrics, {k: v.detach().numpy() for k, v in block.state_dict().items()}


def _jax_step(s, compute_dtype=jnp.float32, l1_w=3.0):
    block = delta_block_init(hostrng.PRNGKey(SEED), CFG.bottleneck_ch, CFG.temb_ch)
    edit = JEdit(blocks=(jax.tree.map(jnp.asarray, block),), hs_coeff=jnp.array([1.0, 1.0]))
    extra = jl.train_clip_term(s["jctx"], "face", "smiling face", 1.0)
    opt = jtr.make_optimizer(LR)
    step = jtr.make_train_step(
        JSPEC, make_schedule(), s["seq"], t_edit=T_EDIT, optimizer=opt,
        compute_dtype=compute_dtype,
        loss_fn=lambda a, b, c: jtr.default_loss(a, b, c, l1_w=l1_w, cosine=0.9, extra=extra))
    edit, _, metrics = step(s["params"], edit, opt.init(edit.blocks), jnp.asarray(s["x_lat"]),
                            jnp.asarray(s["x0"]), LR)
    jblock = edit.blocks[0]
    trained = {"conv1.weight": jblock["conv1"]["w"].T[:, :, None, None],
               "conv1.bias": jblock["conv1"]["b"], "temb_proj.weight": jblock["temb_proj"]["w"].T,
               "temb_proj.bias": jblock["temb_proj"]["b"], "norm2.weight": jblock["norm2"]["scale"],
               "norm2.bias": jblock["norm2"]["bias"],
               "conv2.weight": jblock["conv2"]["w"].T[:, :, None, None],
               "conv2.bias": jblock["conv2"]["b"]}
    return np.asarray(metrics["loss_per_step"]), {k: np.asarray(v) for k, v in trained.items()}


def _updates(trained):
    """The update itself, lr * sum of the step gradients, per leaf."""
    init = init_delta_blocks(SEED, 1, CFG.bottleneck_ch, CFG.temb_ch)[0].state_dict()
    return {k: trained[k] - init[k].numpy() for k in init}


def test_make_train_step_with_clip_term_matches_jax(setup):
    s = setup
    want_losses, want = _jax_step(s)
    got, sd = _port_step(s, cached_origin=False)
    assert got["loss_per_step"].shape == (len(s["seq"]),)
    close_to_scale(want_losses, got["loss_per_step"].numpy(), "losses")
    want_up, got_up = _updates(want), _updates(sd)
    for k in want_up:
        close_to_scale(want_up[k], got_up[k], k)


@pytest.mark.parametrize("l1_w", [3.0, 0.0], ids=["l1_and_clip", "clip_only"])
def test_make_train_step_bf16_matches_jax(setup, l1_w):
    """--bf16: the UNet, the DeltaBlock and hs_coeff in bfloat16 on the grad
    path, the DDIM update and CLIP in float32, in both frameworks. The two
    round at different places, so the per-step losses agree to 5e-3 of
    scale (measured 9e-4), and the updates only to the size of the bf16
    rounding itself: with the L1 term the sign of x0_t - x0_t_origin flips
    on noise-level elements and the updates differ as much as bf16 and f32
    do (~0.18), so they are compared for the CLIP term alone, at 0.1 of
    scale (measured 0.04, also the bf16-vs-f32 gap): a gross bf16-only fault
    (a lost cast, a dropped Δh, a wrong sign) fails, rounding does not."""
    s = setup
    want_losses, want = _jax_step(s, jnp.bfloat16, l1_w)
    got, sd = _port_step(s, cached_origin=False, compute_dtype=torch.bfloat16, l1_w=l1_w)
    got_losses = got["loss_per_step"].numpy()
    assert np.isfinite(got_losses).all()
    close_to_scale(want_losses, got_losses, "bf16 losses", bound=5e-3)
    if l1_w == 0.0:
        want_up, got_up = _updates(want), _updates(sd)
        for k in want_up:
            close_to_scale(want_up[k], got_up[k], f"bf16 update {k}", bound=0.1)


def test_origin_cache_trains_as_recomputing(setup):
    want, want_sd = _port_step(setup, cached_origin=False)
    got, got_sd = _port_step(setup, cached_origin=True)
    torch.testing.assert_close(got["loss_per_step"], want["loss_per_step"], rtol=0, atol=0)
    for k in want_sd:
        np.testing.assert_array_equal(got_sd[k], want_sd[k], err_msg=k)
