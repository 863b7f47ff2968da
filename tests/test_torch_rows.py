"""The port's h-rows path against the JAX package, on the CPU at the tiny
DDPM++ workspace (`asyrp_official_tpu.utils.tinyws`):

  * `utils/hostrng.normal` against `jax.random.normal`, bit for bit;
  * `slerp` (zero and colinear inputs too) and `apply_edit` in the `input`
    mode (add, the norm-matched slerp, the masked slerp; f32, bf16 and
    per-sample [B, K] coefficients);
  * `make_edit_generate` with sparse `delta_times` (a gate that is not a
    prefix) and with `collect=("delta_h",)`;
  * `make_train_step(train_target="rows")`, and the dead `--delta_injection
    slerp` training (hs_coeff [1, 1]: the rows must come back bit for bit);
  * the CLI end to end: `--run_train --train_delta_h` (rows `.pth`, the
    training and test grids) and `--run_test --train_delta_h` on another
    grid (the train→test row remap), add and slerp, against the JAX CLI.

Tolerance: `close_to_scale` 1e-4 (max error relative to scale) at f32,
grids within one uint8 level; bf16 as stated in its test.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from parity_utils import close_to_scale

from asyrp_official_torch.compat.from_jax import ddpmpp_state_dict_from_jax
from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import engine as tengine, train as ttr
from asyrp_official_torch.utils import hostrng as trng
from asyrp_official_tpu.compat.delta_ckpt import load_delta_checkpoint
from asyrp_official_tpu.core.schedule import make_schedule, train_seq, uniform_seq
from asyrp_official_tpu.core.steptable import generation_table
from asyrp_official_tpu.models import ddpmpp as jddpmpp
from asyrp_official_tpu.models import delta as jdelta
from asyrp_official_tpu.models.registry import ModelSpec as JModelSpec
from asyrp_official_tpu.pipelines import engine as jengine, train as jtr
from asyrp_official_tpu.utils import hostrng
from asyrp_official_tpu.utils.tinyws import TINY_DDPMPP_CONFIG, tiny_base_argv, write_tiny_workspace

SPEC = spec_from_config(TINY_DDPMPP_CONFIG)
CFG = SPEC.config
JCFG = jddpmpp.DDPMppConfig(ch=CFG.ch, ch_mult=CFG.ch_mult, num_res_blocks=CFG.num_res_blocks,
                            attn_resolutions=CFG.attn_resolutions, resolution=CFG.resolution)
JSPEC = JModelSpec("ddpmpp", JCFG, False, "ddpm")
SCHED = make_schedule()
HW, C = SPEC.bottleneck_hw, SPEC.bottleneck_ch  # 16, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the normal draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (4, 8, 8, 512)), (1, (3, 5)), (42, (200000,)),
                                        (1234, (2, 16, 16, 64)), (2**31 - 1, (7,))])
def test_normal_matches_jax_bit_for_bit(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = trng.normal(trng.PRNGKey(seed), shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_bottleneck_hw_matches_jax():
    assert SPEC.bottleneck_hw == 16
    assert spec_from_config({"data": {"dataset": "AFHQ", "category": "AFHQ", "image_size": 256},
                             "model": {}}).bottleneck_hw == 8


# ---------------------------------------------------------------------------
# slerp and the input edit mode
# ---------------------------------------------------------------------------


def _pair(case):
    rng = np.random.RandomState(0)
    v0 = rng.randn(3, 4, 4, 8).astype(np.float32)
    v1 = rng.randn(3, 4, 4, 8).astype(np.float32)
    if case == "zero_v1":
        v1[1] = 0.0
    elif case == "zero_v0":
        v0[0] = 0.0
    elif case == "colinear":
        v1 = np.float32(2.5) * v0
    return v0, v1


@pytest.mark.parametrize("t", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("case", ["random", "zero_v1", "zero_v0", "colinear"])
def test_slerp_matches_jax(case, t):
    v0, v1 = _pair(case)
    want = np.asarray(jdelta.slerp(jnp.float32(t), jnp.asarray(v0), jnp.asarray(v1)))
    got = tdelta.slerp(torch.tensor(t), torch.from_numpy(v0), torch.from_numpy(v1)).numpy()
    assert np.isfinite(got).all()
    close_to_scale(want, got, f"slerp {case} t={t}")


@pytest.mark.parametrize("case", ["random", "zero_v1", "colinear"])
def test_slerp_backward_is_finite_and_exactly_zero_at_t0(case):
    """t = 0 returns v0 bit for bit with a gradient of exactly 0 to v1 (the
    dead slerp training); at a pole or a zero vector the backward stays
    finite at any t."""
    v0, v1 = _pair(case)
    a = torch.from_numpy(v0)
    b = torch.from_numpy(v1).requires_grad_(True)
    out = tdelta.slerp(torch.tensor(0.0), a, b)
    assert torch.equal(out, a)
    (g,) = torch.autograd.grad((out * torch.randn_like(out)).sum(), b)
    assert torch.all(g == 0)
    (g,) = torch.autograd.grad(tdelta.slerp(torch.tensor(0.4), a, b).sum(), b)
    assert torch.isfinite(g).all()


def _input_case():
    rng = np.random.RandomState(1)
    h = rng.randn(2, HW, HW, C).astype(np.float32)
    rows = (0.2 * rng.randn(3, HW, HW, C)).astype(np.float32)
    rows[0] = 0.0  # the placeholder row of a gated-off step
    return h, rows


def _both_edits(rows, coeff, style, mask, idx, use_delta=1.0):
    j = jdelta.EditState(mode="input", delta_rows=jnp.asarray(rows), hs_coeff=jnp.asarray(coeff),
                         input_style=style, use_mask=mask, use_delta=use_delta, delta_idx=idx)
    t = tdelta.EditState(mode="input", delta_rows=tdelta.rows_to_nchw(rows),
                         hs_coeff=torch.from_numpy(np.asarray(coeff, np.float32)),
                         input_style=style, use_mask=mask, use_delta=use_delta, delta_idx=idx)
    return j, t


STYLES = {"add": ("add", False), "slerp": ("slerp", False), "mask": ("slerp", True)}


@pytest.mark.parametrize("idx", [0, 1, 7])  # the zero row, a row, a clamped index
@pytest.mark.parametrize("style", sorted(STYLES))
def test_apply_edit_input_matches_jax(style, idx):
    h, rows = _input_case()
    coeff = np.array([0.8, 1.3], np.float32)
    jedit, tedit = _both_edits(rows, coeff, *STYLES[style], idx)
    jh2, jdh = jdelta.apply_edit(jedit, jnp.asarray(h), None)
    th2, tdh = tdelta.apply_edit(tedit, _nchw(h), None)
    assert torch.isfinite(th2).all()
    close_to_scale(np.asarray(jh2), _nhwc(th2), f"{style} h2")
    np.testing.assert_array_equal(np.asarray(jdh), _nhwc(tdh))
    # the gate: off gives h back
    tedit.use_delta = 0.0
    th2, _ = tdelta.apply_edit(tedit, _nchw(h), None)
    np.testing.assert_array_equal(_nhwc(th2), h)


@pytest.mark.parametrize("style", sorted(STYLES))
def test_apply_edit_input_bf16_matches_jax(style):
    """h and the coefficients in bfloat16. The two packages round at other
    places (the port takes the slerp's norms and angle in f32), so the
    port's h2 must be no farther from the float32 JAX h2 than twice JAX
    bf16's own distance from it, or one bf16 step (2^-8) of scale."""
    h, rows = _input_case()
    coeff = np.array([0.8, 1.3], np.float32)
    jedit, tedit = _both_edits(rows, coeff, *STYLES[style], 1)
    ref = np.asarray(jdelta.apply_edit(jedit, jnp.asarray(h), None)[0])
    jbf = np.asarray(jdelta.apply_edit(jedit, jnp.asarray(h, jnp.bfloat16), None)[0], np.float32)
    th2, tdh = tdelta.apply_edit(tedit, _nchw(h).to(torch.bfloat16), None)
    assert th2.dtype == torch.bfloat16 and tdh.dtype == torch.bfloat16
    scale = np.abs(ref).max()
    jax_own = np.abs(jbf - ref).max() / scale
    port = np.abs(_nhwc(th2) - ref).max() / scale
    assert port <= max(2.0 * jax_own, 2.0**-8), (style, port, jax_own)


def test_apply_edit_input_per_sample_coefficients():
    """[B, K] coefficients: per-sample add matches JAX; the slerp styles
    refuse them, as in JAX."""
    h, rows = _input_case()
    coeff = np.array([[1.0, 0.5], [0.7, 1.5]], np.float32)
    jedit, tedit = _both_edits(rows, coeff, "add", False, 2)
    jh2, _ = jdelta.apply_edit(jedit, jnp.asarray(h), None)
    th2, _ = tdelta.apply_edit(tedit, _nchw(h), None)
    close_to_scale(np.asarray(jh2), _nhwc(th2), "per-sample add")
    for style, mask in (("slerp", False), ("slerp", True)):
        jedit, tedit = _both_edits(rows, coeff, style, mask, 2)
        with pytest.raises(ValueError, match="per-sample"):
            jdelta.apply_edit(jedit, jnp.asarray(h), None)
        with pytest.raises(ValueError, match="per-sample"):
            tdelta.apply_edit(tedit, _nchw(h), None)


# ---------------------------------------------------------------------------
# engines: sparse delta_times, the delta_h harvest
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jparams = jddpmpp.init(hostrng.PRNGKey(0), JCFG)
    model = SPEC.build()
    model.load_state_dict(ddpmpp_state_dict_from_jax(jparams))
    return jparams, model.eval().requires_grad_(False)


def _jax_noise(rng):
    return lambda step, shape: np.array(
        jax.random.normal(jax.random.fold_in(rng, step), shape, jnp.float32))


SEQ8 = uniform_seq(8, 999)  # 0, 142, 285, 428, 570, 713, 856, 999


@pytest.mark.parametrize("collect", [("x", "x0_t"), ("delta_h",)], ids=["x", "delta_h"])
@pytest.mark.parametrize("style", ["add", "slerp"])
def test_edit_generate_sparse_delta_times_matches_jax(weights, style, collect):
    """Rows at 999, 713 and 428 only: the gate (t >= 300, and a row) has
    holes, so one chain picks the decode per step; a harvest has an entry
    for every step, zero where the gate is off."""
    jparams, model = weights
    times = [999, 713, 428]
    rows = (0.2 * np.random.RandomState(2).randn(3, HW, HW, C)).astype(np.float32)
    table = generation_table(SEQ8, t_edit=300, delta_times=times)
    assert table.edit_prefix_len() is None
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    coeff = np.array([1.0, 1.2], np.float32)
    jedit, tedit = _both_edits(rows, coeff, style, False, 0)
    kw = dict(t_edit=300, t_addnoise=200, delta_times=times, collect=collect)
    want, jys = jengine.make_edit_generate(JSPEC, SCHED, SEQ8, **kw)(
        jparams, jedit, jnp.asarray(x), rng)
    got, tys = tengine.make_edit_generate(SPEC, SCHED, SEQ8, **kw)(
        model, tedit, torch.from_numpy(x), noise_fn=_jax_noise(rng))
    close_to_scale(np.asarray(want), got.numpy(), "x_edit")
    for key in collect:
        assert tys[key].shape == jys[key].shape and tys[key].shape[0] == 8
        close_to_scale(np.asarray(jys[key]), tys[key].numpy(), key)
    if collect == ("delta_h",):
        off = np.asarray(table.use_delta) == 0
        assert off.sum() == 5 and not tys["delta_h"][torch.from_numpy(off)].any()


def test_edit_generate_deltablock_harvest_matches_jax(weights):
    """The harvest of a DeltaBlock edit: the block's Δh at t >= t_edit, 0 below."""
    jparams, model = weights
    jblock = jdelta.delta_block_init(hostrng.PRNGKey(3), C, CFG.temb_ch)
    tblock = tdelta.delta_block_from_tree(jblock, C, CFG.temb_ch).eval()
    coeff = np.array([1.0, 1.5], np.float32)
    x = np.random.RandomState(4).randn(1, 32, 32, 3).astype(np.float32)
    want, jys = jengine.make_edit_generate(JSPEC, SCHED, SEQ8, t_edit=500, collect=("delta_h",))(
        jparams, jdelta.EditState(blocks=(jblock,), hs_coeff=jnp.asarray(coeff)),
        jnp.asarray(x), None)
    got, tys = tengine.make_edit_generate(SPEC, SCHED, SEQ8, t_edit=500, collect=("delta_h",))(
        model, tdelta.EditState(blocks=(tblock,), hs_coeff=torch.from_numpy(coeff)),
        torch.from_numpy(x))
    close_to_scale(np.asarray(want), got.numpy(), "x_edit")
    close_to_scale(np.asarray(jys["delta_h"]), tys["delta_h"].numpy(), "delta_h")
    assert not tys["delta_h"][4:].any() and tys["delta_h"][:4].abs().amax(dim=(1, 2, 3, 4)).min() > 0


def test_gated_off_steps_run_the_plain_decode_bit_for_bit(weights):
    """No step has a row: the per-step chain runs the plain decode
    everywhere and gives the plain generation bit for bit."""
    _, model = weights
    rows = np.ones((1, HW, HW, C), np.float32)
    _, tedit = _both_edits(rows, np.array([1.0, 1.0], np.float32), "add", False, 0)
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 32, 32, 3).astype(np.float32))
    got, _ = tengine.make_edit_generate(SPEC, SCHED, SEQ8, t_edit=0, delta_times=[5])(
        model, tedit, x)
    want, _ = tengine.make_generate(SPEC, SCHED, SEQ8)(model, x)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# make_train_step(train_target="rows")
# ---------------------------------------------------------------------------

T_EDIT, LR = 500, 0.05


def _rows_init(k):
    return np.float32(0.2) * np.asarray(jax.random.normal(jax.random.PRNGKey(9), (k, HW, HW, C)))


def _jax_rows_train(jparams, seq, rows, style, x_lat, x0, lr):
    opt = jtr.make_optimizer(lr)
    step = jtr.make_train_step(JSPEC, SCHED, seq, t_edit=T_EDIT, optimizer=opt, train_target="rows",
                               loss_fn=lambda a, b, c: jtr.default_loss(a, b, c, cosine=0.9))
    edit = jdelta.EditState(mode="input", delta_rows=jnp.asarray(rows),
                            hs_coeff=jnp.array([1.0, 1.0]), input_style=style, times=tuple(seq))
    edit, _, metrics = step(jparams, edit, opt.init(edit.delta_rows), jnp.asarray(x_lat),
                            jnp.asarray(x0), lr)
    return np.asarray(metrics["loss_per_step"]), np.asarray(edit.delta_rows)


def _port_rows_train(model, seq, rows, style, x_lat, x0, lr):
    leaf = tdelta.rows_to_nchw(rows).requires_grad_(True)
    edit = tdelta.EditState(mode="input", delta_rows=leaf, hs_coeff=torch.tensor([1.0, 1.0]),
                            input_style=style, times=tuple(seq))
    step = ttr.make_train_step(SPEC, SCHED, seq, t_edit=T_EDIT, train_target="rows",
                               loss_fn=lambda a, b, c: ttr.default_loss(a, b, c, cosine=0.9))
    metrics = step(model, edit, ttr.make_optimizer([leaf], lr), torch.from_numpy(x_lat),
                   torch.from_numpy(x0), lr)
    return metrics["loss_per_step"].numpy(), tdelta.rows_to_nhwc(leaf)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    return (rng.randn(2, 32, 32, 3).astype(np.float32),
            rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))


def test_make_train_step_rows_matches_jax(weights, batch):
    jparams, model = weights
    seq = train_seq(8, 999, T_EDIT)[0]
    rows = _rows_init(len(seq))
    want_losses, want = _jax_rows_train(jparams, seq, rows, "add", *batch, LR)
    got_losses, got = _port_rows_train(model, seq, rows, "add", *batch, LR)
    close_to_scale(want_losses, got_losses, "losses")
    close_to_scale(want, got, "trained rows")
    assert np.abs(want - rows).max() > 0
    close_to_scale(want - rows, got - rows, "row updates")


def test_rows_training_with_slerp_is_dead_bit_for_bit(weights, batch):
    """hs_coeff [1, 1] makes the slerp's t = 0: the rows' gradient is
    exactly 0, so at any learning rate the rows come back as they went in,
    as in JAX (and the reference)."""
    jparams, model = weights
    seq = train_seq(8, 999, T_EDIT)[0]
    rows = _rows_init(len(seq))
    _, want = _jax_rows_train(jparams, seq, rows, "slerp", *batch, 10.0)
    losses, got = _port_rows_train(model, seq, rows, "slerp", *batch, 10.0)
    assert np.isfinite(losses).all()
    np.testing.assert_array_equal(want, rows)
    np.testing.assert_array_equal(got, rows)


# ---------------------------------------------------------------------------
# the CLI end to end
# ---------------------------------------------------------------------------


def _grids(work):
    out = {}
    for r, _, fs in os.walk(os.path.join(work, "runs")):
        for f in sorted(fs):
            if f.endswith(".png"):
                out[os.path.relpath(os.path.join(r, f), work)] = np.asarray(
                    Image.open(os.path.join(r, f))).astype(np.int16)
    return out


def _argv(ws, *extra):
    return tiny_base_argv(os.path.join(ws, "tiny.yml"), os.path.join(ws, "imgs"), ws,
                          os.path.join(ws, "runs", "exp"), bs_train=1, extra=list(extra))


TRAIN = ["--run_train", "--train_delta_h", "--n_iter", "2", "--do_test", "1", "--save_x_origin"]
CKPT = os.path.join("checkpoint", "exp_LC_CUSTOM_t999_ninv4_ngen4_1.pth")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The rows recipe through both CLIs, one workspace each: training (2
    iterations, --do_test), then serving the trained rows on a 6-step test
    grid (remapped from the 4-step training grid) with add and slerp."""
    from asyrp_official_torch.cli.main import main as port_main
    from asyrp_official_tpu.cli.main import main as jax_main

    out = {}
    for name, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        ws = str(tmp_path_factory.mktemp(f"rows_{name}"))
        write_tiny_workspace(ws)
        assert main(_argv(ws, *TRAIN, *extra)) == 0, name
        for inj in ("add", "slerp"):
            assert main(_argv(ws, "--run_test", "--train_delta_h", "--n_test_step", "6",
                              "--delta_injection", inj, "--do_train", "0", "--save_x_origin",
                              "--exp", os.path.join(ws, "runs", f"serve_{inj}"),
                              "--load_from_checkpoint", "exp", *extra)) == 0, (name, inj)
        out[name] = ws
    return out


def test_cli_rows_training_matches_the_jax_cli(cli_runs):
    want = load_delta_checkpoint(os.path.join(cli_runs["jax"], CKPT))["delta_rows"]
    got = load_delta_checkpoint(os.path.join(cli_runs["port"], CKPT))["delta_rows"]
    assert sorted(got) == sorted(want) == [666, 999]
    seed = 1234  # the CLI default --seed
    init = np.float32(0.2) * trng.normal(trng.PRNGKey(seed), (2, HW, HW, C))
    for i, t in enumerate([666, 999]):
        close_to_scale(want[t], got[t], f"row {t}")
        assert np.abs(got[t] - init[i]).max() > 0, t
    up_want = np.stack([want[t] - init[i] for i, t in enumerate([666, 999])])
    up_got = np.stack([got[t] - init[i] for i, t in enumerate([666, 999])])
    # 8 SGD steps whose f32 sums run in other orders
    close_to_scale(up_want, up_got, "row updates", bound=1e-3)


def test_cli_rows_grids_match_the_jax_cli(cli_runs):
    """Training-time grids, the --do_test grids and the remapped serving
    grids (add and slerp), within one uint8 level."""
    want, got = _grids(cli_runs["jax"]), _grids(cli_runs["port"])
    assert sorted(want) == sorted(got), (sorted(want), sorted(got))
    assert sum("serve_slerp" in k for k in got) == 2 and sum("training_images" in k for k in got) == 2
    for k in got:
        assert np.abs(want[k] - got[k]).max() <= 1, k
