"""The port's kernels (asyrp_official_torch.ops) against the JAX functions
they stand for. On the CPU each wrapper runs its plain PyTorch version;
tests/test_torch_kernels_cuda.py holds the kernels themselves against
their plain versions on a GPU.

Tolerance: `close_to_scale` 1e-4 (max error relative to the array's scale)
in float32. bfloat16 inputs: 1e-2, because the two frameworks round bf16 at
different places (XLA rounds the GroupNorm output before the SiLU, the
port's kernel after it), which is one bf16 ulp (2^-8) of scale.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1
from asyrp_official_torch.ops import ddpm_step as kddpm
from asyrp_official_tpu.core import ddim as jddim
from asyrp_official_tpu.models import common as jcm
from asyrp_official_tpu.models import ddpmpp as jddpmpp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool on top of them oversubscribes the CPU, and these small
    convolutions then spend their time synchronising threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.float().numpy(), (0, 2, 3, 1))


# ---------------------------------------------------------------------------
# K1 GroupNorm(+SiLU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 16, 16, 96), (1, 4, 4, 1024)])
def test_group_norm_plain_matches_jax(shape, silu):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3.0 + 1.5).astype(np.float32)
    c = shape[-1]
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    want = jddpmpp._gn_silu(p, jnp.asarray(x)) if silu else jcm.group_norm(p, jnp.asarray(x), eps=1e-6)
    got = k1.group_norm(_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), silu=silu)
    close_to_scale(np.asarray(want), _nhwc(got), f"group_norm silu={silu}")


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_plain_bf16_matches_jax(silu):
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 8, 8, 64) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(64)).astype(np.float32)
    bias = (0.1 * rng.randn(64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    want = jddpmpp._gn_silu(p, xb) if silu else jcm.group_norm(p, xb, eps=1e-6)
    assert want.dtype == jnp.bfloat16
    got = k1.group_norm(_nchw(x).to(torch.bfloat16), torch.from_numpy(scale),
                        torch.from_numpy(bias), silu=silu)
    assert got.dtype == torch.bfloat16
    close_to_scale(np.asarray(want.astype(jnp.float32)), _nhwc(got), "group_norm bf16", bound=1e-2)


def _gn_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3.0 + 1.5).astype(np.float32)
    c = shape[-1]
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    return x, scale, bias, dy


def _gn_vjp(x, scale, bias, dy, silu):
    """(dx NHWC, dscale, dbias) of the JAX function by jax.vjp."""
    def f(p, xx):
        return jddpmpp._gn_silu(p, xx) if silu else jcm.group_norm(p, xx, eps=1e-6)

    _, vjp = jax.vjp(f, {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(dy))
    return np.asarray(dx), np.asarray(dp["scale"]), np.asarray(dp["bias"])


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 4, 4, 512)])
def test_group_norm_backward_plain_matches_jax_vjp(shape, silu):
    """The hand-derived formula, from the statistics, against XLA's gradient."""
    x, scale, bias, dy = _gn_inputs(shape, 5)
    want = _gn_vjp(x, scale, bias, dy, silu)
    xg = x.reshape(shape[0], -1, 32, shape[-1] // 32).astype(np.float64)
    mean = xg.mean(axis=(1, 3))
    rstd = 1.0 / np.sqrt(xg.var(axis=(1, 3)) + 1e-6)
    dx, dw, db = k1.group_norm_backward_plain(
        _nchw(x), _nchw(dy), torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(mean.astype(np.float32)), torch.from_numpy(rstd.astype(np.float32)),
        silu=silu)
    for w, g, name in zip(want, (_nhwc(dx), dw.numpy(), db.numpy()), ("dx", "dscale", "dbias")):
        close_to_scale(w, g, f"group_norm backward silu={silu} {name}")
    dx_only = k1.group_norm_backward_plain(
        _nchw(x), _nchw(dy), torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(mean.astype(np.float32)), torch.from_numpy(rstd.astype(np.float32)),
        silu=silu, weight_grad=False)
    assert dx_only[1] is None and dx_only[2] is None
    torch.testing.assert_close(dx_only[0], dx, rtol=0, atol=0)


@pytest.mark.parametrize("train_weight", [False, True])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_autograd_matches_jax_vjp(silu, train_weight):
    """`group_norm` under autograd (the path the edited decode and the
    DeltaBlock take), with and without a trained weight."""
    shape = (2, 8, 8, 64)
    x, scale, bias, dy = _gn_inputs(shape, 6)
    want = _gn_vjp(x, scale, bias, dy, silu)
    xt = _nchw(x).requires_grad_()
    w = torch.from_numpy(scale).requires_grad_(train_weight)
    b = torch.from_numpy(bias).requires_grad_(train_weight)
    k1.group_norm(xt, w, b, silu=silu).backward(_nchw(dy))
    close_to_scale(want[0], _nhwc(xt.grad), f"group_norm autograd silu={silu} dx")
    if train_weight:
        close_to_scale(want[1], w.grad.numpy(), "dscale")
        close_to_scale(want[2], b.grad.numpy(), "dbias")
    else:
        assert w.grad is None and b.grad is None


# ---------------------------------------------------------------------------
# K2 attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 64, 32), (1, 256, 512), (1, 64, 512)])
def test_attention_plain_matches_jax(shape):
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    want = jcm.spatial_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = k2.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    close_to_scale(np.asarray(want), got.numpy(), f"attention {shape}")


def test_attention_plain_bf16_matches_jax():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 64, 32).astype(np.float32) for _ in range(3))
    want = jcm.spatial_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = k2.attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    close_to_scale(np.asarray(want.astype(jnp.float32)), got.float().numpy(), "attention bf16",
                   bound=1e-2)


# the OpenAI UNets: AFHQ/FFHQ's 16^2 and 8^2 attention (C = 512 as 8 heads
# of 64) and a tiny shape (4 heads of 8)
_MH_SHAPES = [((1, 256, 512), 8), ((2, 64, 512), 8), ((2, 16, 32), 4)]


@pytest.mark.parametrize("shape,heads", _MH_SHAPES)
def test_attention_multihead_legacy_plain_matches_jax(shape, heads):
    rng = np.random.RandomState(10)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    want = jcm.spatial_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 num_heads=heads, legacy_scale=True)
    got = k2.attention(*(torch.from_numpy(a) for a in (q, k, v)), num_heads=heads,
                       legacy_scale=True)
    close_to_scale(np.asarray(want), got.numpy(), f"attention {shape}/{heads} legacy")


@pytest.mark.parametrize("shape,heads", _MH_SHAPES)
def test_attention_multihead_legacy_plain_bf16_matches_jax(shape, heads):
    """JAX rounds the scale d^-0.25 and q*s, k*s to bf16 before the product;
    the port's plain version does the same."""
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    want = jcm.spatial_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                 num_heads=heads, legacy_scale=True)
    got = k2.attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                       num_heads=heads, legacy_scale=True)
    assert got.dtype == torch.bfloat16
    close_to_scale(np.asarray(want.astype(jnp.float32)), got.float().numpy(),
                   f"attention bf16 {shape}/{heads} legacy", bound=1e-2)


def test_attention_multihead_without_legacy_scale_matches_jax():
    rng = np.random.RandomState(12)
    q, k, v = (rng.randn(2, 16, 32).astype(np.float32) for _ in range(3))
    want = jcm.spatial_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=4)
    got = k2.attention(*(torch.from_numpy(a) for a in (q, k, v)), num_heads=4)
    close_to_scale(np.asarray(want), got.numpy(), "attention 4 heads, logit scale")


def test_attention_multihead_backward_raises():
    """The multi-head gradient is not ported (OpenAI-family training)."""
    q = torch.randn(1, 16, 32, requires_grad=True)
    out = k2.attention(q, q.detach(), q.detach(), num_heads=4, legacy_scale=True)
    with pytest.raises(NotImplementedError, match="multi-head"):
        out.sum().backward()


def _attn_vjp(q, k, v, do):
    _, vjp = jax.vjp(jcm.spatial_attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("shape", [(2, 64, 32), (1, 256, 512)])
def test_attention_backward_plain_matches_jax_vjp(shape):
    rng = np.random.RandomState(7)
    q, k, v, do = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    want = _attn_vjp(q, k, v, do)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o = k2.attention_plain(qt, kt, vt)
    lse = torch.logsumexp(torch.matmul(qt, kt.transpose(1, 2)) * shape[-1] ** -0.5, dim=-1)
    got = k2.attention_backward_plain(qt, kt, vt, o, dot, lse)
    for w, g, name in zip(want, got, ("dq", "dk", "dv")):
        close_to_scale(w, g.numpy(), f"attention backward {shape} {name}")


def test_attention_autograd_matches_jax_vjp():
    rng = np.random.RandomState(8)
    q, k, v, do = (rng.randn(2, 64, 32).astype(np.float32) for _ in range(4))
    want = _attn_vjp(q, k, v, do)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    k2.attention(*ins).backward(torch.from_numpy(do))
    for w, t, name in zip(want, ins, ("dq", "dk", "dv")):
        close_to_scale(w, t.grad.numpy(), f"attention autograd {name}")


# ---------------------------------------------------------------------------
# K3 DDIM step
# ---------------------------------------------------------------------------

_DDIM_CASES = {
    # name: (at, at_next, eta, with_noise, dt_lambda, apply_dt)
    "generation_eta0": (0.30, 0.35, 0.0, False, 1.0, None),
    "generation_eta1_fed_noise": (0.80, 0.85, 1.0, True, 1.0, None),
    "t_next_minus_1": (0.9999, 1.0, 1.0, True, 1.0, None),
    "inversion": (0.35, 0.30, 0.0, False, 1.0, None),
    "dt_lambda": (0.30, 0.35, 0.0, False, 0.9, [1.0, 0.0]),
}


@pytest.mark.parametrize("case", sorted(_DDIM_CASES))
def test_ddim_step_plain_matches_jax(case):
    at, at_next, eta, with_noise, dt_lambda, apply_dt = _DDIM_CASES[case]
    rng = np.random.RandomState(4)
    x, eps, eps_mod, noise = (rng.randn(2, 8, 8, 3).astype(np.float32) for _ in range(4))
    bj = lambda v: jnp.full((2,), v, jnp.float32)
    want = jddim.ddim_step(
        jnp.asarray(x), jnp.asarray(eps), jnp.asarray(eps_mod), bj(at), bj(at_next), eta,
        jnp.asarray(noise if with_noise else np.zeros_like(noise)), dt_lambda=dt_lambda,
        apply_dt=None if apply_dt is None else jnp.asarray(apply_dt),
    )
    got = k3.ddim_step(
        torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(eps_mod),
        torch.full((2,), at), torch.full((2,), at_next), eta,
        torch.from_numpy(noise) if with_noise else None, dt_lambda=dt_lambda,
        apply_dt=None if apply_dt is None else torch.tensor(apply_dt),
    )
    for w, g, name in zip(want, got, ("x_next", "x0_t")):
        close_to_scale(np.asarray(w), g.numpy(), f"{case} {name}")


@pytest.mark.parametrize("case", sorted(_DDIM_CASES))
def test_ddim_step_autograd_matches_jax_vjp(case):
    """K3's `autograd.Function` (the edited step of Δ-training): the
    closed-form gradient with respect to x, eps and eps_mod, from cotangents
    of both outputs, against jax.vjp of the JAX function."""
    at, at_next, eta, with_noise, dt_lambda, apply_dt = _DDIM_CASES[case]
    rng = np.random.RandomState(9)
    x, eps, eps_mod, noise, g_xn, g_x0 = (rng.randn(2, 8, 8, 3).astype(np.float32)
                                          for _ in range(6))
    bj = lambda v: jnp.full((2,), v, jnp.float32)
    adt = None if apply_dt is None else jnp.asarray(apply_dt)
    _, vjp = jax.vjp(lambda a, e, em: jddim.ddim_step(
        a, e, em, bj(at), bj(at_next), eta,
        jnp.asarray(noise if with_noise else np.zeros_like(noise)), dt_lambda=dt_lambda,
        apply_dt=adt), jnp.asarray(x), jnp.asarray(eps), jnp.asarray(eps_mod))
    want = vjp((jnp.asarray(g_xn), jnp.asarray(g_x0)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, eps, eps_mod)]
    x_next, x0_t = k3.ddim_step(
        *ins, torch.full((2,), at), torch.full((2,), at_next), eta,
        torch.from_numpy(noise) if with_noise else None, dt_lambda=dt_lambda,
        apply_dt=None if apply_dt is None else torch.tensor(apply_dt))
    torch.autograd.backward((x_next, x0_t), (torch.from_numpy(g_xn), torch.from_numpy(g_x0)))
    for w, t, name in zip(want, ins, ("dx", "deps", "deps_mod")):
        if not np.asarray(w).any():  # t_next = -1: c2 = 0, no gradient reaches eps
            np.testing.assert_array_equal(np.asarray(w), t.grad.numpy(), err_msg=name)
        else:
            close_to_scale(np.asarray(w), t.grad.numpy(), f"{case} {name}")


def test_ddim_step_backward_of_x0_t_alone():
    """The training step's case: only x0_t reaches the loss, only eps_mod
    needs a gradient, d x0_t / d eps_mod = -sqrt(1 - a) / sqrt(a)."""
    eps_mod = torch.randn(2, 4, 4, 3, requires_grad=True)
    x = torch.randn(2, 4, 4, 3)
    at = torch.tensor([0.3, 0.7])
    _, x0_t = k3.ddim_step(x, x, eps_mod, at, torch.tensor([0.35, 0.75]), 0.0)
    x0_t.sum().backward()
    want = (-(1 - at).sqrt() / at.sqrt()).reshape(2, 1, 1, 1).expand(2, 4, 4, 3)
    torch.testing.assert_close(eps_mod.grad, want, rtol=1e-6, atol=0)


def test_ddim_step_bf16_carry_keeps_f32_coefficients():
    """alpha-bar near 1 rounds to exactly 1.0 in bf16; the coefficients must not."""
    x = torch.ones(1, 4, 4, 3, dtype=torch.bfloat16)
    x_next, x0 = k3.ddim_step(x, x, x, torch.tensor([0.9999]), torch.tensor([0.9998]), 0.0)
    assert x_next.dtype == torch.bfloat16 and torch.isfinite(x0.float()).all()
    want = jddim.ddim_step(jnp.ones((1, 4, 4, 3), jnp.bfloat16), *([jnp.ones((1, 4, 4, 3), jnp.bfloat16)] * 2),
                           jnp.asarray([0.9999]), jnp.asarray([0.9998]), 0.0,
                           jnp.zeros((1, 4, 4, 3), jnp.bfloat16))
    np.testing.assert_array_equal(np.asarray(want[1].astype(jnp.float32)), x0.float().numpy())


def test_ddim_step_on_strided_learn_sigma_channels_matches_jax():
    """eps and eps_mod as the first C of a [B, H, W, 2C] model output (the
    views the sampler hands K3 under learn_sigma)."""
    rng = np.random.RandomState(13)
    x, noise = (rng.randn(2, 8, 8, 3).astype(np.float32) for _ in range(2))
    raw, raw_mod = (rng.randn(2, 8, 8, 6).astype(np.float32) for _ in range(2))
    bj = lambda v: jnp.full((2,), v, jnp.float32)
    want = jddim.ddim_step(jnp.asarray(x), jnp.asarray(raw[..., :3]), jnp.asarray(raw_mod[..., :3]),
                           bj(0.8), bj(0.85), 1.0, jnp.asarray(noise))
    eps, eps_mod = torch.from_numpy(raw)[..., :3], torch.from_numpy(raw_mod)[..., :3]
    assert not eps.is_contiguous() and k3.row_stride(eps) == 6
    got = k3.ddim_step(torch.from_numpy(x), eps, eps_mod, torch.full((2,), 0.8),
                       torch.full((2,), 0.85), 1.0, torch.from_numpy(noise))
    for w, g, name in zip(want, got, ("x_next", "x0_t")):
        close_to_scale(np.asarray(w), g.numpy(), f"strided {name}")


def test_row_stride():
    """The row stride the K3 / ddpm_step wrappers hand their kernels."""
    a = torch.zeros(2, 4, 4, 6)
    assert k3.row_stride(a) == 6 and k3.row_stride(a[..., :3]) == 6
    assert k3.row_stride(a[..., 3:]) == 6
    assert k3.row_stride(torch.zeros(1, 1, 1, 3)) == 3
    with pytest.raises(ValueError, match="unit stride"):
        k3.row_stride(a.transpose(2, 3)[..., ::2])
    with pytest.raises(ValueError, match="evenly spaced"):
        k3.row_stride(a[:, :2])


# ---------------------------------------------------------------------------
# the DDPM ancestral step
# ---------------------------------------------------------------------------

_DDPM_CASES = {
    # name: (t per sample, learned per-element logvar)
    "learned_logvar": ([999.0, 400.0], True),
    "table_logvar": ([999.0, 400.0], False),
    "t0_row_learned": ([10.0, 0.0], True),
    "t0_row_table": ([0.0, 10.0], False),
}


@pytest.mark.parametrize("case", sorted(_DDPM_CASES))
def test_ddpm_step_plain_matches_jax(case):
    t, learned = _DDPM_CASES[case]
    rng = np.random.RandomState(14)
    x, noise = (rng.randn(2, 8, 8, 3).astype(np.float32) for _ in range(2))
    raw = rng.randn(2, 8, 8, 6).astype(np.float32)  # eps | learned logvar
    raw[..., 3:] = -2.0 + 0.5 * raw[..., 3:]
    bt = np.array([0.02, 0.008], np.float32)
    at = np.array([4e-5, 0.1], np.float32)
    table_lv = np.array([-3.9, -6.1], np.float32)
    want = jddim.ddpm_step(jnp.asarray(x), jnp.asarray(raw[..., :3]),
                           jnp.asarray(raw[..., 3:] if learned else table_lv), jnp.asarray(bt),
                           jnp.asarray(at), jnp.asarray(t), jnp.asarray(noise))
    traw = torch.from_numpy(raw)
    got = kddpm.ddpm_step(torch.from_numpy(x), traw[..., :3],
                          traw[..., 3:] if learned else torch.from_numpy(table_lv),
                          torch.from_numpy(bt), torch.from_numpy(at), torch.tensor(t),
                          torch.from_numpy(noise))
    close_to_scale(np.asarray(want), got.numpy(), f"ddpm_step {case}")
    for i, ti in enumerate(t):  # no noise where t == 0
        if ti == 0:
            mean = (x[i] - bt[i] / np.sqrt(1 - at[i]) * raw[i, ..., :3]) / np.sqrt(1 - bt[i])
            np.testing.assert_allclose(got[i].numpy(), mean, rtol=1e-5, atol=1e-5)


def test_ddpm_step_bf16_carry_matches_jax():
    rng = np.random.RandomState(15)
    x, eps, noise = (rng.randn(1, 8, 8, 3).astype(np.float32) for _ in range(3))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = jddim.ddpm_step(bf(x), bf(eps), jnp.asarray([-4.0]), jnp.asarray([0.02]),
                           jnp.asarray([0.9999]), jnp.asarray([5.0]), bf(noise))
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = kddpm.ddpm_step(tb(x), tb(eps), torch.tensor([-4.0]), torch.tensor([0.02]),
                          torch.tensor([0.9999]), torch.tensor([5.0]), tb(noise))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    close_to_scale(np.asarray(want.astype(jnp.float32)), got.float().numpy(), "ddpm bf16",
                   bound=1e-2)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain path; no counter moves
# ---------------------------------------------------------------------------


def _counts():
    return (k1.group_norm.launches, k1.group_norm.bwd_launches, k2.attention.launches,
            k2.attention.mh_launches, k2.attention.bwd_launches, k3.ddim_step.launches,
            kddpm.ddpm_step.launches)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    before = _counts()
    x = torch.randn(1, 32, 4, 4)
    torch.testing.assert_close(k1.group_norm(x, torch.ones(32), torch.zeros(32), silu=True),
                               k1.group_norm_plain(x, torch.ones(32), torch.zeros(32), silu=True),
                               rtol=0, atol=0)
    q = torch.randn(1, 16, 8)
    torch.testing.assert_close(k2.attention(q, q, q), k2.attention_plain(q, q, q), rtol=0, atol=0)
    k3.ddim_step(q, q, q, 0.5, 0.6, 0.0)
    torch.testing.assert_close(k2.attention(q, q, q, num_heads=2, legacy_scale=True),
                               k2.attention_plain(q, q, q, num_heads=2, legacy_scale=True),
                               rtol=0, atol=0)
    kddpm.ddpm_step(q, q, q, 0.02, 0.5, 3.0, q)
    xg = x.clone().requires_grad_()
    k1.group_norm(xg, torch.ones(32), torch.zeros(32), silu=True).sum().backward()
    qg = q.clone().requires_grad_()
    k2.attention(qg, q, q).sum().backward()
    k3.ddim_step(q, q, qg, 0.5, 0.6, 0.0)[1].sum().backward()
    assert _counts() == before


def test_unsupported_device_raises():
    x = torch.randn(1, 32, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k1.group_norm(x, torch.ones(32), torch.zeros(32))
    with pytest.raises(ValueError, match="no kernel"):
        k2.attention(x[0], x[0], x[0])
    with pytest.raises(ValueError, match="no kernel"):
        k3.ddim_step(x, x, x, 0.5, 0.6, 0.0)
    with pytest.raises(ValueError, match="no kernel"):
        kddpm.ddpm_step(x, x, x, 0.02, 0.5, 3.0, x)


def test_device_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from asyrp_official_torch.runner import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_package_imports_no_jax():
    code = ("import sys\n"
            "import asyrp_official_torch, asyrp_official_torch.runner, asyrp_official_torch.cli.main\n"
            "import asyrp_official_torch.ops.groupnorm, asyrp_official_torch.ops.attention\n"
            "import asyrp_official_torch.ops.ddim_step, asyrp_official_torch.pipelines.precompute\n"
            "import asyrp_official_torch.ops.ddpm_step, asyrp_official_torch.models.openai_unet\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'triton' not in sys.modules, 'triton imported at module import'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
