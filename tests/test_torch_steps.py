"""K3 (the DDIM step) with its backward, and the DDPM step: the closed-form
gradient with `needs` against jax.vjp of the JAX `ddim_step`, and the
launch arguments the CUDA wrappers build (`csrc/steps.cu`), read on CPU
tensors: where each per-sample operand comes from, which kernel instance a
layout takes, and what the wrappers refuse.

Tolerance: `close_to_scale` 1e-4 (max error relative to the array's scale)
in float32, as tests/test_torch_ops.py.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.core.schedule import make_schedule
from asyrp_official_torch.ops import ddim_step as k3, ddpm_step as kddpm
from asyrp_official_torch.pipelines import train as ptr
from asyrp_official_tpu.core import ddim as jddim

B, SHAPE = 2, (2, 4, 4, 3)
# (at, at_next, eta, noise, dt_lambda, apply_dt): an eta = 1 step with noise,
# and the dt_lambda override on the first sample
_STEPS = {"eta1_noise": (0.80, 0.85, 1.0, True, 1.0, None),
          "dt_lambda": (0.30, 0.35, 0.0, False, 0.9, [1.0, 0.0])}
_NEEDS = [n for n in itertools.product([False, True], repeat=3) if any(n)]


def _vjp(step, x, eps, eps_mod, noise, g_xn, g_x0):
    """jax.vjp of the JAX ddim_step at f32: (dx, deps, deps_mod)."""
    at, at_next, eta, _, dt_lambda, apply_dt = _STEPS[step]
    bj = lambda v: jnp.full((B,), v, jnp.float32)
    _, vjp = jax.vjp(lambda a, e, em: jddim.ddim_step(
        a, e, em, bj(at), bj(at_next), eta, jnp.asarray(noise), dt_lambda=dt_lambda,
        apply_dt=None if apply_dt is None else jnp.asarray(apply_dt)),
        jnp.asarray(x), jnp.asarray(eps), jnp.asarray(eps_mod))
    zeros = np.zeros(SHAPE, np.float32)
    return [np.asarray(g) for g in vjp((jnp.asarray(zeros if g_xn is None else g_xn),
                                        jnp.asarray(zeros if g_x0 is None else g_x0)))]


def _check_grad(want, got, label):
    if not want.any():  # no gradient reaches it: exactly zero
        np.testing.assert_array_equal(want, got, err_msg=label)
    else:
        close_to_scale(want, got, label)


@pytest.mark.parametrize("cotangents", ["both", "x_next", "x0_t"])
@pytest.mark.parametrize("needs", _NEEDS, ids=lambda n: "".join("1" if v else "0" for v in n))
@pytest.mark.parametrize("step", sorted(_STEPS))
def test_ddim_step_backward_needs_matches_jax_vjp(step, needs, cotangents):
    """Only the gradients `needs` asks for, from either cotangent alone or
    both, each as jax.vjp gives it; the others are None."""
    at, at_next, eta, with_noise, dt_lambda, apply_dt = _STEPS[step]
    rng = np.random.RandomState(21)
    x, eps, eps_mod, noise, g_xn, g_x0 = (rng.randn(*SHAPE).astype(np.float32) for _ in range(6))
    g_xn = g_xn if cotangents in ("both", "x_next") else None
    g_x0 = g_x0 if cotangents in ("both", "x0_t") else None
    want = _vjp(step, x, eps, eps_mod, noise if with_noise else np.zeros_like(noise), g_xn, g_x0)
    got = k3.ddim_step_backward(
        None if g_xn is None else torch.from_numpy(g_xn),
        None if g_x0 is None else torch.from_numpy(g_x0), torch.full((B,), at),
        torch.full((B,), at_next), eta, dt_lambda=dt_lambda,
        apply_dt=None if apply_dt is None else torch.tensor(apply_dt), needs=needs)
    for name, need, w, g in zip(("dx", "deps", "deps_mod"), needs, want, got):
        if not need:
            assert g is None, name
            continue
        assert g.dtype == torch.float32 and g.shape == SHAPE
        _check_grad(w, g.numpy(), f"{step} {cotangents} {name}")


@pytest.mark.parametrize("needs", _NEEDS, ids=lambda n: "".join("1" if v else "0" for v in n))
def test_ddim_step_autograd_on_learn_sigma_views_matches_jax_vjp(needs):
    """The autograd Function on the strided views a learn_sigma model hands
    K3 (the first 3 of 6 channels), with only some inputs needing a
    gradient: each reaching its input as jax.vjp gives it, the learned half
    of the output a zero gradient."""
    rng = np.random.RandomState(22)
    x, noise, g_xn, g_x0 = (rng.randn(*SHAPE).astype(np.float32) for _ in range(4))
    raw, raw_mod = (rng.randn(*SHAPE[:-1], 6).astype(np.float32) for _ in range(2))
    want = _vjp("eta1_noise", x, raw[..., :3], raw_mod[..., :3], noise, g_xn, g_x0)
    xt = torch.from_numpy(x).requires_grad_(needs[0])
    rt, rmt = (torch.from_numpy(a).requires_grad_(n) for a, n in ((raw, needs[1]),
                                                                  (raw_mod, needs[2])))
    x_next, x0_t = k3.ddim_step(xt, rt[..., :3], rmt[..., :3], torch.full((B,), 0.80),
                                torch.full((B,), 0.85), 1.0, torch.from_numpy(noise))
    torch.autograd.backward((x_next, x0_t), (torch.from_numpy(g_xn), torch.from_numpy(g_x0)))
    for name, t, w in zip(("dx", "deps", "deps_mod"), (xt, rt, rmt), want):
        if not t.requires_grad:
            assert t.grad is None, name
            continue
        g = t.grad.numpy()
        _check_grad(w, g[..., :3], f"learn_sigma {name}")
        if g.shape[-1] == 6:
            np.testing.assert_array_equal(g[..., 3:], 0.0, err_msg=name)


def test_ddim_step_backward_default_needs_all_three():
    rng = np.random.RandomState(23)
    g = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32))
    at, an = torch.full((B,), 0.3), torch.full((B,), 0.35)
    full = k3.ddim_step_backward(g, g, at, an, 0.0)
    assert all(t is not None for t in full)
    for i in range(3):
        one = k3.ddim_step_backward(g, g, at, an, 0.0, needs=tuple(j == i for j in range(3)))
        assert torch.equal(one[i], full[i])


# ---------------------------------------------------------------------------
# the launch arguments (`ddim_launch_args`, `ddpm_launch_args`)
# ---------------------------------------------------------------------------


def _carry(shape=(1, 16, 16, 3), dtype=torch.float32):
    return torch.randn(shape).to(dtype)


def _misaligned(shape, dtype=torch.float32):
    """A contiguous tensor whose data starts 4 or 2 bytes past a 16-byte
    boundary."""
    buf = torch.randn(int(np.prod(shape)) + 1).to(dtype)
    t = buf[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16
    return t


def test_coefficients_read_in_place_or_passed_by_value():
    x = _carry((2, 8, 8, 3))
    one, per = torch.tensor([0.5]), torch.tensor([0.3, 0.7])
    args = k3.ddim_launch_args(x, x, x, one, per, 0.0, apply_dt=per[:1].expand(2))
    assert args.at == (one.data_ptr(), 0, 0.0)  # a [1] tensor: stride 0
    assert args.at_next == (per.data_ptr(), 1, 0.0)  # a [B] tensor: stride 1
    assert args.eta == (0, 0, 0.0)  # a Python number: by value
    assert args.apply_dt == (per.data_ptr(), 0, 0.0) and args.has_dt == 1
    strided = torch.tensor([[0.3, 9.0], [0.7, 9.0]])[:, 0]  # every other element
    assert k3.ddim_launch_args(x, x, x, strided, 0.6, 1.0).at == (strided.data_ptr(), 2, 0.0)
    assert k3.ddim_launch_args(x, x, x, 0.25, 0.6, 1.0).at == (0, 0, 0.25)
    assert k3.ddim_launch_args(x, x, x, 0.25, 0.6, 1.0).has_dt == 0


@pytest.mark.parametrize("coef,err", [
    (torch.tensor([0.5], dtype=torch.float64), TypeError),  # not float32
    (torch.tensor([0.1, 0.2, 0.3]), ValueError),  # neither 1 nor B values
    (torch.zeros(2, 2), ValueError),
    (torch.zeros(2, device="meta"), ValueError),  # another device
    (np.array([0.5, 0.6]), TypeError),
])
def test_bad_coefficients_raise(coef, err):
    x = _carry((2, 8, 8, 3))
    with pytest.raises(err):
        k3.ddim_launch_args(x, x, x, coef, 0.6, 0.0)


@pytest.mark.parametrize("case", ["float64 [B]", "int t [B]", "bool [1]", "float32 [B] elsewhere",
                                  "float64 [1] on x's device"])
def test_coef_operand_copies_what_the_kernel_cannot_read_in_place(case):
    """`coef_operand` makes a per-sample tensor of another dtype, or one
    with several values on another device, an f32 tensor on x's device,
    with the same values; the launch arguments then read it in place."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    v, dev = {"float64 [B]": (torch.tensor([0.3, 0.7], dtype=torch.float64), cpu),
              "int t [B]": (torch.tensor([999, 0]), cpu),
              "bool [1]": (torch.tensor([True]), cpu),
              "float32 [B] elsewhere": (torch.tensor([0.3, 0.7]), meta),
              "float64 [1] on x's device": (torch.tensor([0.5], dtype=torch.float64,
                                                         device=meta), meta)}[case]
    got = k3.coef_operand(v, dev)
    assert got.dtype is torch.float32 and got.device == dev and got.shape == v.shape
    per_sample = 1 if got.numel() == 2 else 0
    assert k3.coef_arg(got, 2, dev, "at")[1:] == (per_sample, 0.0)
    if dev == cpu and v.device == cpu:
        np.testing.assert_array_equal(got.numpy(), v.float().numpy())
        x = _carry((2, 8, 8, 3))
        assert k3.ddim_launch_args(x, x, x, got, 0.6, 0.0).at == (got.data_ptr(), per_sample, 0.0)


def test_coef_operand_passes_what_the_kernel_takes_as_it_is():
    dev = torch.device("cpu")
    f32 = torch.tensor([0.3, 0.7])
    assert k3.coef_operand(f32, dev) is f32  # read in place: no copy
    assert k3.coef_operand(0.25, dev) == 0.25  # by value
    one = torch.tensor([7], dtype=torch.int64)  # one value on the CPU: by value
    assert k3.coef_operand(one, torch.device("meta")) is one
    assert k3.coef_arg(one, 2, torch.device("meta"), "t") == (0, 0, 7.0)


def test_a_one_element_cpu_tensor_is_passed_by_value_to_another_device():
    """`coef_arg` for a tensor elsewhere than x: its one value goes by value."""
    assert k3.coef_arg(torch.tensor([0.75]), 2, torch.device("meta"), "at") == (0, 0, 0.75)


@pytest.mark.parametrize("case,mode", [
    ("contiguous f32", k3.FLAT), ("contiguous bf16 carry", k3.FLAT),
    ("bf16 model output", k3.FLAT), ("learn_sigma views", k3.ROWS),
    ("learn_sigma views bf16", k3.ROWS), ("eps_mod is eps", k3.FLAT),
    ("misaligned x", k3.SCALAR), ("misaligned eps", k3.SCALAR),
    ("misaligned noise", k3.SCALAR), ("sample not whole vectors", k3.SCALAR),
    ("pixels not whole groups", k3.SCALAR), ("mixed row strides", k3.SCALAR),
    ("rows of 5 of 10", k3.SCALAR)])
def test_ddim_instance_follows_layout_and_alignment(case, mode):
    """FLAT for contiguous operands filling whole 16-byte vectors per
    sample, ROWS for the first 3 of 6 channels filling whole groups of
    pixels (4 with an f32 carry, 8 with bf16), SCALAR otherwise."""
    f32, bf = torch.float32, torch.bfloat16
    x, noise = _carry(), _carry()
    eps = eps_mod = None
    if case == "contiguous bf16 carry":
        x, noise = _carry(dtype=bf), _carry(dtype=bf)
    elif case == "bf16 model output":
        eps, eps_mod = _carry(dtype=bf), _carry(dtype=bf)
    elif case.startswith("learn_sigma views"):
        dt = bf if case.endswith("bf16") else f32
        eps, eps_mod = (torch.randn(1, 16, 16, 6).to(dt)[..., :3] for _ in range(2))
    elif case == "misaligned x":
        x = _misaligned(x.shape)
    elif case == "misaligned eps":
        eps = _misaligned(x.shape)
    elif case == "misaligned noise":
        noise = _misaligned(x.shape)
    elif case == "sample not whole vectors":  # 75 elements a sample
        x, noise = _carry((2, 5, 5, 3)), _carry((2, 5, 5, 3))
    elif case == "pixels not whole groups":  # 25 pixels a sample
        x, noise = _carry((2, 5, 5, 3)), _carry((2, 5, 5, 3))
        eps, eps_mod = (torch.randn(2, 5, 5, 6)[..., :3] for _ in range(2))
    elif case == "mixed row strides":
        eps, eps_mod = torch.randn(1, 16, 16, 6)[..., :3], _carry()
    elif case == "rows of 5 of 10":
        x, noise = _carry((1, 16, 16, 5)), _carry((1, 16, 16, 5))
        eps, eps_mod = (torch.randn(1, 16, 16, 10)[..., :5] for _ in range(2))
    eps = _carry(x.shape) if eps is None else eps
    eps_mod = eps if case == "eps_mod is eps" else (_carry(x.shape) if eps_mod is None else eps_mod)
    args = k3.ddim_launch_args(x, eps, eps_mod, 0.5, 0.6, 1.0, noise)
    assert args.mode == mode, (case, args.mode)
    assert args.eps_mod == (0 if case == "eps_mod is eps" else eps_mod.data_ptr())
    assert (args.row_eps, args.channels) == (k3.row_stride(eps), x.shape[-1])
    assert args.rows == x[0].numel() // x.shape[-1]


def test_ddim_args_pack_into_the_c_structs():
    """28, 24 and 26 fields of 8 bytes: `csrc/steps.cu`'s static_asserts."""
    x = _carry()
    assert len(k3._pack_ddim(k3.ddim_launch_args(x, x, x, 0.5, 0.6, 0.0))) == 8 * 28
    bwd = k3.ddim_bwd_launch_args(None, x, 0.5, 0.6, 0.0, torch.bfloat16)
    assert len(k3._pack_ddim_bwd(bwd)) == 8 * 24
    dd = kddpm.ddpm_launch_args(x, x, -3.0, 0.02, 0.5, 3.0, x)
    assert len(kddpm._pack_ddpm(dd)) == 8 * 26


def test_ddim_bwd_args_write_only_what_is_asked():
    g = _carry()
    d_em = torch.empty_like(g, dtype=torch.bfloat16)
    args = k3.ddim_bwd_launch_args(None, g, torch.tensor([0.5]), 0.6, 0.0, torch.bfloat16,
                                   deps_mod=d_em)
    assert (args.g_x_next, args.g_x0_t) == (0, g.data_ptr())
    assert (args.dx, args.deps, args.deps_mod) == (0, 0, d_em.data_ptr())
    assert (args.mode, args.tx, args.te, args.per_sample) == (k3.FLAT, 0, 1, g[0].numel())
    assert k3.ddim_bwd_launch_args(_misaligned(g.shape), None, 0.5, 0.6, 0.0,
                                   torch.float32).mode == k3.SCALAR
    with pytest.raises(ValueError, match="dx in the cotangents' dtype"):
        k3.ddim_bwd_launch_args(None, g, 0.5, 0.6, 0.0, torch.float32, dx=d_em)


@pytest.mark.parametrize("what,err", [
    ("float64 carry", TypeError), ("strided x", ValueError), ("eps dtypes differ", TypeError),
    ("transposed eps", ValueError), ("noise dtype", ValueError), ("eps shape", ValueError)])
def test_ddim_args_refuse_what_the_kernel_does_not_take(what, err):
    x, eps, eps_mod, noise = _carry(), _carry(), _carry(), _carry()
    if what == "float64 carry":
        x = x.double()
    elif what == "strided x":
        x = torch.randn(1, 16, 16, 6)[..., :3]
    elif what == "eps dtypes differ":
        eps_mod = eps_mod.to(torch.bfloat16)
    elif what == "transposed eps":
        eps = torch.randn(1, 16, 3, 16).transpose(2, 3)
    elif what == "noise dtype":
        noise = noise.to(torch.bfloat16)
    elif what == "eps shape":
        eps = torch.randn(1, 16, 8, 3)
    with pytest.raises(err):
        k3.ddim_launch_args(x, eps, eps_mod, 0.5, 0.6, 1.0, noise)


@pytest.mark.parametrize("logvar,mode,lv_mode", [
    ("paired", k3.ROWS, kddpm.LV_PAIRED),  # the two halves of one learn_sigma output
    ("table", k3.FLAT, kddpm.LV_SAMPLE),  # the schedule's per-sample value
    ("own contiguous", k3.FLAT, kddpm.LV_ELEMENT),
    ("paired, misaligned rows", k3.SCALAR, kddpm.LV_ELEMENT)])
def test_ddpm_instance_and_logvar(logvar, mode, lv_mode):
    x, noise = _carry(), _carry()
    raw = torch.randn(1, 16, 16, 6)
    eps = raw[..., :3] if logvar.startswith("paired") else _carry()
    lv = {"paired": raw[..., 3:], "table": torch.tensor([-3.9]),
          "own contiguous": _carry()}.get(logvar)
    if logvar == "paired, misaligned rows":
        raw = torch.randn(16 * 16 * 6 + 1)[1:].view(1, 16, 16, 6)
        eps, lv = raw[..., :3], raw[..., 3:]
    args = kddpm.ddpm_launch_args(x, eps, lv, torch.tensor([0.02]), 0.5, torch.tensor([5.0]),
                                  noise)
    assert (args.mode, args.lv_mode) == (mode, lv_mode)
    assert args.bt[1] == 0 and args.at == (0, 0, 0.5)
    if lv_mode == kddpm.LV_SAMPLE:
        assert args.logvar == 0 and args.lv == (lv.data_ptr(), 0, 0.0)
    else:
        assert args.logvar == lv.data_ptr() and args.row_logvar == k3.row_stride(lv)


def test_ddpm_args_refuse_what_the_kernel_does_not_take():
    x = _carry()
    with pytest.raises(TypeError, match="share"):
        kddpm.ddpm_launch_args(x, x, x.to(torch.bfloat16), 0.02, 0.5, 3.0, x)
    with pytest.raises(ValueError, match="noise"):
        kddpm.ddpm_launch_args(x, x, -3.0, 0.02, 0.5, 3.0, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shaped and placed"):
        kddpm.ddpm_launch_args(x, x, torch.randn(1, 16, 8, 3), 0.02, 0.5, 3.0, x)


def test_train_step_builds_its_coefficients_once():
    """`make_train_step` hands K3 views of per-step tensors built once per
    device: a and a' are alphas_cumprod_ext[t + 1], [t_next + 1] in f32."""
    from unittest import mock

    schedule = make_schedule()
    seq = np.linspace(0, 999, 6).astype(int)
    step = ptr.make_train_step(_PlainModel, schedule, seq, t_edit=400)
    seen = []

    def record(x, eps, eps_mod, at, at_next, eta, *a, **kw):
        seen.append((at, at_next))
        return x, x

    with mock.patch.object(k3, "ddim_step", record):
        step.compute_origins(None, torch.zeros(1, 4, 4, 3))
    from asyrp_official_torch.core.steptable import generation_table

    table = generation_table(seq, t_edit=400)
    acp = schedule.alphas_cumprod_ext
    assert len(seen) == table.num_steps
    storages = {(t.untyped_storage().data_ptr(), u.untyped_storage().data_ptr())
                for t, u in seen}
    assert len(storages) == 1  # one tensor per coefficient, viewed per step
    for (at, at_next), t, t_next in zip(seen, table.t, table.t_next):
        assert at.dtype == torch.float32 and at.shape == (1,)
        assert float(at) == acp[t + 1] and float(at_next) == acp[t_next + 1]


class _PlainModel:
    """Stands in for the model spec in `compute_origins`: eps = 0."""

    learn_sigma = False

    @staticmethod
    def apply(model, x, t, **kw):
        return (torch.zeros_like(x),)
