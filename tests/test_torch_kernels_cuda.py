"""The port's CUDA and Triton kernels against their plain PyTorch versions,
on a GPU. Marked `cuda`: they skip on a host without one. This file imports
no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

`python3 chip_smoke.py` runs the same comparison at every shape of the
full-width serving and training paths.

Tolerances: max error relative to scale 1e-5 in float32 (K1, K2: sums in
another order), 2e-2 in bfloat16 (one bf16 ulp is 2^-8), 1e-6 for the
float32 DDIM and DDPM steps (elementwise, ulp-level differences only). The backward
kernels (K1-bwd, K2-bwd with one head or several) against
`torch.autograd.grad` through the plain forward: 1e-4 in float32, 5e-2 in
bfloat16 (the gradient passes through more roundings of the I/O type).
"""
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1
from asyrp_official_torch.ops import ddpm_step as kddpm

_DDIM_CASES = {
    # name: (at, at_next, eta, with_noise, dt_lambda, apply_dt)
    "generation_eta0": (0.30, 0.35, 0.0, False, 1.0, None),
    "generation_eta1_noise": (0.80, 0.85, 1.0, True, 1.0, None),
    "t_next_minus_1": (0.9999, 1.0, 1.0, True, 1.0, None),
    "inversion": (0.35, 0.30, 0.0, False, 1.0, None),
    "dt_lambda": (0.30, 0.35, 0.0, False, 0.9, [1.0, 0.0]),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(1, 128, 64, 64), (2, 512, 8, 8), (1, 1024, 16, 16)])
def test_group_norm_kernel_matches_plain(cuda_device, shape, dtype, bound):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(shape[1], generator=g, device=cuda_device)
    b = 0.1 * torch.randn(shape[1], generator=g, device=cuda_device)
    n = k1.group_norm.launches
    for silu in (False, True):
        got = k1.group_norm(x, w, b, silu=silu)
        close_to_scale(k1.group_norm_plain(x, w, b, silu=silu).float().cpu().numpy(),
                       got.float().cpu().numpy(), "group_norm kernel", bound=bound)
    assert k1.group_norm.launches == n + 2


def _check_lse(q, k, v, heads, legacy, bound):
    """The with-lse launch: o and the log-sum-exp K2-bwd reads, against the
    plain version's."""
    o, lse = k2._attention_cuda(q, k, v, True, heads, legacy)
    o_p, lse_p = k2._plain_with_lse(q, k, v, heads, legacy)
    close_to_scale(o_p.float().cpu().numpy(), o.float().cpu().numpy(), "attention o", bound=bound)
    assert lse.dtype == torch.float32 and lse.shape == lse_p.shape
    close_to_scale(lse_p.cpu().numpy(), lse.cpu().numpy(), "attention lse", bound=bound)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [
    (1, 256, 512), (2, 64, 512), (1, 100, 96),
    (1, 200, 512),  # ragged T
    (8, 256, 512),  # batch 8
    (1, 1024, 512)])
def test_attention_kernel_matches_plain(cuda_device, shape, dtype, bound):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype) for _ in range(3))
    n = k2.attention.launches
    close_to_scale(k2.attention_plain(q, k, v).float().cpu().numpy(),
                   k2.attention(q, k, v).float().cpu().numpy(), "attention kernel", bound=bound)
    assert k2.attention.launches == n + 1
    _check_lse(q, k, v, 1, False, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,heads,legacy", [
    ((1, 256, 512), 8, True), ((2, 64, 512), 8, True),  # AFHQ/FFHQ: 16^2 and the middle block
    ((1, 1024, 512), 8, True),  # IMAGENET's 32^2 level
    ((2, 100, 96), 3, True), ((1, 64, 128), 4, False),
    ((2, 100, 512), 8, True),  # ragged T
    ((8, 256, 512), 8, True)])  # batch 8
def test_multihead_attention_kernel_matches_plain(cuda_device, shape, heads, legacy, dtype, bound):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype) for _ in range(3))
    n, n1 = k2.attention.mh_launches, k2.attention.launches
    kw = dict(num_heads=heads, legacy_scale=legacy)
    close_to_scale(k2.attention_plain(q, k, v, **kw).float().cpu().numpy(),
                   k2.attention(q, k, v, **kw).float().cpu().numpy(),
                   "multi-head attention kernel", bound=bound)
    assert k2.attention.mh_launches == n + 1 and k2.attention.launches == n1
    _check_lse(q, k, v, heads, legacy, bound)


@pytest.mark.cuda
def test_ddim_step_kernel_reads_strided_learn_sigma_channels(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x, noise = (torch.randn(1, 256, 256, 3, generator=g, device=cuda_device) for _ in range(2))
    raw, raw_mod = (torch.randn(1, 256, 256, 6, generator=g, device=cuda_device)
                    for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):  # the model's output dtype
        eps, eps_mod = raw.to(dtype)[..., :3], raw_mod.to(dtype)[..., :3]
        args = (x, eps, eps_mod, torch.full((1,), 0.8, device=cuda_device),
                torch.full((1,), 0.85, device=cuda_device), 1.0, noise)
        n = k3.ddim_step.launches
        for w, g_, name in zip(k3.ddim_step_plain(*args), k3.ddim_step(*args), ("x_next", "x0_t")):
            close_to_scale(w.cpu().numpy(), g_.cpu().numpy(), f"strided {dtype} {name}", bound=1e-6)
        assert k3.ddim_step.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("learned", [True, False])
@pytest.mark.parametrize("carry", [torch.float32, torch.bfloat16])
def test_ddpm_step_kernel_matches_plain(cuda_device, learned, carry):
    g = torch.Generator(device=cuda_device).manual_seed(8)
    x, noise = (torch.randn(2, 256, 256, 3, generator=g, device=cuda_device).to(carry)
                for _ in range(2))
    raw = torch.randn(2, 256, 256, 6, generator=g, device=cuda_device)
    raw[..., 3:] = -2.0 + 0.5 * raw[..., 3:]
    logvar = raw[..., 3:] if learned else torch.tensor([-3.9, -6.1], device=cuda_device)
    args = (x, raw[..., :3], logvar, torch.tensor([0.02, 0.008], device=cuda_device),
            torch.tensor([4e-5, 0.1], device=cuda_device),
            torch.tensor([999.0, 0.0], device=cuda_device), noise)  # a t = 0 row
    n = kddpm.ddpm_step.launches
    got = kddpm.ddpm_step(*args)
    assert kddpm.ddpm_step.launches == n + 1 and got.dtype == carry
    close_to_scale(kddpm.ddpm_step_plain(*args).float().cpu().numpy(), got.float().cpu().numpy(),
                   f"ddpm_step learned={learned}", bound=1e-6 if carry == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_DDIM_CASES))
def test_ddim_step_kernel_matches_plain(cuda_device, case):
    at, at_next, eta, with_noise, dt_lambda, apply_dt = _DDIM_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x, eps, eps_mod, noise = (torch.randn(2, 256, 256, 3, generator=g, device=cuda_device)
                              for _ in range(4))
    args = (x, eps, eps_mod, torch.full((2,), at, device=cuda_device),
            torch.full((2,), at_next, device=cuda_device), eta, noise if with_noise else None)
    kw = dict(dt_lambda=dt_lambda,
              apply_dt=None if apply_dt is None else torch.tensor(apply_dt, device=cuda_device))
    n = k3.ddim_step.launches
    for w, g_, name in zip(k3.ddim_step_plain(*args, **kw), k3.ddim_step(*args, **kw),
                           ("x_next", "x0_t")):
        close_to_scale(w.cpu().numpy(), g_.cpu().numpy(), f"{case} {name}", bound=1e-6)
    assert k3.ddim_step.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_DDIM_CASES))
def test_ddim_step_autograd_launches_the_kernel(cuda_device, case):
    """The edited training step's path: the kernel's forward, the
    closed-form backward, against autograd through the plain version."""
    at, at_next, eta, with_noise, dt_lambda, apply_dt = _DDIM_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x, eps, eps_mod, noise, g_xn, g_x0 = (
        torch.randn(2, 256, 256, 3, generator=g, device=cuda_device) for _ in range(6))
    coeffs = (torch.full((2,), at, device=cuda_device), torch.full((2,), at_next, device=cuda_device),
              eta, noise if with_noise else None)
    kw = dict(dt_lambda=dt_lambda,
              apply_dt=None if apply_dt is None else torch.tensor(apply_dt, device=cuda_device))
    ins = [t.clone().requires_grad_() for t in (x, eps, eps_mod)]
    want = torch.autograd.grad(k3.ddim_step_plain(*ins, *coeffs, **kw), ins, (g_xn, g_x0))
    n = k3.ddim_step.launches
    got = torch.autograd.grad(k3.ddim_step(*ins, *coeffs, **kw), ins, (g_xn, g_x0))
    assert k3.ddim_step.launches == n + 1
    for w, g_, name in zip(want, got, ("dx", "deps", "deps_mod")):
        if w.abs().max() == 0:
            assert g_.abs().max() == 0, name
        else:
            close_to_scale(w.cpu().numpy(), g_.cpu().numpy(), f"{case} {name}", bound=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape,train_weight", [((1, 128, 64, 64), False), ((2, 512, 8, 8), True),
                                                ((1, 1024, 16, 16), False)])
def test_group_norm_backward_kernel_matches_autograd(cuda_device, shape, train_weight, dtype,
                                                     bound):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(dtype).requires_grad_()
    w = (1 + 0.1 * torch.randn(shape[1], generator=g, device=cuda_device)).requires_grad_(
        train_weight)
    b = (0.1 * torch.randn(shape[1], generator=g, device=cuda_device)).requires_grad_(train_weight)
    dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    ins = (x, w, b) if train_weight else (x,)
    n = k1.group_norm.bwd_launches
    for silu in (False, True):
        want = torch.autograd.grad(k1.group_norm_plain(x, w, b, silu=silu), ins, dy)
        got = torch.autograd.grad(k1.group_norm(x, w, b, silu=silu), ins, dy)
        for ww, gg in zip(want, got):
            close_to_scale(ww.float().cpu().numpy(), gg.float().cpu().numpy(),
                           "group_norm backward kernel", bound=bound)
    assert k1.group_norm.bwd_launches == n + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape", [(1, 1024, 16, 16), (1, 768, 32, 32), (1, 256, 128, 128)])
def test_group_norm_backward_kernel_at_openai_decoder_shapes(cuda_device, shape, dtype, bound):
    """The AFHQ decoder's GroupNorm32 (eps 1e-5) on concatenated skip
    inputs, with SiLU (in_layers) and without (the scale-shift branch)."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(dtype).requires_grad_()
    w, b = (1 + 0.1 * torch.randn(shape[1], generator=g, device=cuda_device),
            0.1 * torch.randn(shape[1], generator=g, device=cuda_device))
    dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    n = k1.group_norm.bwd_launches
    for silu in (False, True):
        want = torch.autograd.grad(k1.group_norm_plain(x, w, b, eps=1e-5, silu=silu), x, dy)[0]
        got = torch.autograd.grad(k1.group_norm(x, w, b, eps=1e-5, silu=silu), x, dy)[0]
        close_to_scale(want.float().cpu().numpy(), got.float().cpu().numpy(),
                       f"group_norm backward eps 1e-5 silu={silu}", bound=bound)
    assert k1.group_norm.bwd_launches == n + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape", [
    (1, 256, 512), (2, 64, 512), (1, 100, 96),
    (1, 200, 512), (2, 100, 512),  # ragged T
    (8, 256, 512),  # batch 8
    (1, 1024, 512)])
def test_attention_backward_kernel_matches_autograd(cuda_device, shape, dtype, bound):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype).requires_grad_()
               for _ in range(3))
    d_o = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    n = k2.attention.bwd_launches
    want = torch.autograd.grad(k2.attention_plain(q, k, v), (q, k, v), d_o)
    got = torch.autograd.grad(k2.attention(q, k, v), (q, k, v), d_o)
    for ww, gg in zip(want, got):
        close_to_scale(ww.float().cpu().numpy(), gg.float().cpu().numpy(),
                       "attention backward kernel", bound=bound)
    assert k2.attention.bwd_launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape,heads,legacy", [
    ((1, 256, 512), 8, True), ((2, 64, 512), 8, True), ((1, 1024, 512), 8, True),
    ((2, 100, 96), 3, True), ((1, 64, 128), 4, False),
    ((2, 100, 512), 8, True), ((1, 200, 512), 8, True),  # ragged T
    ((8, 256, 512), 8, True),  # batch 8
    ((1, 4096, 512), 8, True)])  # T = 4096: shared memory does not grow with T
def test_multihead_attention_backward_kernel_matches_autograd(cuda_device, shape, heads, legacy,
                                                              dtype, bound):
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype).requires_grad_()
               for _ in range(3))
    d_o = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    kw = dict(num_heads=heads, legacy_scale=legacy)
    n, n1 = k2.attention.mh_bwd_launches, k2.attention.bwd_launches
    want = torch.autograd.grad(k2.attention_plain(q, k, v, **kw), (q, k, v), d_o)
    got = torch.autograd.grad(k2.attention(q, k, v, **kw), (q, k, v), d_o)
    for ww, gg in zip(want, got):
        close_to_scale(ww.float().cpu().numpy(), gg.float().cpu().numpy(),
                       "multi-head attention backward kernel", bound=bound)
    assert k2.attention.mh_bwd_launches == n + 1 and k2.attention.bwd_launches == n1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,heads,legacy", [
    ((1, 256, 512), 1, False), ((2, 200, 512), 8, True), ((1, 100, 96), 3, True)])
def test_attention_backward_kernel_is_deterministic(cuda_device, shape, heads, legacy, dtype):
    """Every output element is written by one thread of one block, with no
    atomics: two backward calls on the same inputs agree bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, d_o = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
                    for _ in range(4))
    o, lse = k2._attention_cuda(q, k, v, True, heads, legacy)
    kw = dict(num_heads=heads, legacy_scale=legacy)
    first = k2.attention_backward(q, k, v, o, d_o, lse, **kw)
    second = k2.attention_backward(q, k, v, o, d_o, lse, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
