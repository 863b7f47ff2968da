"""The port's CUDA and Triton kernels against their plain PyTorch versions,
on a GPU. Marked `cuda`: they skip on a host without one. This file imports
no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

`python3 chip_smoke.py` runs the same comparison at every shape of the
full-width serving path.

Tolerances: max error relative to scale 1e-5 in float32 (K1, K2: sums in
another order), 2e-2 in bfloat16 (one bf16 ulp is 2^-8), 1e-6 for the
float32 DDIM step (elementwise, ulp-level differences only).
"""
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(1, 256, 512), (2, 64, 512), (1, 100, 96)])
def test_attention_kernel_matches_plain(cuda_device, shape, dtype, bound):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype) for _ in range(3))
    n = k2.attention.launches
    close_to_scale(k2.attention_plain(q, k, v).float().cpu().numpy(),
                   k2.attention(q, k, v).float().cpu().numpy(), "attention kernel", bound=bound)
    assert k2.attention.launches == n + 1


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
