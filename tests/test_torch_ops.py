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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1
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


def test_ddim_step_bf16_carry_keeps_f32_coefficients():
    """alpha-bar near 1 rounds to exactly 1.0 in bf16; the coefficients must not."""
    x = torch.ones(1, 4, 4, 3, dtype=torch.bfloat16)
    x_next, x0 = k3.ddim_step(x, x, x, torch.tensor([0.9999]), torch.tensor([0.9998]), 0.0)
    assert x_next.dtype == torch.bfloat16 and torch.isfinite(x0.float()).all()
    want = jddim.ddim_step(jnp.ones((1, 4, 4, 3), jnp.bfloat16), *([jnp.ones((1, 4, 4, 3), jnp.bfloat16)] * 2),
                           jnp.asarray([0.9999]), jnp.asarray([0.9998]), 0.0,
                           jnp.zeros((1, 4, 4, 3), jnp.bfloat16))
    np.testing.assert_array_equal(np.asarray(want[1].astype(jnp.float32)), x0.float().numpy())


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain path; no counter moves
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    before = (k1.group_norm.launches, k2.attention.launches, k3.ddim_step.launches)
    x = torch.randn(1, 32, 4, 4)
    torch.testing.assert_close(k1.group_norm(x, torch.ones(32), torch.zeros(32), silu=True),
                               k1.group_norm_plain(x, torch.ones(32), torch.zeros(32), silu=True),
                               rtol=0, atol=0)
    q = torch.randn(1, 16, 8)
    torch.testing.assert_close(k2.attention(q, q, q), k2.attention_plain(q, q, q), rtol=0, atol=0)
    k3.ddim_step(q, q, q, 0.5, 0.6, 0.0)
    assert (k1.group_norm.launches, k2.attention.launches, k3.ddim_step.launches) == before


def test_unsupported_device_raises():
    x = torch.randn(1, 32, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k1.group_norm(x, torch.ones(32), torch.zeros(32))
    with pytest.raises(ValueError, match="no kernel"):
        k2.attention(x[0], x[0], x[0])
    with pytest.raises(ValueError, match="no kernel"):
        k3.ddim_step(x, x, x, 0.5, 0.6, 0.0)


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
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'triton' not in sys.modules, 'triton imported at module import'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
