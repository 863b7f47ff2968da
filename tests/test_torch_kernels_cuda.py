"""The port's CUDA kernels against their plain PyTorch versions, on a GPU. Marked `cuda`: they skip on a host without one. This file imports
no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

`python3 chip_smoke.py` runs the same comparison at every shape of the
full-width serving and training paths.

Tolerances: max error relative to scale 1e-5 in float32 (K1, K2: sums in
another order), 2e-2 in bfloat16 (one bf16 ulp is 2^-8), 1e-6 for the
float32 DDIM and DDPM steps and K3's backward (elementwise, ulp-level
differences only), 1e-2 where their output is bfloat16. The backward
kernels (K1-bwd, K2-bwd with one head or several) against
`torch.autograd.grad` through the plain forward: 1e-4 in float32, 5e-2 in
bfloat16 (the gradient passes through more roundings of the I/O type);
the same for K1-bwd across ranks and K2-bwd with Tq != Tk.
K1's fused entry (pre-add, FiLM epilogue) against K1 followed by the torch
ops it replaces: 1e-6 of scale in float32, one bf16 step per element (the
same roundings; SiLU's exp may differ in the last f32 bit).
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
    ((8, 256, 512), 8, True),  # batch 8
    ((1, 256, 1024), 16, True), ((1, 64, 1024), 16, True),  # IMAGENET's 16^2 and 8^2
    ((2, 65, 512), 8, True)])  # the ADM classifier's attention pool: T = 8^2 + 1
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


# base training's norms (every parameter trained, batch 2, one timestep per
# sample): (shape, eps, silu, the fused operand) at the DDPM++ (1e-6, temb
# pre-add) and AFHQ (1e-5, FiLM) encoder, middle and decoder
_BASE_NORMS = [((2, 128, 256, 256), 1e-6, True, "pre_add"), ((2, 512, 8, 8), 1e-6, True, "pre_add"),
               ((2, 256, 256, 256), 1e-6, True, None),
               ((2, 128, 256, 256), 1e-5, True, "scale_shift"),
               ((2, 512, 8, 8), 1e-5, True, "scale_shift"), ((2, 256, 256, 256), 1e-5, True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape,eps,silu,fused", _BASE_NORMS)
def test_group_norm_backward_kernel_at_base_training_shapes(cuda_device, shape, eps, silu, fused,
                                                            dtype, bound):
    """K1-bwd with dweight and dbias, and the gradient of the per-sample
    pre-add (temb) or FiLM operand through the torch ops around K1, against
    autograd through the plain forward; two calls bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    b_, c_ = shape[:2]
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(dtype).requires_grad_()
    w = (1 + 0.1 * torch.randn(c_, generator=g, device=cuda_device)).requires_grad_()
    b = (0.1 * torch.randn(c_, generator=g, device=cuda_device)).requires_grad_()
    kw = dict(eps=eps, silu=silu)
    ins = [x, w, b]
    if fused == "pre_add":
        kw[fused] = torch.randn(b_, c_, generator=g, device=cuda_device).to(dtype)
    elif fused == "scale_shift":
        kw[fused] = (0.1 * torch.randn(b_, 2 * c_, generator=g, device=cuda_device)).to(dtype)
    if fused:
        ins.append(kw[fused].requires_grad_())
    dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    want = torch.autograd.grad(k1.group_norm_plain(x, w, b, **kw), ins, dy)
    n = k1.group_norm.bwd_launches
    got = torch.autograd.grad(k1.group_norm(x, w, b, **kw), ins, dy)
    again = torch.autograd.grad(k1.group_norm(x, w, b, **kw), ins, dy)
    assert k1.group_norm.bwd_launches == n + 2
    for name, ww, gg, g2 in zip(("dx", "dweight", "dbias", f"d{fused}"), want, got, again):
        close_to_scale(ww.float().cpu().numpy(), gg.float().cpu().numpy(),
                       f"group_norm backward {name}", bound=bound)
        assert torch.equal(gg, g2), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape,heads,legacy", [((2, 256, 512), 1, False),
                                                ((2, 256, 512), 8, True)])
def test_attention_backward_kernel_at_base_training_encoder(cuda_device, shape, heads, legacy,
                                                            dtype, bound):
    """K2-bwd (DDPM++) and K2-bwd-MH (AFHQ) at the encoder's 16^2 attention
    of a batch-2 base-training step; two calls bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype).requires_grad_()
               for _ in range(3))
    d_o = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    kw = dict(num_heads=heads, legacy_scale=legacy)
    want = torch.autograd.grad(k2.attention_plain(q, k, v, **kw), (q, k, v), d_o)
    counter = "bwd_launches" if heads == 1 else "mh_bwd_launches"
    n = getattr(k2.attention, counter)
    got = torch.autograd.grad(k2.attention(q, k, v, **kw), (q, k, v), d_o)
    again = torch.autograd.grad(k2.attention(q, k, v, **kw), (q, k, v), d_o)
    assert getattr(k2.attention, counter) == n + 2
    for ww, gg, g2 in zip(want, got, again):
        close_to_scale(ww.float().cpu().numpy(), gg.float().cpu().numpy(),
                       "attention backward at the base-training encoder", bound=bound)
        assert torch.equal(gg, g2)


def _gn_inputs(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(shape[1], generator=g, device=device)
    b = 0.1 * torch.randn(shape[1], generator=g, device=device)
    dy = torch.randn(shape, generator=g, device=device).to(dtype)
    return x, w, b, dy


def _streams(shape, dtype, backward=False):
    pl = k1.group_norm_plan(shape, dtype, backward=backward)
    return pl["resident_x"] < pl["slice_vectors"] or (
        backward and pl["resident_dy"] < pl["slice_vectors"])


# shape, dtype, whether the group streams part of its slice: scalar
# vectors (H*W not a multiple of the 16-byte vector), H*W/vec not a power
# of two, the decoders' largest on-path group (2 MiB f32, a cluster of 16),
# and groups too large for one cluster's shared memory (IMAGENET's decoder
# at 256^2 on the path: 512 channels, a 4 MiB f32 group)
_K1_SHAPES = [((1, 512, 256, 256), torch.float32, True),
              ((1, 512, 256, 256), torch.bfloat16, False), ((3, 64, 5, 7), torch.float32, False), ((3, 64, 5, 7), torch.bfloat16, False),
              ((1, 96, 10, 10), torch.float32, False), ((1, 256, 256, 256), torch.float32, False),
              ((1, 256, 256, 256), torch.bfloat16, False),
              ((1, 2048, 128, 128), torch.float32, True),
              ((1, 4096, 128, 128), torch.bfloat16, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,streams", _K1_SHAPES)
def test_group_norm_kernel_at_odd_cluster_and_streamed_shapes(cuda_device, shape, dtype, streams):
    x, w, b, _ = _gn_inputs(shape, dtype, cuda_device, 20)
    assert _streams(shape, dtype) == streams
    bound = 1e-5 if dtype == torch.float32 else 2e-2
    for silu in (False, True):
        close_to_scale(k1.group_norm_plain(x, w, b, silu=silu).float().cpu().numpy(),
                       k1.group_norm(x, w, b, silu=silu).float().cpu().numpy(),
                       f"group_norm kernel {shape} silu={silu}", bound=bound)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,train_weight", [
    ((3, 64, 5, 7), torch.float32, True), ((3, 64, 5, 7), torch.bfloat16, True),
    ((1, 96, 10, 10), torch.float32, False), ((1, 256, 256, 256), torch.float32, False),
    ((1, 256, 256, 256), torch.bfloat16, False), ((1, 256, 64, 64), torch.float32, True),
    ((1, 2048, 128, 128), torch.float32, False), ((1, 512, 256, 256), torch.float32, False),
    ((1, 512, 256, 256), torch.bfloat16, False)])
def test_group_norm_backward_kernel_at_odd_cluster_and_streamed_shapes(cuda_device, shape, dtype,
                                                                       train_weight):
    """The f32 [1,256,256,256] group (2 MiB of x, 2 MiB of dy) streams part
    of dy; [1,2048,128,128] part of x; a trained weight's dw, db from a
    cluster's slices."""
    x, w, b, dy = _gn_inputs(shape, dtype, cuda_device, 21)
    x.requires_grad_()
    w.requires_grad_(train_weight)
    b.requires_grad_(train_weight)
    ins = (x, w, b) if train_weight else (x,)
    bound = 1e-4 if dtype == torch.float32 else 5e-2
    for silu in (False, True):
        want = torch.autograd.grad(k1.group_norm_plain(x, w, b, silu=silu), ins, dy)
        got = torch.autograd.grad(k1.group_norm(x, w, b, silu=silu), ins, dy)
        for name, ww, gg in zip(("dx", "dw", "db"), want, got):
            close_to_scale(ww.float().cpu().numpy(), gg.float().cpu().numpy(),
                           f"group_norm backward kernel {shape} silu={silu} {name}", bound=bound)


def _bf16_steps(a, b):
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["pre_add", "scale_shift"])
@pytest.mark.parametrize("shape", [(2, 512, 8, 8), (1, 256, 64, 64), (1, 256, 256, 256)])
def test_group_norm_fused_entry_matches_plain_and_unfused(cuda_device, shape, kind, dtype):
    """One launch for the norm with its pre-add or FiLM epilogue: within
    K1's tolerance of the plain fused version, and within 1e-6 of scale
    (f32) or one bf16 step per element of K1 followed by the torch ops."""
    x, w, b, _ = _gn_inputs(shape, dtype, cuda_device, 22)
    g = torch.Generator(device=cuda_device).manual_seed(23)
    width = 1 if kind == "pre_add" else 2
    extra = (0.5 * torch.randn(shape[0], width * shape[1], generator=g,
                               device=cuda_device)).to(dtype)
    bound = 1e-5 if dtype == torch.float32 else 2e-2
    for silu in (False, True):
        kw = {"silu": silu, "eps": 1e-5, kind: extra}
        n = k1.group_norm.launches
        with torch.no_grad():
            got = k1.group_norm(x, w, b, **kw)
        assert k1.group_norm.launches == n + 1
        close_to_scale(k1.group_norm_plain(x, w, b, **kw).float().cpu().numpy(),
                       got.float().cpu().numpy(), f"fused {kind} silu={silu}", bound=bound)
        unfused = k1.group_norm_unfused(x, w, b, **kw)
        if dtype == torch.float32:
            close_to_scale(unfused.cpu().numpy(), got.cpu().numpy(),
                           f"fused vs unfused {kind} silu={silu}", bound=1e-6)
        else:
            assert _bf16_steps(got, unfused) <= 1, (kind, silu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 512, 8, 8), (2, 256, 64, 64), (1, 256, 256, 256)])
def test_group_norm_kernels_are_deterministic(cuda_device, shape, dtype):
    """No atomics: two calls of K1 and of K1-bwd (with dw, db) on the same
    inputs agree bit for bit."""
    x, w, b, dy = _gn_inputs(shape, dtype, cuda_device, 24)
    ss = (0.1 * torch.randn(shape[0], 2 * shape[1], device=cuda_device)).to(dtype)
    for kw in ({"silu": True}, {"silu": True, "scale_shift": ss}):
        assert torch.equal(k1.group_norm(x, w, b, **kw), k1.group_norm(x, w, b, **kw))
    mean, rstd = k1._group_norm_cuda(x, w, b, 32, 1e-6, True, stats=True)[1:]
    one, two = (k1.group_norm_backward(x, dy, w, b, mean, rstd, silu=True, weight_grad=True)
                for _ in range(2))
    assert all(torch.equal(a, c) for a, c in zip(one, two))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 512, 8, 8), (1, 256, 256, 256)])
def test_group_norm_forward_is_one_device_kernel_per_call(cuda_device, shape):
    """`group_norm.launches` counts calls; torch.profiler's device events
    show that each call, fused ops included, is one kernel (`gn_fwd`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, w, b, _ = _gn_inputs(shape, torch.bfloat16, cuda_device, 25)
    extra = torch.randn(shape[0], 2 * shape[1], device=cuda_device).to(torch.bfloat16)
    for kw in ({"silu": True}, {"silu": True, "pre_add": extra[:, :shape[1]].contiguous()},
               {"silu": True, "scale_shift": extra}):
        k1.group_norm(x, w, b, **kw)
        torch.cuda.synchronize()
        kernels = []
        for _ in range(3):  # a profile may record no device event at all; then again
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    k1.group_norm(x, w, b, **kw)
                torch.cuda.synchronize()
            kernels = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
            if kernels:
                break
        # the trace may drop an event, never add one: at most one kernel per call
        assert 0 < len(kernels) <= 4 and all("gn_fwd" in k for k in kernels), (sorted(kw), kernels)


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
    ((1, 256, 1024), 16, True), ((1, 64, 1024), 16, True),  # IMAGENET's 16^2 and 8^2
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


# ---------------------------------------------------------------------------
# K3, K3-bwd and the DDPM step (`csrc/steps.cu`): batch 8, the scalar
# instance, determinism, and the backward's gradients one by one
# ---------------------------------------------------------------------------


def _k3_inputs(device, shape, seed, learn_sigma=False, model_dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    x, noise = (torch.randn(shape, generator=g, device=device) for _ in range(2))
    if learn_sigma:
        raw, raw_mod = (torch.randn(*shape[:-1], 6, generator=g, device=device).to(model_dtype)
                        for _ in range(2))
        return x, raw[..., :3], raw_mod[..., :3], noise
    eps, eps_mod = (torch.randn(shape, generator=g, device=device).to(model_dtype)
                    for _ in range(2))
    return x, eps, eps_mod, noise


@pytest.mark.cuda
@pytest.mark.parametrize("model_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("learn_sigma,instance", [(False, k3.FLAT), (True, k3.ROWS)])
def test_ddim_step_kernel_at_batch_8(cuda_device, learn_sigma, instance, model_dtype):
    x, eps, eps_mod, noise = _k3_inputs(cuda_device, (8, 256, 256, 3), 30, learn_sigma,
                                        model_dtype)
    a = torch.linspace(0.2, 0.9, 8, device=cuda_device)
    args = (x, eps, eps_mod, a, a + 0.05, 1.0, noise)
    assert k3.ddim_launch_args(*args).mode == instance
    n, ns = k3.ddim_step.launches, k3.ddim_step.scalar_launches
    got = k3.ddim_step(*args)
    assert (k3.ddim_step.launches, k3.ddim_step.scalar_launches) == (n + 1, ns)
    for w, g_, name in zip(k3.ddim_step_plain(*args), got, ("x_next", "x0_t")):
        close_to_scale(w.cpu().numpy(), g_.cpu().numpy(), f"batch 8 {name}", bound=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["x", "eps", "noise"])
def test_step_kernels_take_the_scalar_instance_on_a_misaligned_view(cuda_device, what):
    """A view 4 bytes past a 16-byte boundary: the scalar instance, counted,
    with the same result."""
    shape = (2, 64, 64, 3)
    x, eps, eps_mod, noise = _k3_inputs(cuda_device, shape, 31)
    buf = torch.randn(x.numel() + 1, device=cuda_device)
    view = buf[1:].view(shape)
    view.copy_({"x": x, "eps": eps, "noise": noise}[what])
    x, eps, noise = (view if what == name else t
                     for name, t in (("x", x), ("eps", eps), ("noise", noise)))
    args = (x, eps, eps_mod, torch.tensor([0.8, 0.3], device=cuda_device), 0.85, 1.0, noise)
    assert k3.ddim_launch_args(*args).mode == k3.SCALAR
    ns = k3.ddim_step.scalar_launches
    for w, g_, name in zip(k3.ddim_step_plain(*args), k3.ddim_step(*args), ("x_next", "x0_t")):
        close_to_scale(w.cpu().numpy(), g_.cpu().numpy(), f"scalar {what} {name}", bound=1e-6)
    assert k3.ddim_step.scalar_launches == ns + 1
    lv = torch.tensor([-3.9, -6.1], device=cuda_device)
    ddpm_args = (x, eps, lv, torch.tensor([0.02, 0.008], device=cuda_device),
                 torch.tensor([4e-5, 0.1], device=cuda_device), 5.0, noise)
    ns = kddpm.ddpm_step.scalar_launches
    close_to_scale(kddpm.ddpm_step_plain(*ddpm_args).cpu().numpy(),
                   kddpm.ddpm_step(*ddpm_args).cpu().numpy(), f"ddpm scalar {what}", bound=1e-6)
    assert kddpm.ddpm_step.scalar_launches == ns + 1


@pytest.mark.cuda
@pytest.mark.parametrize("learn_sigma", [False, True])
@pytest.mark.parametrize("batch", [1, 8])
def test_step_kernels_are_deterministic(cuda_device, batch, learn_sigma):
    """Elementwise, no atomics: two calls agree bit for bit, K3, K3-bwd and
    the DDPM step."""
    x, eps, eps_mod, noise = _k3_inputs(cuda_device, (batch, 256, 256, 3), 32, learn_sigma)
    a = torch.full((batch,), 0.8, device=cuda_device)
    args = (x, eps, eps_mod, a, 0.85, 1.0, noise)
    assert all(torch.equal(p, q) for p, q in zip(k3.ddim_step(*args), k3.ddim_step(*args)))
    coeffs = (a, 0.85, 1.0, 1.0, None)
    dts = (torch.float32,) * 3
    one, two = (k3._ddim_step_bwd_cuda(eps_mod.contiguous(), x, coeffs, dts, (True,) * 3)
                for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(one, two))
    # the learned log-variance: the second half of eps's rows, or its own tensor
    lv = eps.as_strided(eps.shape, eps.stride(), eps.storage_offset() + 3) if learn_sigma \
        else eps_mod
    d_args = (x, eps, lv, torch.full((batch,), 0.02, device=cuda_device), a, 5.0, noise)
    assert torch.equal(kddpm.ddpm_step(*d_args), kddpm.ddpm_step(*d_args))


@pytest.mark.cuda
@pytest.mark.parametrize("model_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cotangents", ["both", "x0_t"])
@pytest.mark.parametrize("needs", [(True, True, True), (False, False, True), (True, False, False),
                                   (False, True, False), (True, True, False), (False, True, True),
                                   (True, False, True)])
def test_ddim_step_backward_kernel_needs_match_autograd(cuda_device, needs, cotangents,
                                                        model_dtype):
    """K3-bwd on the learn_sigma views writes only the gradients asked for,
    each within 1e-6 of scale (1e-2 in bf16) of autograd through the plain
    forward; one launch per backward. (False, False, True) from x0_t alone
    is the training step's."""
    g = torch.Generator(device=cuda_device).manual_seed(33)
    x = torch.randn(1, 256, 256, 3, generator=g, device=cuda_device).requires_grad_(needs[0])
    raw, raw_mod = (torch.randn(1, 256, 256, 6, generator=g, device=cuda_device).to(model_dtype)
                    .requires_grad_(n) for n in needs[1:])
    g_xn, g_x0 = (torch.randn(x.shape, generator=g, device=cuda_device) for _ in range(2))
    coeffs = (torch.tensor([0.3], device=cuda_device), torch.tensor([0.35], device=cuda_device),
              0.0, None)
    cots = (g_xn, g_x0) if cotangents == "both" else (None, g_x0)
    wanted = [t for t in (x, raw, raw_mod) if t.requires_grad]

    def grads(fn):
        x_next, x0_t = fn(x, raw[..., :3], raw_mod[..., :3], *coeffs)
        pairs = [(o, c) for o, c in zip((x_next, x0_t), cots) if c is not None and o.requires_grad]
        if not pairs:  # no path from the cotangents to the inputs: zero gradients
            return tuple(torch.zeros_like(t) for t in wanted)
        outs, gs = zip(*pairs)
        return torch.autograd.grad(outs, wanted, gs, allow_unused=True, materialize_grads=True)

    want = grads(k3.ddim_step_plain)
    n = k3.ddim_step.bwd_launches
    got = grads(k3.ddim_step)
    assert k3.ddim_step.bwd_launches == n + 1
    for w, g_, t in zip(want, got, wanted):
        assert g_.dtype == t.dtype and g_.shape == t.shape
        bound = 1e-6 if t.dtype == torch.float32 else 1e-2
        if w.abs().max() == 0:
            assert g_.abs().max() == 0
        else:
            close_to_scale(w.float().cpu().numpy(), g_.float().cpu().numpy(),
                           f"K3-bwd {needs} {cotangents}", bound=bound)


@pytest.mark.cuda
def test_ddpm_step_kernel_at_batch_8(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(35)
    x, noise = (torch.randn(8, 256, 256, 3, generator=g, device=cuda_device) for _ in range(2))
    raw = torch.randn(8, 256, 256, 6, generator=g, device=cuda_device)
    raw[..., 3:] = -2.0 + 0.5 * raw[..., 3:]
    t = torch.tensor([999.0, 0.0] * 4, device=cuda_device)
    args = (x, raw[..., :3], raw[..., 3:], torch.full((8,), 0.02, device=cuda_device),
            torch.linspace(1e-4, 0.5, 8, device=cuda_device), t, noise)
    a = kddpm.ddpm_launch_args(*args)
    assert (a.mode, a.lv_mode) == (k3.ROWS, kddpm.LV_PAIRED)
    close_to_scale(kddpm.ddpm_step_plain(*args).cpu().numpy(),
                   kddpm.ddpm_step(*args).cpu().numpy(), "ddpm batch 8", bound=1e-6)


@pytest.mark.cuda
def test_step_kernels_take_per_sample_tensors_of_any_dtype_and_place(cuda_device):
    """A [B] coefficient on the CPU, in float64, or an integer t reaches the
    kernels as f32 copies on the card (`coef_operand`) and gives what the
    plain version gives."""
    g = torch.Generator(device=cuda_device).manual_seed(36)
    x, eps, eps_mod, noise = (torch.randn(2, 256, 256, 3, generator=g, device=cuda_device)
                              for _ in range(4))
    at = torch.tensor([0.80, 0.30])  # on the CPU
    at_next = torch.tensor([0.85, 0.35], dtype=torch.float64, device=cuda_device)
    n = k3.ddim_step.launches
    for w, g_ in zip(k3.ddim_step_plain(x, eps, eps_mod, at, at_next, 1.0, noise),
                     k3.ddim_step(x, eps, eps_mod, at, at_next, 1.0, noise)):
        close_to_scale(w.cpu().numpy(), g_.cpu().numpy(), "K3, CPU and f64 coefficients",
                       bound=1e-6)
    assert k3.ddim_step.launches == n + 1
    t = torch.tensor([999, 0], device=cuda_device)  # integer
    args = (x, eps, torch.tensor([-3.9, -6.1], dtype=torch.float64), torch.tensor([0.02, 0.008]),
            at, t, noise)
    n = kddpm.ddpm_step.launches
    close_to_scale(kddpm.ddpm_step_plain(*args).cpu().numpy(), kddpm.ddpm_step(*args).cpu().numpy(),
                   "ddpm, CPU, f64 and integer per-sample tensors", bound=1e-6)
    assert kddpm.ddpm_step.launches == n + 1


# ---------------------------------------------------------------------------
# the h-rows path on the full-width CelebA-HQ DDPM++ UNet (the seeded random
# init of `--allow_random_weights`): one input-mode edited eval and one rows-training timestep's
# gradient, kernels against the plain versions. Float32 within 1e-3 of scale
# (the UNet's ~30 normalized layers carry K1's and K2's 1e-5); bfloat16 no
# farther from the float32 plain result than 2x the plain versions in bf16.
# ---------------------------------------------------------------------------


def _plain_versions():
    from contextlib import ExitStack
    from unittest import mock

    stack = ExitStack()
    stack.enter_context(mock.patch.object(k1, "group_norm", k1.group_norm_plain))
    stack.enter_context(mock.patch.object(k2, "attention", k2.attention_plain))
    stack.enter_context(mock.patch.object(k3, "ddim_step", k3.ddim_step_plain))
    return stack


@pytest.fixture(scope="module")
def celeba():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from asyrp_official_torch.core.schedule import make_schedule
    from asyrp_official_torch.models import delta
    from asyrp_official_torch.models.registry import resolve
    from asyrp_official_torch.utils import hostrng

    dev = torch.device("cuda")
    spec = resolve("CelebA_HQ")
    model = spec.build()
    model.load_state_dict(spec.state_dict_from_jax(spec.init(hostrng.PRNGKey(0))))
    model = model.to(dev).eval().requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(40)
    hw, ch = spec.bottleneck_hw, spec.bottleneck_ch
    rows = 0.2 * torch.randn(3, ch, hw, hw, generator=g, device=dev)
    x = torch.randn(1, 256, 256, 3, generator=g, device=dev)
    acp = torch.from_numpy(make_schedule().alphas_cumprod_ext).to(dev)
    # full-f32 convolutions and matmuls, as the port's runner sets them on CUDA
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield dict(spec=spec, model=model, delta=delta, rows=rows, x=x, t=torch.full((1,), 999.0,
               device=dev), at=acp[1000].reshape(1), at_next=acp[975].reshape(1),
               cot=torch.randn(x.shape, generator=g, device=dev))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _two_dtypes(fn, check):
    """fn(dtype) with the kernels and with the plain versions, cuDNN
    deterministic: float32 within 1e-3; bf16 kernels within 2x the plain
    bf16 distance from the float32 plain result."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kern, kern_bf = fn(torch.float32), fn(torch.bfloat16)
        with _plain_versions():
            plain, plain_bf = fn(torch.float32), fn(torch.bfloat16)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    close_to_scale(plain.cpu().numpy(), kern.cpu().numpy(), f"{check} float32", bound=1e-3)
    scale = plain.abs().max()
    kern_err = float((kern_bf.float() - plain).abs().max() / scale)
    plain_err = float((plain_bf.float() - plain).abs().max() / scale)
    assert kern_err <= 2.0 * plain_err, (check, kern_err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("style", ["add", "slerp"])
def test_input_mode_edited_eval_kernels_match_plain(celeba, style):
    s = celeba
    edit = s["delta"].EditState(mode="input", delta_rows=s["rows"], input_style=style,
                                hs_coeff=torch.tensor([0.9, 1.2], device=s["x"].device),
                                delta_idx=2)
    launched = k1.group_norm.launches, k2.attention.launches

    @torch.no_grad()
    def eps_mod(dtype):
        return s["spec"].apply(s["model"], s["x"].to(dtype), s["t"], edit=edit)[1].float()

    _two_dtypes(eps_mod, f"eps_mod ({style})")
    assert k1.group_norm.launches > launched[0] and k2.attention.launches > launched[1]


def _gn_exact(x, weight, bias, *, groups=32, eps=1e-6, silu=False, pre_add=None,
              scale_shift=None):
    """K1's math in x's dtype throughout (the plain version computes in f32)."""
    def per_channel(t):
        return t.reshape(t.shape[:2] + (1,) * (x.dim() - 2))

    if pre_add is not None:
        x = x + per_channel(pre_add)
    y = torch.nn.functional.group_norm(x, groups, weight.to(x.dtype), bias.to(x.dtype), eps)
    if scale_shift is not None:
        scale, shift = (per_channel(t) for t in scale_shift.chunk(2, dim=1))
        y = y * (1.0 + scale) + shift
    return torch.nn.functional.silu(y) if silu else y


@pytest.fixture(scope="module")
def celeba_torch_init(celeba):
    """`celeba` with torch's default init of the UNet, seeded: smaller
    activations than the seeded JAX-style init, and a rows gradient whose
    largest entry is some 1e-5."""
    torch.manual_seed(0)
    model = celeba["spec"].build().to(celeba["x"].device).eval().requires_grad_(False)
    return {**celeba, "model": model}


@pytest.mark.cuda
@pytest.mark.parametrize("init,tf32", [("seeded", False), ("torch_default", False),
                                       ("torch_default", True)])
def test_rows_training_gradient_kernels_match_plain(request, init, tf32):
    """One edited timestep's gradient w.r.t. the stacked rows: only the
    step's row gets one, through K1-bwd, K2-bwd and K3-bwd. A float64
    witness (the same composition in float64: torch's GroupNorm, the plain
    attention, the DDIM step's x0 formula) is the truth both float32
    results are held to: the kernels may be at most 2x as far from it as
    the plain versions are. `tf32` runs the float32 convolutions in TF32
    (torch's default for cuDNN; the port's runner turns it off). At the
    seeded init the kernels are also held within 1e-3 of the plain versions
    (2x in bf16), as everywhere else."""
    import copy
    from contextlib import ExitStack
    from unittest import mock

    s = request.getfixturevalue("celeba" if init == "seeded" else "celeba_torch_init")
    leaf = s["rows"].clone().requires_grad_(True)
    launched = (k1.group_norm.bwd_launches, k2.attention.bwd_launches, k3.ddim_step.bwd_launches)

    def grad(dtype, leaf=leaf, model=s["model"], exact=False):
        edit = s["delta"].EditState(mode="input", delta_rows=leaf, input_style="add",
                                    hs_coeff=torch.tensor([1.0, 1.0], device=leaf.device))
        e = edit.at_step({"use_delta": 1.0, "delta_idx": 1})
        leaf.grad = None
        x = s["x"].to(dtype)
        eps, eps_mod, _, _ = s["spec"].apply(model, x, s["t"], edit=e, decode_mode="split")
        if exact:
            at = s["at"].to(dtype).reshape(1, 1, 1, 1)
            x0_t = (x - eps_mod * torch.sqrt(1.0 - at)) / torch.sqrt(at)
        else:
            _, x0_t = k3.ddim_step(s["x"], eps, eps_mod, s["at"], s["at_next"], 0.0)
        (x0_t * s["cot"].to(x0_t.dtype)).mean().backward()
        assert not leaf.grad[0].any() and not leaf.grad[2].any()
        return leaf.grad[1]

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.backends.cudnn.allow_tf32 = tf32
        kern = grad(torch.float32).float()
        with _plain_versions():
            plain = grad(torch.float32).float()
        torch.backends.cudnn.allow_tf32 = False
        with ExitStack() as stack:
            stack.enter_context(mock.patch.object(k1, "group_norm", _gn_exact))
            stack.enter_context(mock.patch.object(k2, "attention", k2.attention_plain))
            leaf64 = s["rows"].double().requires_grad_(True)
            truth = grad(torch.float64, leaf64, copy.deepcopy(s["model"]).double(), exact=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.allow_tf32 = False  # as the `celeba` fixture set it
    scale = float(truth.abs().max())

    def dist(a, b):
        return float((a.double() - b.double()).abs().max()) / scale

    readings = {"init": init, "tf32": tf32, "grad_max": scale, "kernels_vs_plain": dist(kern, plain),
                "kernels_vs_f64": dist(kern, truth), "plain_vs_f64": dist(plain, truth)}
    print("rows gradient", readings)
    assert readings["kernels_vs_f64"] <= 2.0 * readings["plain_vs_f64"], readings
    if init == "seeded":
        _two_dtypes(grad, "rows gradient")
    assert (k1.group_norm.bwd_launches > launched[0] and k2.attention.bwd_launches > launched[1]
            and k3.ddim_step.bwd_launches > launched[2])


# K1 across ranks and K2 with Tq != Tk: the entries spatial sharding runs
# (S row blocks of one image, computed on one card here). The shapes are the
# serving path's at S = 2 and 4: DDPM++ custom.yml (256^2) and afhq.yml;
# and the apply kernels' and the cluster plan's edges.
_ACROSS_NORMS = [
    # (whole NCHW shape, S, fused, each block a misaligned view)
    ((1, 128, 256, 256), 4, "pre_add", False),
    ((1, 256, 256, 256), 4, None, False),     # the decoder's concat at 256^2
    ((1, 256, 64, 64), 2, "pre_add", False),
    ((1, 512, 16, 16), 4, "scale_shift", False),
    ((1, 512, 8, 8), 4, None, False),         # the bottleneck: 2 rows per rank, 16 groups a block
    ((4, 512, 8, 8), 4, "scale_shift", False),  # 4 samples of it: groups of two samples a block
    ((2, 384, 32, 32), 2, "scale_shift", False),
    ((1, 64, 6, 5), 2, "pre_add", False),     # H·W 15: no 16-byte vector (the scalar instance)
    ((1, 128, 64, 64), 2, "pre_add", True),   # 16-byte vectors refused by the views
    ((1, 256, 512, 512), 2, None, False),     # an f32 group of 4 MiB: a cluster streams part
]


def _misaligned(t):
    """t's values in a contiguous view one element into its storage."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,s,fused,misaligned", _ACROSS_NORMS)
def test_group_norm_across_kernels_match_plain(cuda_device, shape, s, fused, misaligned, dtype,
                                               bound):
    """Per row block: the part statistics kernel (one part per block)
    against the plain parts; the apply kernel, which combines the S
    gathered parts itself, against the plain apply from the same parts,
    with and without SiLU; every block's combined statistics bit for bit
    alike and against `combine_group_stats`; two calls bit for bit; and the
    whole (blocks concatenated) against `group_norm_plain` on the whole
    tensor."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    b, c = shape[:2]
    x = (torch.randn(shape, generator=g, device=cuda_device) * 3 + 4).to(dtype)
    w = 1 + 0.1 * torch.randn(c, generator=g, device=cuda_device)
    bias = 0.1 * torch.randn(c, generator=g, device=cuda_device)
    kw = {}
    if fused == "pre_add":
        kw["pre_add"] = torch.randn(b, c, generator=g, device=cuda_device).to(dtype)
    elif fused == "scale_shift":
        kw["scale_shift"] = (0.5 * torch.randn(b, 2 * c, generator=g, device=cuda_device)).to(dtype)
    blocks = [t.contiguous() for t in x.chunk(s, dim=2)]
    if misaligned:
        blocks = [_misaligned(t) for t in blocks]
    n_part, n_apply = k1.group_norm.part_launches, k1.group_norm.apply_launches
    parts = torch.stack([k1.group_norm_part_stats(xb, pre_add=kw.get("pre_add")) for xb in blocks])
    parts_p = torch.stack([k1.group_norm_part_stats_plain(xb, pre_add=kw.get("pre_add"))
                           for xb in blocks])
    assert parts.shape == parts_p.shape == (s, b, 32, 1, 3)
    assert torch.equal(parts[..., 0], parts_p[..., 0])
    for i, what in ((1, "mean"), (2, "M2")):
        close_to_scale(parts_p[..., i].cpu().numpy(), parts[..., i].cpu().numpy(),
                       f"part {what}", bound=1e-5)
    mean_p, rstd_p = k1.combine_group_stats(parts, 1e-6)
    for silu in (False, True):
        outs = [k1.group_norm_apply(xb, w, bias, parts, eps=1e-6, silu=silu, stats=True, **kw)
                for xb in blocks]
        for _, m, r in outs:  # every rank combines the same bits
            assert torch.equal(m, outs[0][1]) and torch.equal(r, outs[0][2])
        close_to_scale(mean_p.cpu().numpy(), outs[0][1].cpu().numpy(), "across mean", bound=1e-5)
        close_to_scale(rstd_p.cpu().numpy(), outs[0][2].cpu().numpy(), "across rstd", bound=1e-5)
        for xb, (yb, _, _) in zip(blocks, outs):
            want = k1.group_norm_apply_plain(xb, w, bias, parts, eps=1e-6, silu=silu, **kw)
            close_to_scale(want.float().cpu().numpy(), yb.float().cpu().numpy(),
                           f"across apply silu={silu}", bound=bound)
        again = k1.group_norm_apply(blocks[-1], w, bias, parts, eps=1e-6, silu=silu, **kw)
        assert torch.equal(again, outs[-1][0])
        whole = k1.group_norm_plain(x, w, bias, silu=silu, **kw)
        close_to_scale(whole.float().cpu().numpy(),
                       torch.cat([o[0] for o in outs], dim=2).float().cpu().numpy(),
                       f"across vs whole silu={silu}", bound=bound)
    assert k1.group_norm.part_launches == n_part + s
    assert k1.group_norm.apply_launches == n_apply + 2 * (s + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,tq,tk,c,heads,legacy", [
    (1, 64, 256, 512, 1, False),    # DDPM++ 16^2 at S = 4
    (1, 128, 256, 512, 1, False),   # S = 2
    (1, 16, 64, 512, 1, False),     # the 8^2 bottleneck at S = 4
    (1, 64, 256, 512, 8, True),     # afhq.yml 8 heads of 64 at S = 4
    (2, 128, 256, 512, 8, True),
    (1, 100, 256, 512, 1, False),   # ragged Tq
    (1, 37, 200, 512, 8, True),     # ragged Tq and Tk
])
def test_attention_kv_kernel_matches_plain(cuda_device, b, tq, tk, c, heads, legacy, dtype,
                                           bound):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(b, tq, c, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(b, tk, c, generator=g, device=cuda_device).to(dtype) for _ in range(2))
    n = k2.attention.kv_launches
    _check_lse(q, k, v, heads, legacy, bound)
    got = k2.attention(q, k, v, num_heads=heads, legacy_scale=legacy)
    want = k2.attention_plain(q, k, v, num_heads=heads, legacy_scale=legacy)
    close_to_scale(want.float().cpu().numpy(), got.float().cpu().numpy(), "attention kv",
                   bound=bound)
    assert k2.attention.kv_launches == n + 2


# K1-bwd across ranks and K2-bwd with Tq != Tk: the backward entries spatial
# training runs (S row blocks of one image on one card here; the cross-rank
# sum of the K1 sums is a sum over the blocks). The shapes are chip_smoke.py
# phase 15 (e)'s: custom.yml's decoder norms at S = 4, from the DeltaBlock's
# at the 8^2 bottleneck to the 256^2 level, and afhq.yml's at S = 2 (FiLM:
# the norm without SiLU, the epilogue in torch ops around it); and ragged
# local runs (the scalar instance).
_ACROSS_BWD = [
    # (whole NCHW shape, S, silu, each block a misaligned view)
    ((1, 512, 8, 8), 4, True, False),        # the DeltaBlock's norm: [1, 512, 2, 8] per rank
    ((4, 512, 8, 8), 4, True, False),        # 4 samples of it
    ((1, 128, 256, 256), 4, True, False),    # [1, 128, 64, 256] per rank
    ((1, 256, 256, 256), 4, True, False),
    ((1, 512, 32, 32), 4, False, False),
    ((1, 512, 16, 16), 2, False, False),     # afhq.yml's FiLM norms at S = 2
    ((2, 384, 32, 32), 2, False, False),
    ((1, 64, 6, 5), 2, True, False),         # 15 elements per channel: the scalar instance
    ((1, 128, 64, 64), 2, True, True),       # 16-byte vectors refused by the views
    ((1, 256, 512, 512), 2, True, False),    # an f32 group of 4 MiB of x and of dy: dy streams
]


def _across_bwd(x, dy, w, b, s, silu, misaligned=False, eps=1e-6):
    """Per block of S: the backward part and apply kernels (the blocks' sums
    added in block order, as the all-reduce adds the ranks'), and their
    plain versions from the same combined statistics."""
    blocks = [t.contiguous() for t in x.chunk(s, dim=2)]
    dys = [t.contiguous() for t in dy.chunk(s, dim=2)]
    if misaligned:
        blocks, dys = [_misaligned(t) for t in blocks], [_misaligned(t) for t in dys]
    parts = torch.stack([k1.group_norm_part_stats_plain(xb) for xb in blocks])
    mean, rstd = k1.combine_group_stats(parts, eps)
    count = x[0, : x.shape[1] // 32].numel()
    out = {}
    for name, part, apply in (("kernel", k1.group_norm_bwd_part, k1.group_norm_bwd_apply),
                              ("plain", k1.group_norm_bwd_part_plain,
                               k1.group_norm_bwd_apply_plain)):
        res = [part(xb, db, w, b, mean, rstd, silu=silu) for xb, db in zip(blocks, dys)]
        sums = sum(r[0] for r in res)
        dx = torch.cat([apply(xb, db, w, b, mean, rstd, sums, count, silu=silu)
                        for xb, db in zip(blocks, dys)], dim=2)
        out[name] = (dx, sum(r[1] for r in res).sum(dim=0), res)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape,s,silu,misaligned", _ACROSS_BWD)
def test_group_norm_bwd_across_kernels_match_plain(cuda_device, shape, s, silu, misaligned, dtype,
                                                   bound):
    """`gn_bwd_part` (sums and per-channel partials) and `gn_bwd_apply`
    against their plain versions per block, and the blocks' dx, dw and db
    against `torch.autograd.grad` through `group_norm_plain` on the whole
    tensor; one launch of each per block; two calls bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 3 + 4).to(dtype)
    dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    w = 1 + 0.1 * torch.randn(shape[1], generator=g, device=cuda_device)
    b = 0.1 * torch.randn(shape[1], generator=g, device=cuda_device)
    n = k1.group_norm.bwd_part_launches, k1.group_norm.bwd_apply_launches, k1.group_norm.bwd_launches
    out = _across_bwd(x, dy, w, b, s, silu, misaligned)
    assert (k1.group_norm.bwd_part_launches, k1.group_norm.bwd_apply_launches,
            k1.group_norm.bwd_launches) == (n[0] + s, n[1] + s, n[2])
    (dx, dwb, res), (dx_p, dwb_p, res_p) = out["kernel"], out["plain"]
    for (sums, wsum), (sums_p, wsum_p) in zip(res, res_p):
        close_to_scale(sums_p.cpu().numpy(), sums.cpu().numpy(), "bwd part sums", bound=1e-4)
        close_to_scale(wsum_p.cpu().numpy(), wsum.cpu().numpy(), "bwd part wsum", bound=1e-4)
    close_to_scale(dx_p.float().cpu().numpy(), dx.float().cpu().numpy(), "bwd apply dx",
                   bound=bound)
    xw, ww, bw = (t.detach().float().requires_grad_() for t in (x, w, b))
    want = torch.autograd.grad(k1.group_norm_plain(xw, ww, bw, silu=silu), (xw, ww, bw),
                               dy.float())
    for wnt, got, what in zip(want, (dx, dwb[0], dwb[1]), ("dx", "dw", "db")):
        close_to_scale(wnt.cpu().numpy(), got.float().cpu().numpy(), f"across {what}",
                       bound=bound)
    again = _across_bwd(x, dy, w, b, s, silu, misaligned)["kernel"]
    assert torch.equal(again[0], dx) and torch.equal(again[1], dwb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,tq,tk,c,heads,legacy", [
    (1, 64, 256, 512, 1, False),    # DDPM++ 16^2 at S = 4: Tq one query tile
    (1, 16, 64, 512, 1, False),     # the 8^2 bottleneck at S = 4
    (1, 128, 256, 512, 8, True),    # afhq.yml 8 heads of 64 at S = 2
    (2, 128, 256, 512, 8, True),
    (1, 100, 256, 512, 1, False),   # ragged Tq
    (1, 37, 200, 512, 8, True),     # ragged Tq and Tk
    (1, 256, 64, 512, 1, False),    # more queries than keys
])
def test_attention_bwd_kv_kernel_matches_autograd(cuda_device, b, tq, tk, c, heads, legacy,
                                                  dtype, bound):
    """K2-bwd with Tq != Tk (`asyrp_attention_bwd_kv`) against
    `torch.autograd.grad` through the plain forward; one launch of the kv
    entry, none of the one-length ones; two calls bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    q = torch.randn(b, tq, c, generator=g, device=cuda_device).to(dtype).requires_grad_()
    k, v = (torch.randn(b, tk, c, generator=g, device=cuda_device).to(dtype).requires_grad_()
            for _ in range(2))
    d_o = torch.randn(b, tq, c, generator=g, device=cuda_device).to(dtype)
    kw = dict(num_heads=heads, legacy_scale=legacy)
    n = k2.attention.kv_bwd_launches, k2.attention.bwd_launches, k2.attention.mh_bwd_launches
    want = torch.autograd.grad(k2.attention_plain(q, k, v, **kw), (q, k, v), d_o)
    got = torch.autograd.grad(k2.attention(q, k, v, **kw), (q, k, v), d_o)
    for ww, gg, what in zip(want, got, "qkv"):
        close_to_scale(ww.float().cpu().numpy(), gg.float().cpu().numpy(),
                       f"attention bwd kv d{what}", bound=bound)
    assert (k2.attention.kv_bwd_launches, k2.attention.bwd_launches,
            k2.attention.mh_bwd_launches) == (n[0] + 1, n[1], n[2])
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, lse = k2._attention_cuda(qd, kd, vd, True, heads, legacy)
    first = k2.attention_backward(qd, kd, vd, o, d_o, lse, **kw)
    second = k2.attention_backward(qd, kd, vd, o, d_o, lse, **kw)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


# the channels-last K1 (`gn_fwd_nhwc_stats` + `gn_fwd_nhwc_apply`) at the bf16
# AFHQ cell's shapes: batch 16 at every level, the dual decode's batch-32
# concat at 256^2, the bottleneck; then odd shapes (groups across a vector,
# one slice, the widest row a block takes)
_NHWC_SHAPES = [(16, 128, 256, 256), (16, 128, 128, 128), (16, 256, 64, 64), (16, 256, 32, 32),
                (16, 512, 16, 16), (16, 512, 8, 8), (32, 256, 256, 256), (3, 96, 12, 10),
                (1, 64, 1, 7), (2, 1024, 4, 4)]
_NHWC_EPILOGUES = ["none", "silu", "pre_add", "pre_add_silu", "scale_shift", "scale_shift_silu"]


def _err_to_scale(want, got):
    """max|want - got| / max|want|, on the device (the largest rows hold
    half a billion elements)."""
    want, got = want.float(), got.float()
    return float((want - got).abs().max() / want.abs().max())


def _nhwc_kw(kind, shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    kw = {"eps": 1e-5, "silu": kind.endswith("silu")}
    if kind.startswith("pre_add"):
        kw["pre_add"] = torch.randn(shape[0], shape[1], generator=g, device=device).to(dtype)
    elif kind.startswith("scale_shift"):
        kw["scale_shift"] = (0.5 * torch.randn(shape[0], 2 * shape[1], generator=g,
                                               device=device)).to(dtype)
    return kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", _NHWC_SHAPES)
def test_group_norm_nhwc_kernel_matches_plain(cuda_device, shape, dtype, bound):
    """Every epilogue and the statistics out, against the plain version on
    the same channels-last input (K1's tolerances); the result channels-last;
    the fused epilogues within 1e-6 of scale (f32) or one bf16 step of the
    channels-last K1 followed by the torch ops; two calls bit for bit; two
    launches counted as one call."""
    x, w, b, _ = _gn_inputs(shape, dtype, cuda_device, 30)
    x = x.contiguous(memory_format=torch.channels_last)
    for i, kind in enumerate(_NHWC_EPILOGUES):
        kw = _nhwc_kw(kind, shape, dtype, cuda_device, 31 + i)
        n, nh = k1.group_norm.launches, k1.group_norm.nhwc_launches
        with torch.no_grad():
            got = k1.group_norm(x, w, b, **kw)
            again = k1.group_norm(x, w, b, **kw)
        assert (k1.group_norm.launches, k1.group_norm.nhwc_launches) == (n + 2, nh + 2)
        assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == dtype
        assert torch.equal(got, again), kind
        err = _err_to_scale(k1.group_norm_plain(x, w, b, **kw), got)
        assert err <= bound, (kind, err)
        if kind not in ("none", "silu"):
            unfused = k1.group_norm_unfused(x, w, b, **kw)
            if dtype == torch.float32:
                assert _err_to_scale(unfused, got) <= 1e-6, kind
            else:
                assert _bf16_steps(got, unfused) <= 1, kind
    y, mean, rstd = k1._group_norm_cuda(x, w, b, 32, 1e-5, True, stats=True)
    y_p, mean_p, rstd_p = k1._plain_with_stats(x, w, b, 32, 1e-5, True)
    assert _err_to_scale(y_p, y) <= bound
    assert _err_to_scale(mean_p, mean) <= 1e-5 and _err_to_scale(rstd_p, rstd) <= 1e-5
    two = k1._group_norm_cuda(x, w, b, 32, 1e-5, True, stats=True)
    assert all(torch.equal(a, c) for a, c in zip((y, mean, rstd), two))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_nhwc_kernel_on_a_misaligned_view(cuda_device, dtype):
    """A channels-last view one element past a 16-byte boundary takes the
    kernels' one-element instance."""
    shape = (2, 64, 12, 10)
    n = 2 * 64 * 12 * 10
    g = torch.Generator(device=cuda_device).manual_seed(40)
    buf = (torch.randn(n + 1, generator=g, device=cuda_device) * 2 + 0.5).to(dtype)
    x = buf[1:].view(2, 12, 10, 64).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16
    _, w, b, _ = _gn_inputs(shape, dtype, cuda_device, 41)
    bound = 1e-5 if dtype == torch.float32 else 2e-2
    for silu in (False, True):
        with torch.no_grad():
            got = k1.group_norm(x, w, b, silu=silu)
        assert _err_to_scale(k1.group_norm_plain(x, w, b, silu=silu), got) <= bound


@pytest.mark.cuda
def test_group_norm_nhwc_refuses_a_row_wider_than_a_block(cuda_device):
    """f32 at 2048 channels is 512 vectors a row, past the 256 threads of a
    block: the launch is refused and the wrapper raises."""
    x = torch.randn(1, 2048, 4, 4, device=cuda_device).contiguous(memory_format=torch.channels_last)
    w, b = torch.ones(2048, device=cuda_device), torch.zeros(2048, device=cuda_device)
    with pytest.raises(RuntimeError, match="group_norm kernel"):
        k1.group_norm(x, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 512, 8, 8), (16, 128, 256, 256)])
def test_group_norm_layouts_launch_their_own_kernels(cuda_device, shape):
    """An NCHW call stays one `gn_fwd` kernel; a channels-last call is its
    `gn_fwd_nhwc` kernel (the slab plan) or two (statistics and apply), all
    named `gn_fwd` so the benchmark files them as K1; the two layouts agree
    within K1's bf16 tolerance."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, w, b, _ = _gn_inputs(shape, torch.bfloat16, cuda_device, 42)
    xl = x.contiguous(memory_format=torch.channels_last)
    per_call = 1 if k1.group_norm_nhwc_plan(shape, torch.bfloat16)["slab"] else 2
    for a, most, want in ((x, 1, "gn_fwd"), (xl, per_call, "gn_fwd_nhwc")):
        k1.group_norm(a, w, b, silu=True)
        torch.cuda.synchronize()
        kernels = []
        for _ in range(3):  # a profile may record no device event at all; then again
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    k1.group_norm(a, w, b, silu=True)
                torch.cuda.synchronize()
            kernels = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
            if kernels:
                break
        # the trace may drop an event, never add one
        assert 0 < len(kernels) <= 4 * most and all(want in k for k in kernels), kernels
        assert a is xl or not any("nhwc" in k for k in kernels), kernels
    assert _err_to_scale(k1.group_norm(x, w, b, silu=True),
                         k1.group_norm(xl, w, b, silu=True)) <= 2e-2


@pytest.mark.cuda
def test_group_norm_nhwc_plans_take_both_designs(cuda_device):
    """A map of at most 2048 pixels takes the one-launch slab kernel (a
    block per sample and slab of whole groups, 16 KB or more); a larger one
    the statistics and apply kernels. The rows of
    `test_group_norm_nhwc_kernel_matches_plain` cover both."""
    plan = lambda shape, dtype=torch.bfloat16: k1.group_norm_nhwc_plan(shape, dtype)
    assert plan((16, 512, 8, 8))["slab"] == 128
    assert plan((16, 512, 16, 16))["slab"] == 32
    assert plan((32, 256, 32, 32))["slab"] == 16
    assert plan((16, 128, 64, 64))["slab"] == 0
    assert plan((16, 128, 256, 256))["slab"] == 0
    assert plan((32, 256, 32, 32), torch.float32)["slab"] == 8
