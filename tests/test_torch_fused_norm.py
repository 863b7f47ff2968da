"""K1's fused serving entry (`group_norm(..., pre_add=, scale_shift=)`) and
the blocks that call it, against the JAX compositions they stand for, on
the CPU (the wrapper runs its plain version there;
tests/test_torch_kernels_cuda.py holds the kernel to it on a GPU):

- `pre_add`: `h + temb` -> `group_norm` (-> `swish`), as DDPM++'s
  `_resblock` and both DeltaBlocks compose it;
- `scale_shift`: `group_norm` -> `h * (1 + scale) + shift` (-> `silu`), the
  OpenAI scale-shift `_resblock`.

A DDPM++ ResnetBlock, both DeltaBlock flavors and an OpenAI ResBlock run
once without a gradient (the fused entry) and once under autograd (K1's
`autograd.Function` between torch ops), against the JAX block and its vjp.

Tolerances as tests/test_torch_ops.py: `close_to_scale` 1e-4 in float32;
1e-2 with bfloat16 inputs (XLA rounds the GroupNorm output before the
SiLU, the port's K1 after it: one bf16 ulp of scale).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.compat.from_jax import _openai_layer, _resblock, _tensors
from asyrp_official_torch.compat.from_jax import delta_block_state_dict_from_jax
from asyrp_official_torch.models import ddpmpp as tddpmpp
from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models import openai_unet as toai
from asyrp_official_torch.ops import groupnorm as k1
from asyrp_official_tpu.models import common as jcm
from asyrp_official_tpu.models import ddpmpp as jddpmpp
from asyrp_official_tpu.models import delta as jdelta
from asyrp_official_tpu.models import openai_unet as joai
from asyrp_official_tpu.utils import hostrng

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def _norm_inputs(shape, seed, width):
    """x (NHWC), the norm's scale and bias, and a [B, width * C] operand."""
    rng = np.random.RandomState(seed)
    b, c = shape[0], shape[-1]
    x = (rng.randn(*shape) * 3.0 + 1.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    extra = (0.5 * rng.randn(b, width * c)).astype(np.float32)
    return x, scale, bias, extra


def _jax_pre_add(p, x, t, silu, eps):
    h = jcm.group_norm(p, x + t[:, None, None, :], eps=eps)
    return jcm.swish(h) if silu else h


def _jax_scale_shift(p, x, ss, silu, eps):
    scale, shift = jnp.split(ss, 2, axis=-1)
    h = jcm.group_norm(p, x, eps=eps)
    h = h * (1.0 + scale[:, None, None, :]) + shift[:, None, None, :]
    return jcm.swish(h) if silu else h


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("kind,shape,eps", [("pre_add", (2, 8, 8, 64), 1e-6),
                                            ("pre_add", (1, 4, 4, 512), 1e-6),
                                            ("scale_shift", (2, 8, 8, 64), 1e-5),
                                            ("scale_shift", (1, 4, 4, 512), 1e-5)])
def test_fused_plain_matches_jax_composition(kind, shape, eps, silu, dtype):
    """The plain fused version (the wrapper's CPU path) against the JAX
    ops it fuses, with and without SiLU, in the I/O dtype."""
    tdt, jdt, bound = DTYPES[dtype]
    x, scale, bias, extra = _norm_inputs(shape, 11, 1 if kind == "pre_add" else 2)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    jx, je = jnp.asarray(x, jdt), jnp.asarray(extra, jdt)
    want = (_jax_pre_add if kind == "pre_add" else _jax_scale_shift)(p, jx, je, silu, eps)
    assert want.dtype == jdt
    got = k1.group_norm(_nchw(x).to(tdt), torch.from_numpy(scale), torch.from_numpy(bias),
                        eps=eps, silu=silu, **{kind: torch.from_numpy(extra).to(tdt)})
    assert got.dtype == tdt
    close_to_scale(np.asarray(want.astype(jnp.float32)), _nhwc(got), f"{kind} silu={silu}",
                   bound=bound)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("kind", ["pre_add", "scale_shift"])
def test_fused_entry_under_autograd_matches_jax_vjp(kind, silu):
    """With a gradient to track the entry is K1's Function between torch
    ops: its gradients w.r.t. x, the norm's weight and bias, and the fused
    operand against XLA's."""
    shape, eps = (2, 8, 8, 64), 1e-5
    x, scale, bias, extra = _norm_inputs(shape, 12, 1 if kind == "pre_add" else 2)
    dy = np.random.RandomState(13).randn(*shape).astype(np.float32)
    fn = _jax_pre_add if kind == "pre_add" else _jax_scale_shift
    _, vjp = jax.vjp(lambda p, xx, e: fn(p, xx, e, silu, eps),
                     {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x),
                     jnp.asarray(extra))
    dp, dx, de = vjp(jnp.asarray(dy))
    xt = _nchw(x).requires_grad_()
    w, b = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    et = torch.from_numpy(extra).requires_grad_()
    n = k1.group_norm.launches
    k1.group_norm(xt, w, b, eps=eps, silu=silu, **{kind: et}).backward(_nchw(dy))
    assert k1.group_norm.launches == n  # the CPU runs the plain version
    close_to_scale(np.asarray(dx), _nhwc(xt.grad), "dx")
    close_to_scale(np.asarray(dp["scale"]), w.grad.numpy(), "dscale")
    close_to_scale(np.asarray(dp["bias"]), b.grad.numpy(), "dbias")
    close_to_scale(np.asarray(de), et.grad.numpy(), f"d{kind}")


def test_fused_entry_checks_its_operands():
    x = torch.zeros(2, 64, 4, 4)
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="pre_add"):
        k1._group_norm_cuda(x, w, b, 32, 1e-6, True, False, pre_add=torch.zeros(2, 32))
    with pytest.raises(ValueError, match="scale_shift"):
        k1._group_norm_cuda(x, w, b, 32, 1e-6, True, False, scale_shift=torch.zeros(2, 64))
    with pytest.raises(ValueError, match="float32"):
        k1._group_norm_cuda(x, w.double(), b, 32, 1e-6, True, False)


# ---------------------------------------------------------------------------
# the blocks that call the fused entry, at the tiny widths
# ---------------------------------------------------------------------------


def _randn(rng, *shape, s=1.0):
    return (s * rng.randn(*shape)).astype(np.float32)


def _lin(rng, cin, cout):
    return {"w": _randn(rng, cin, cout, s=cin ** -0.5), "b": _randn(rng, cout, s=0.1)}


def _conv(rng, cin, cout):
    return {"w": _randn(rng, 3, 3, cin, cout, s=(9 * cin) ** -0.5), "b": _randn(rng, cout, s=0.1)}


def _norm(rng, c):
    return {"scale": 1.0 + _randn(rng, c, s=0.1), "bias": _randn(rng, c, s=0.1)}


def _load(module, fill, p, sub=None):
    """Load the JAX-layout block `p` into `module` through the bridge's
    per-block helper `fill` (its keys under a throwaway prefix)."""
    out = {}
    fill(p, "m", out) if sub is None else fill(sub, p, "m", out)
    module.load_state_dict({k[2:]: v for k, v in _tensors(out).items()})
    return module.eval()


def _check_block(run_port, run_jax, x, emb, label):
    """The port's block without a gradient (the fused entry) and under
    autograd, output and the gradients w.r.t. x and the embedding, against
    the JAX block and its vjp."""
    rng = np.random.RandomState(21)
    want, vjp = jax.vjp(run_jax, jnp.asarray(x), jnp.asarray(emb))
    with torch.no_grad():
        fused = run_port(_nchw(x), torch.from_numpy(emb))
    close_to_scale(np.asarray(want), _nhwc(fused), f"{label}, fused entry")
    xt, et = _nchw(x).requires_grad_(), torch.from_numpy(emb).requires_grad_()
    out = run_port(xt, et)
    close_to_scale(np.asarray(want), _nhwc(out), f"{label}, autograd path")
    dy = rng.randn(*want.shape).astype(np.float32)
    dx, de = vjp(jnp.asarray(dy))
    out.backward(_nchw(dy))
    close_to_scale(np.asarray(dx), _nhwc(xt.grad), f"{label}, dx")
    close_to_scale(np.asarray(de), et.grad.numpy(), f"{label}, d emb")


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 96)])
def test_ddpmpp_resnet_block_matches_jax(cin, cout):
    rng = np.random.RandomState(3)
    temb_ch = 128
    p = {"norm1": _norm(rng, cin), "conv1": _conv(rng, cin, cout),
         "temb_proj": _lin(rng, temb_ch, cout), "norm2": _norm(rng, cout),
         "conv2": _conv(rng, cout, cout)}
    if cin != cout:
        p["nin_shortcut"] = _lin(rng, cin, cout)
    block = _load(tddpmpp.ResnetBlock(cin, cout, temb_ch), _resblock, p)
    jp = jax.tree.map(jnp.asarray, p)
    x, temb = _randn(rng, 2, 8, 8, cin, s=2.0), _randn(rng, 2, temb_ch)
    _check_block(lambda xx, t: block(xx, t), lambda xx, t: jddpmpp._resblock(jp, xx, t),
                 x, temb, f"DDPM++ ResnetBlock {cin}->{cout}")


@pytest.mark.parametrize("scale_shift", [True, False])
def test_openai_resblock_matches_jax(scale_shift):
    rng = np.random.RandomState(4)
    cin, cout, temb_ch = 64, 96, 128
    cfg = types.SimpleNamespace(use_scale_shift_norm=scale_shift, temb_ch=temb_ch)
    spec = {"kind": "res", "cin": cin, "cout": cout, "updown": None}
    p = {"in_norm": _norm(rng, cin), "in_conv": _conv(rng, cin, cout),
         "emb": _lin(rng, temb_ch, 2 * cout if scale_shift else cout),
         "out_norm": _norm(rng, cout), "out_conv": _conv(rng, cout, cout),
         "skip_mat": _lin(rng, cin, cout)}
    block = _load(toai.ResBlock(spec, cfg), _openai_layer, p, sub="res")
    jp = jax.tree.map(jnp.asarray, p)
    x, emb = _randn(rng, 2, 8, 8, cin, s=2.0), _randn(rng, 2, temb_ch)
    _check_block(lambda xx, t: block(xx, t), lambda xx, t: joai._resblock(jp, spec, cfg, xx, t),
                 x, emb, f"OpenAI ResBlock scale_shift={scale_shift}")


@pytest.mark.parametrize("flavor", ["ddpm", "openai"])
def test_delta_block_matches_jax(flavor):
    rng = np.random.RandomState(5)
    ch, temb_ch = 64, 128
    jb = jdelta.delta_block_init(hostrng.PRNGKey(7), ch, temb_ch, flavor=flavor)
    jb = {k: ({"scale": 1.0 + _randn(rng, ch, s=0.1), "bias": _randn(rng, ch, s=0.1)}
              if k.endswith("norm") or k == "norm2" else v) for k, v in jb.items()}
    block = tdelta._BLOCKS[flavor](ch, temb_ch)
    block.load_state_dict(delta_block_state_dict_from_jax(jb, flavor))
    jp = jax.tree.map(jnp.asarray, jb)
    x, temb = _randn(rng, 2, 4, 4, ch, s=2.0), _randn(rng, 2, temb_ch)
    _check_block(lambda xx, t: block.eval()(xx, t),
                 lambda xx, t: jdelta.delta_block_apply(jp, xx, t, flavor=flavor),
                 x, temb, f"{flavor} DeltaBlock")
