"""The OpenAI UNet's channels-last route (bf16, no gradient tracked, no
row-sharding group: activations NHWC in memory from `apply`'s input to its
outputs) and K1's channels-last plain version, on the CPU, on the tiny OpenAI
config of `test_torch_openai.py`.

The route's predicate (`openai_unet.channels_last_route`) is patched to take
float32 where the route is held to the JAX package at `close_to_scale` 1e-4;
in bf16 it is held to the NCHW route: the two land 0.66-1.5e-2 of scale
apart (measured over 3 seeds; a convolution sums in another order once its
operands are channels-last), and the route's distance from the f32 network
is 0.70-1.20x the NCHW route's; so each output must stay within 1.5x the
NCHW route's distance from the f32 network, and within 4e-2 of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from parity_utils import close_to_scale
from test_torch_openai import VARIANTS, _blocks, _cfgs, _inputs, _model, _rel_err, perturbed

from asyrp_official_torch.models import common as cm
from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models import openai_unet as toai
from asyrp_official_torch.ops import channels_last
from asyrp_official_torch.ops import groupnorm as k1
from asyrp_official_torch.parallel import spatial
from asyrp_official_torch.utils import profiling as prof
from asyrp_official_tpu.models import delta as jdelta
from asyrp_official_tpu.models import openai_unet as joai
from asyrp_official_tpu.utils import hostrng

_COEFF = np.array([1.0, 1.5], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def convs(monkeypatch):
    """Every `F.conv2d` call's (input channels-last, input NCHW-contiguous,
    weight channels-last-contiguous), in order."""
    seen = []
    conv = F.conv2d

    def spy(x, w, *args, **kw):
        seen.append((channels_last(x), x.is_contiguous(),
                     w.is_contiguous(memory_format=torch.channels_last)))
        return conv(x, w, *args, **kw)

    monkeypatch.setattr(F, "conv2d", spy)
    return seen


def _any_dtype_route(x):
    """The route's predicate with the dtype left out, so float32 takes it."""
    return not torch.is_grad_enabled() and spatial.active() is None


def _setup(variant="legacy_order", batch=2):
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    params = perturbed(joai.init(hostrng.PRNGKey(0), jcfg))
    jb, tb = _blocks(tcfg.bottleneck_ch, tcfg.temb_ch)
    x, t = _inputs(batch)
    return jcfg, tcfg, params, jb, tb, x, t


def _edit(tb):
    return tdelta.EditState(blocks=(tb,), hs_coeff=torch.from_numpy(_COEFF), flavor="openai")


def _counted(fn):
    """fn() under a torch profiler (the port's counters record only then):
    (its result, the counters)."""
    prof.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    counts = prof.counters()
    prof.reset()
    return out, counts


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("batch,decode_mode", [(2, "auto"), (2, "split"), (1, "auto")])
def test_channels_last_route_matches_jax_in_float32(monkeypatch, convs, variant, batch,
                                                    decode_mode):
    """The route in float32 (its predicate patched): the single decode and
    the edited dual decode, stacked and split, against the JAX package."""
    monkeypatch.setattr(toai, "channels_last_route", _any_dtype_route)
    jcfg, tcfg, params, jb, tb, x, t = _setup(variant, batch)
    model = _model(params, tcfg)
    with torch.no_grad():
        plain = model.apply(torch.from_numpy(x), torch.from_numpy(t))
        got = model.apply(torch.from_numpy(x), torch.from_numpy(t), edit=_edit(tb),
                          decode_mode=decode_mode)
    assert convs and all(c[0] for c in convs), "a convolution was handed an NCHW input"
    jp = jax.tree.map(jnp.asarray, params)
    jedit = jdelta.EditState(blocks=(jb,), hs_coeff=jnp.asarray(_COEFF), flavor="openai")
    want_plain = joai.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t))
    want = joai.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t), edit=jedit,
                      decode_mode=decode_mode)
    close_to_scale(np.asarray(want_plain[0]), plain[0].numpy(), "eps, single decode")
    close_to_scale(np.asarray(want_plain[3]), plain[3].numpy(), "middle_h")
    for w, g, name in zip(want, got, ("eps", "eps_mod", "delta_h", "middle_h")):
        close_to_scale(np.asarray(w), g.numpy(), name)
    assert float(got[0].std()) > 0.1, "eps is (near) zero: the comparison would prove nothing"
    assert float((got[1] - got[0]).abs().max()) > 1e-2 * float(got[0].abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_channels_last_route_matches_the_nchw_route_in_bf16(monkeypatch, seed):
    """bf16 activations over float32 weights cast at use (as served): the
    route against the NCHW route (predicate patched off) and both against
    the float32 network."""
    jcfg, tcfg, params, _, tb, _, t = _setup()
    x, _ = _inputs(2, seed=seed)
    model = _model(params, tcfg)
    xs, ts = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        f32 = model.apply(xs, ts, edit=_edit(tb))
        route = model.apply(xs.to(torch.bfloat16), ts, edit=_edit(tb))
        monkeypatch.setattr(toai, "channels_last_route", lambda x: False)
        nchw = model.apply(xs.to(torch.bfloat16), ts, edit=_edit(tb))
    for r, n, w, name in zip(route, nchw, f32, ("eps", "eps_mod", "delta_h", "middle_h")):
        assert r.dtype == torch.bfloat16 and r.shape == n.shape
        own = _rel_err(w.numpy(), n.float().numpy())
        assert _rel_err(w.numpy(), r.float().numpy()) <= 1.5 * own, (name, own)
        close_to_scale(n.float().numpy(), r.float().numpy(), f"bf16 {name}", bound=4e-2)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_channels_last_route_hands_every_conv_channels_last_and_counts_it(convs, variant):
    """bf16: every convolution's input is channels-last, every 3x3 filter
    reaches it channels-last from its one cast, and `channels_last_convs`
    reads the call count: the plain eval's, and two more in the edited
    eval (the DeltaBlock's 1x1 convolutions)."""
    _, tcfg, params, _, tb, x, t = _setup(variant)
    model = _model(params, tcfg)
    xs, ts = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(t)
    with torch.no_grad():
        _, plain = _counted(lambda: model.apply(xs, ts))
        n_plain = len(convs)
        _, edited = _counted(lambda: model.apply(xs, ts, edit=_edit(tb)))
    assert all(c[0] and c[2] for c in convs), "an NCHW input or filter reached a convolution"
    assert plain[prof.CHANNELS_LAST_CONVS] == n_plain > 0
    assert edited[prof.CHANNELS_LAST_CONVS] == len(convs) - n_plain == n_plain + 2
    # one cast per weight and bias at use: the DeltaBlock's two convolutions and its linear
    assert edited[prof.WEIGHT_CASTS] == plain[prof.WEIGHT_CASTS] + 6


def test_channels_last_route_outputs_leave_without_a_copy(monkeypatch):
    """Every output of `apply` on the route is contiguous NHWC, the same
    storage as the channels-last tensor it came from."""
    _, tcfg, params, _, tb, x, t = _setup()
    model = _model(params, tcfg)
    pairs = []
    nhwc = toai._nhwc

    def spy(a):
        out = nhwc(a)
        pairs.append((a, out))
        return out

    monkeypatch.setattr(toai, "_nhwc", spy)
    with torch.no_grad():
        outs = model.apply(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(t),
                           edit=_edit(tb))
    assert len(pairs) == 4
    for a, out in pairs:
        assert channels_last(a) and out.is_contiguous() and out.data_ptr() == a.data_ptr()
    assert [o.shape[-1] for o in outs] == [6, 6, tcfg.bottleneck_ch, tcfg.bottleneck_ch]


@pytest.mark.parametrize("case", ["float32", "bf16_with_grad"])
def test_other_routes_stay_nchw_and_count_nothing(convs, case):
    """float32 (cuDNN's f32 convolutions are NCHW-native) and a tracked
    gradient (K1's backward takes NCHW alone) keep today's NCHW ops."""
    _, tcfg, params, _, tb, x, t = _setup()
    model = _model(params, tcfg)
    xs = torch.from_numpy(x)
    if case == "float32":
        with torch.no_grad():
            _, counts = _counted(lambda: model.apply(xs, torch.from_numpy(t), edit=_edit(tb)))
    else:
        tb = tb.to(torch.bfloat16).requires_grad_(True)
        _, counts = _counted(lambda: model.apply(xs.to(torch.bfloat16), torch.from_numpy(t),
                                                 edit=_edit(tb), decode_mode="split"))
    assert convs and all(c[1] for c in convs), "a convolution was handed a non-NCHW input"
    assert counts.get(prof.CHANNELS_LAST_CONVS, 0) == 0


def test_upsample_nearest_2x_keeps_channels_last():
    x = torch.randn(2, 8, 5, 3).to(torch.bfloat16)
    want = cm.upsample_nearest_2x(x)
    got = cm.upsample_nearest_2x(x.contiguous(memory_format=torch.channels_last))
    assert want.is_contiguous() and channels_last(got)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_avg_pool_2x_keeps_channels_last(dtype):
    x = torch.randn(2, 8, 6, 4).to(dtype)
    want = cm.avg_pool_2x(x)
    got = cm.avg_pool_2x(x.contiguous(memory_format=torch.channels_last))
    assert want.is_contiguous() and channels_last(got)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:  # four f32 terms, perhaps summed in another order
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dim", [0, 1])
def test_cat_keeps_channels_last(dim):
    a, b = torch.randn(2, 8, 6, 4).to(torch.bfloat16), torch.randn(2, 8, 6, 4).to(torch.bfloat16)
    want = torch.cat([a, b], dim)
    got = cm.cat([t.contiguous(memory_format=torch.channels_last) for t in (a, b)], dim)
    assert channels_last(got) and torch.equal(got, want)
    assert cm.cat([a, b], dim).is_contiguous()  # NCHW tensors: torch.cat as it is


_EPILOGUES = ["none", "silu", "pre_add", "scale_shift", "scale_shift_silu", "stats"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", _EPILOGUES)
def test_group_norm_plain_on_channels_last_gives_the_nchw_bits(epilogue, dtype):
    """K1's plain version on a channels-last input: the NCHW result's bits,
    returned channels-last (the statistics too, with `stats`)."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 64, 6, 5, generator=g) * 2 + 0.5).to(dtype)
    w, b = 1 + 0.1 * torch.randn(64, generator=g), 0.1 * torch.randn(64, generator=g)
    kw = dict(eps=1e-5, silu=epilogue in ("silu", "scale_shift_silu"))
    if epilogue == "pre_add":
        kw["pre_add"] = torch.randn(2, 64, generator=g).to(dtype)
    elif epilogue.startswith("scale_shift"):
        kw["scale_shift"] = (0.1 * torch.randn(2, 128, generator=g)).to(dtype)
    xl = x.contiguous(memory_format=torch.channels_last)
    if epilogue == "stats":
        want = k1._plain_with_stats(x, w, b, 32, 1e-5, True)
        got = k1._plain_with_stats(xl, w, b, 32, 1e-5, True)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        want, got = want[0], got[0]
    else:
        want = k1.group_norm_plain(x, w, b, **kw)
        got = k1.group_norm_plain(xl, w, b, **kw)
        assert torch.equal(k1.group_norm(xl, w, b, **kw), got)  # the CPU entry
    assert want.is_contiguous() and channels_last(got) and got.dtype == dtype
    assert torch.equal(got, want)


def test_group_norm_kernel_checks_take_nchw_or_channels_last():
    """`_check_input`: a contiguous NCHW tensor always, a channels-last one
    where the caller takes it (the forward), anything else never."""
    w, b = torch.ones(64), torch.zeros(64)
    x = torch.randn(2, 64, 4, 4)
    xl = x.contiguous(memory_format=torch.channels_last)
    assert k1._check_input(x, w, b, 32) == (2, 64, 16)
    assert k1._check_input(xl, w, b, 32, nhwc=True) == (2, 64, 16)
    with pytest.raises(ValueError, match="contiguous NCHW tensor$"):
        k1._check_input(xl, w, b, 32)
    with pytest.raises(ValueError, match="or a channels-last one"):
        k1._check_input(x.transpose(2, 3), w, b, 32, nhwc=True)


def test_channels_last_convs_reader(monkeypatch):
    """`portbench/metrics/channels_last_convs_per_image.py`: the counter over
    the traced images; None without it (a program that has no such counter)
    and untraced."""
    from portbench import bench, harness
    from portbench.window import Window

    def outcome(traced=True):
        return harness.Outcome("bfloat16", "image", 1.0, Window(0.0, 1.0, [1.0], 16), None,
                               object() if traced else None, traced_requests=1, traced_work=16)

    path = bench.reader_path("channels_last_convs_per_image.tput")
    read = bench.load_module(path, "channels_last_convs_per_image").read
    monkeypatch.setattr(prof, "records", lambda: [prof.Span(prof.EVAL, {"edited": False}, 1.0)])
    monkeypatch.setattr(prof, "counters", lambda: {prof.CHANNELS_LAST_CONVS: 7574})
    assert read(outcome()) == pytest.approx(7574 / 16)
    assert read(outcome(traced=False)) is None
    monkeypatch.setattr(prof, "counters", lambda: {prof.WEIGHT_CASTS: 100})
    assert read(outcome()) is None
