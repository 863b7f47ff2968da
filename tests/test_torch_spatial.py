"""Spatial sharding in the port (`parallel/spatial.py` and the layers'
hooks) against the JAX package's GSPMD sharding.

The port's `make_invert` / `make_edit_generate` run on 2- and 4-rank gloo
groups, one image's rows per rank (--tp_spatial, 1 x S) and a 2 x 2 (data,
spatial) mesh of a batch of 4 (--dp 2 --sp 2), on the tiny DDPM++ config
of JAX `tests/test_spatial_parallel.py` and a tiny OpenAI config with
resblock up/down (4 heads of 16 at 16^2), perturbed weights. They are held
to JAX's `spatial_shard` / `batch_spatial_shard` runs on the conftest's
8-device virtual mesh, from the same numpy inputs and the weights carried
over by `compat/from_jax.py`, at 2e-4 of scale (JAX's own tolerance for
its sharded runs). On 4 ranks the port also runs what its own unsharded
run holds to JAX elsewhere: the norm-matched and the masked slerp of the
input mode (the cross-rank norms and dot products, the row-sliced Δh and
mask) and the OpenAI conv downsample (the stride-2 halo from above).

Also the plain versions of both new kernel entries: K1 across ranks (row
blocks' parts, Chan's combination, the normalize) against `group_norm` on
the whole tensor, and K2 with Tq != Tk (a row block's queries against the
whole image's keys) against `spatial_attention` on the whole tensor; and
the gradients of both on one rank (their cross-rank gradients:
`tests/test_torch_spatial_train.py`).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale
from torch_ranks import run_ranks

from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.ops import attention as k2, groupnorm as k1
from asyrp_official_torch.utils.tinyws import TINY_DDPMPP_CONFIG
from asyrp_official_tpu.core.schedule import make_schedule, uniform_seq
from asyrp_official_tpu.models import common as jcommon
from asyrp_official_tpu.models import delta as jdelta
from asyrp_official_tpu.parallel import mesh as jmesh
from asyrp_official_tpu.parallel.spatial import batch_spatial_shard, spatial_shard
from asyrp_official_tpu.pipelines import engine as jengine
from asyrp_official_tpu.runner import spec_from_config as j_spec_from_config
from asyrp_official_tpu.utils import hostrng

OPENAI_TINY = {
    "data": {"dataset": "CelebA_HQ", "category": "CUSTOM", "image_size": 32, "channels": 3},
    "model": {"family": "openai", "in_channels": 3, "out_ch": 6, "ch": 32, "ch_mult": [1, 2],
              "num_res_blocks": 1, "attn_resolutions": [16], "dropout": 0.0,
              "var_type": "fixedsmall", "learn_sigma": True, "num_head_channels": 16,
              "use_scale_shift_norm": True, "resblock_updown": True, "class_cond": False},
    "diffusion": {"beta_schedule": "linear", "beta_start": 0.0001, "beta_end": 0.02,
                  "num_diffusion_timesteps": 1000},
}
CASES = {"ddpmpp": TINY_DDPMPP_CONFIG, "openai": OPENAI_TINY}
STEPS, T_EDIT, TOL = 4, 500, 2e-4

WORKER = r'''
import copy, json
import numpy as np
import torch
from asyrp_official_torch.core.schedule import make_schedule, uniform_seq
from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.parallel import mesh as pmesh, spatial
from asyrp_official_torch.pipelines import engine

cases, root, out = json.loads(ARGS[0]), ARGS[1], ARGS[2]
steps, t_edit = int(ARGS[3]), int(ARGS[4])
sched, seq = make_schedule(), uniform_seq(steps, 999)
layouts = [(1, WORLD)] + ([(2, 2)] if WORLD == 4 else [])
res = {}


def load(name, config):
    spec = spec_from_config(config)
    model = spec.build()
    sd = torch.load(f"{root}/{name}.pt")
    model.load_state_dict(sd["model"])
    block = tdelta._BLOCKS[spec.delta_flavor](spec.bottleneck_ch, spec.temb_ch)
    block.load_state_dict(sd["block"])
    return spec, model.eval(), block.eval()


for name, config in cases.items():
    spec, model, block = load(name, config)
    edit = tdelta.EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0]),
                            flavor=spec.delta_flavor)
    inp = np.load(f"{root}/{name}_in.npz")
    inv = engine.make_invert(spec, sched, seq)
    gen = engine.make_edit_generate(spec, sched, seq, t_edit=t_edit)
    for data, sp in layouts:
        m = pmesh.make_mesh(data, sp)
        b = 1 if data == 1 else 4
        with spatial.sharded(m.spatial_info()):
            lat = inv(model, m.put(inp[f"x0_{b}"]))[0]
            edited = gen(model, edit, m.put(inp[f"xl_{b}"]))[0]
        res[f"{name}_{data}x{sp}_inv"] = m.fetch(lat)
        res[f"{name}_{data}x{sp}_edit"] = m.fetch(edited)

if WORLD == 4:  # the port against its own unsharded run
    m = pmesh.make_mesh(1, 4)
    spec, model, _ = load("ddpmpp", cases["ddpmpp"])
    inp = np.load(f"{root}/ddpmpp_in.npz")
    rows = torch.from_numpy(np.random.RandomState(3).randn(1, spec.bottleneck_ch,
                            spec.bottleneck_hw, spec.bottleneck_hw).astype(np.float32))
    gen = engine.make_edit_generate(spec, sched, seq, t_edit=t_edit)
    for mask in (False, True):
        edit = tdelta.EditState(mode="input", delta_rows=rows, hs_coeff=torch.tensor([0.6, 1.0]),
                                input_style="slerp", use_mask=mask)
        with spatial.sharded(m.spatial_info()):
            x = gen(model, edit, m.put(inp["xl_1"]))[0]
        res[f"slerp{int(mask)}"] = m.fetch(x)
        res[f"slerp{int(mask)}_ref"] = gen(model, edit, torch.from_numpy(inp["xl_1"]))[0].numpy()
    conv = copy.deepcopy(cases["openai"])
    conv["model"]["resblock_updown"] = False
    spec = spec_from_config(conv)
    torch.manual_seed(0)
    model = spec.build().eval()
    inv = engine.make_invert(spec, sched, seq)
    with spatial.sharded(m.spatial_info()):
        res["conv_down"] = m.fetch(inv(model, m.put(inp["x0_1"]))[0])
    res["conv_down_ref"] = inv(model, torch.from_numpy(inp["x0_1"]))[0].numpy()

if RANK == 0:
    np.savez(out, **res)
'''


def _perturbed(tree, rng):
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.randn(*np.shape(a)))
                        .astype(np.float32), tree)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The weights, the inputs and JAX's sharded runs: 1 image over the 8
    devices' rows, and 4 images on a 4 x 2 (data, spatial) mesh."""
    root = tmp_path_factory.mktemp("spatial")
    sched, seq = make_schedule(), uniform_seq(STEPS, 999)
    m8, m42 = jmesh.make_mesh(), jmesh.make_mesh(8, spatial=2)
    assert m8.devices.size == 8, "the conftest's 8-device virtual mesh"
    refs = {}
    for i, (name, config) in enumerate(CASES.items()):
        jspec, pspec = j_spec_from_config(config), spec_from_config(config)
        rng = np.random.RandomState(10 + i)
        params = _perturbed(jspec.init(hostrng.PRNGKey(0)), rng)
        block = _perturbed(jdelta.delta_block_init(hostrng.PRNGKey(1), pspec.bottleneck_ch,
                                                   pspec.temb_ch, flavor=pspec.delta_flavor), rng)
        tblock = tdelta.delta_block_from_tree(block, pspec.bottleneck_ch, pspec.temb_ch,
                                              flavor=pspec.delta_flavor)
        torch.save({"model": pspec.state_dict_from_jax(params), "block": tblock.state_dict()},
                   root / f"{name}.pt")
        inp = {f"{k}_{b}": rng.randn(b, 32, 32, 3).astype(np.float32)
               for k in ("x0", "xl") for b in (1, 4)}
        np.savez(root / f"{name}_in.npz", **inp)
        edit = jdelta.EditState(blocks=(block,), hs_coeff=jnp.array([1.0, 1.0]),
                                flavor=pspec.delta_flavor)
        inv = jengine.make_invert(jspec, sched, seq)
        gen = jengine.make_edit_generate(jspec, sched, seq, t_edit=T_EDIT)
        for mesh, b, put in ((m8, 1, spatial_shard), (m42, 4, batch_spatial_shard)):
            p, e = jmesh.replicate(mesh, params), jmesh.replicate(mesh, edit)
            refs[f"{name}_{b}_inv"] = np.asarray(inv(p, put(mesh, inp[f"x0_{b}"]))[0])
            refs[f"{name}_{b}_edit"] = np.asarray(
                gen(p, e, put(mesh, inp[f"xl_{b}"]), jax.random.PRNGKey(0))[0])
    return root, refs


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """{world: the port's outputs} on 2 and 4 gloo ranks, and JAX's."""
    root, refs = jax_runs
    outs = {}
    for world in (2, 4):
        out = str(root / f"port_{world}.npz")
        run_ranks(WORKER, world, [json.dumps(CASES), str(root), out, STEPS, T_EDIT], timeout=180)
        outs[world] = dict(np.load(out))
    return outs, refs


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("what", ["inv", "edit"])
def test_sharded_engines_match_the_jax_sharded_engines(port_runs, world, name, what):
    outs, refs = port_runs
    got = outs[world]
    close_to_scale(got[f"{name}_1x{world}_{what}"], refs[f"{name}_1_{what}"],
                   f"{name} {what}, 1 x {world}", bound=TOL)
    if world == 4:
        close_to_scale(got[f"{name}_2x2_{what}"], refs[f"{name}_4_{what}"],
                       f"{name} {what}, 2 x 2, batch 4", bound=TOL)


@pytest.mark.parametrize("key", ["slerp0", "slerp1", "conv_down"])
def test_sharded_input_edits_and_conv_downsample_match_the_unsharded_port(port_runs, key):
    got = port_runs[0][4]
    close_to_scale(got[key], got[f"{key}_ref"], key, bound=TOL)


def _row_blocks(t, dim, s):
    return t.chunk(s, dim=dim)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("fused", [None, "pre_add", "scale_shift"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_across_plain_matches_the_whole_tensor(s, fused, dtype):
    """K1 across ranks, plain: the parts of S row blocks, gathered and
    combined, then each block normalized, equal `group_norm` on the whole
    tensor: the JAX function (f32, unfused; 1e-5 of scale) and the port's
    plain fused version (1e-5 f32; bf16: 1e-2 of scale, a few ulps where the
    statistics round otherwise)."""
    rng = np.random.RandomState(s)
    x = torch.from_numpy(rng.randn(2, 64, 16, 8).astype(np.float32) * 3 + 5).to(dtype)
    w = torch.from_numpy(rng.rand(64).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.randn(64).astype(np.float32))
    kw = {}
    if fused == "pre_add":
        kw["pre_add"] = torch.from_numpy(rng.randn(2, 64).astype(np.float32)).to(dtype)
    elif fused == "scale_shift":
        kw["scale_shift"] = torch.from_numpy(rng.randn(2, 128).astype(np.float32)).to(dtype)
    blocks = _row_blocks(x, 2, s)
    parts = torch.stack([k1.group_norm_part_stats_plain(xb, groups=32, pre_add=kw.get("pre_add"))
                         for xb in blocks])
    mean, rstd = k1.combine_group_stats(parts, 1e-6)
    got = torch.cat([k1.group_norm_apply_plain(xb, w, b, mean, rstd, silu=True, **kw)
                     for xb in blocks], dim=2)
    want = k1.group_norm_plain(x, w, b, groups=32, eps=1e-6, silu=True, **kw)
    close_to_scale(got.float().numpy(), want.float().numpy(), "K1 across vs whole",
                   bound=1e-5 if dtype == torch.float32 else 1e-2)
    if fused is None and dtype == torch.float32:
        got = torch.cat([k1.group_norm_apply_plain(xb, w, b, mean, rstd) for xb in blocks], dim=2)
        ref = jcommon.group_norm({"scale": w.numpy(), "bias": b.numpy()},
                                 jnp.asarray(x.permute(0, 2, 3, 1).numpy()), groups=32, eps=1e-6)
        close_to_scale(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), "K1 across vs JAX",
                       bound=1e-5)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("heads, legacy", [(1, False), (4, True)])
def test_attention_kv_plain_matches_the_whole_tensor(s, heads, legacy):
    """K2 with Tq != Tk, plain: each row block's queries against the whole
    image's keys and values, concatenated, equal JAX `spatial_attention` on
    the whole tensor (1e-5 of scale)."""
    rng = np.random.RandomState(heads)
    q, k, v = (torch.from_numpy(rng.randn(2, 64, 128).astype(np.float32)) for _ in range(3))
    got = torch.cat([k2.attention(qb, k, v, num_heads=heads, legacy_scale=legacy)
                     for qb in _row_blocks(q, 1, s)], dim=1)
    want = jcommon.spatial_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                     num_heads=heads, legacy_scale=legacy)
    close_to_scale(got.numpy(), np.asarray(want), "K2 Tq != Tk vs JAX", bound=1e-5)
    o, lse = k2._plain_with_lse(q[:, :64 // s], k, v, heads, legacy)
    assert o.shape == (2, 64 // s, 128) and lse.shape == (2, heads * 64 // s)


def test_kv_entry_refuses_autograd_and_mismatched_shapes():
    """The kv entry still refuses k and v of different lengths; under
    autograd (spatial training) it and K1 across ranks differentiate: on one
    rank (the gather a stack of the one part, the reduce the identity) their
    gradients equal autograd of the plain whole-tensor functions (1e-5 of
    scale). `tests/test_torch_spatial_train.py` runs them on 2 and 4 ranks."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, 16, 32).astype(np.float32)).requires_grad_(True)
    k, v = (torch.from_numpy(rng.randn(1, 64, 32).astype(np.float32)).requires_grad_(True)
            for _ in range(2))
    with pytest.raises(ValueError, match="Tk"):
        k2._check_inputs(q.detach(), k.detach(), torch.randn(1, 32, 32), 1)
    cot = torch.from_numpy(rng.randn(1, 16, 32).astype(np.float32))
    got = torch.autograd.grad((k2.attention(q, k, v) * cot).sum(), (q, k, v))
    want = torch.autograd.grad((k2.attention_plain(q, k, v) * cot).sum(), (q, k, v))
    for g, w_, n in zip(got, want, "qkv"):
        close_to_scale(w_.numpy(), g.numpy(), f"K2 Tq != Tk d{n}", bound=1e-5)
    x = torch.from_numpy(rng.randn(1, 64, 4, 4).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.rand(64).astype(np.float32) + 0.5).requires_grad_(True)
    b = torch.from_numpy(rng.randn(64).astype(np.float32)).requires_grad_(True)
    cot = torch.from_numpy(rng.randn(1, 64, 4, 4).astype(np.float32))
    with pytest.raises(ValueError, match="reduce"):
        k1.group_norm_across(x, w, b, lambda p: p[None])
    y = k1.group_norm_across(x, w, b, lambda p: p[None], reduce=lambda t: t, silu=True)
    got = torch.autograd.grad((y * cot).sum(), (x, w, b))
    want = torch.autograd.grad((k1.group_norm_plain(x, w, b, silu=True) * cot).sum(), (x, w, b))
    for g, w_, n in zip(got, want, ("x", "weight", "bias")):
        close_to_scale(w_.numpy(), g.numpy(), f"K1 across d{n}", bound=1e-5)
