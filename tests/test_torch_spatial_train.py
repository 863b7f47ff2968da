"""Spatial training in the port (`parallel/spatial.py`'s three rules) against
whole-tensor gradients and the JAX package's GSPMD-sharded training step.

Everything sharded runs on 2- and 4-rank gloo groups (`tests/torch_ranks.py`),
each rank on its rows of every activation, on the CPU, where each kernel
wrapper takes its plain version:

  * K1-bwd across ranks (`gn_bwd_part`'s and `gn_bwd_apply`'s plain
    versions, inside `ops/groupnorm._GroupNormAcross`): the gradients of x,
    the weight, the bias, the pre-add and the FiLM operand, with and without
    SiLU, against autograd of `group_norm_plain` on the whole tensor;
  * K2-bwd with Tq != Tk through the adjoint of the K/V `gather`, one head
    and four heads (legacy scale), against `jax.vjp` of JAX
    `spatial_attention` on the whole tensor;
  * the differentiable halos (the 3x3 convolution, the OpenAI stride-2 and
    the DDPM++ downsample convolutions) and cross-rank sums (the slerp)
    against the same layers unsharded;
  * `pipelines/precompute.precompute_with_h` on row blocks against the
    unsharded call: the latents and the h trajectory gathered whole, the
    cache (read by either package) written once, whole;
  * one edited timestep's Δ update (SGD, so lr times the gradient) of
    `pipelines/train.make_train_step` with the L1 term and a tiny CLIP
    directional term, on the DDPM++ tiny config (a DeltaBlock; the Δh rows)
    over 1 x S ranks and on the tiny OpenAI config over a 2 x 2 (data,
    spatial) mesh, against JAX `make_train_step` on `spatial_shard` /
    `batch_spatial_shard` inputs on the conftest's virtual mesh, from the
    same numpy inputs and bridged weights.

Tolerances: the whole-tensor comparisons 2e-5 of scale (f32; the sharded
sums add in another order), the JAX comparisons 2e-4 of scale (JAX's bound
for its sharded runs). The Δ comparison catches a broken rule (mutation
checks, made on a copy of the port): with the CLIP term computed whole on
every rank and not weighted 1/S (rule 2), the DeltaBlock's update lands
8.9e-3 of scale off on 2 ranks and 2.7e-2 on 4 (the rows' 2.0e-2 and
6.0e-2, the logged loss 2.2e-2 and 6.5e-2); with the gradients not summed
over the spatial ranks (rule 3), 0.5 to 1.0 of scale off.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale
from torch_ranks import run_ranks

from asyrp_official_torch.losses import clip_model as pm
from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models import common as cm
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.ops import groupnorm as k1
from asyrp_official_torch.utils.tinyws import TINY_DDPMPP_CONFIG
from asyrp_official_tpu.core.schedule import make_schedule, train_seq
from asyrp_official_tpu.losses import clip_loss as jl, clip_model as jm, tokenizer as jtok
from asyrp_official_tpu.models import common as jcommon
from asyrp_official_tpu.models import delta as jdelta
from asyrp_official_tpu.parallel import mesh as jmesh
from asyrp_official_tpu.parallel.spatial import batch_spatial_shard, spatial_shard
from asyrp_official_tpu.pipelines import train as jtr
from asyrp_official_tpu.runner import spec_from_config as j_spec_from_config
from asyrp_official_tpu.utils import hostrng

from test_torch_spatial import OPENAI_TINY

CLIP_CFG = pm.CLIPConfig(embed_dim=32, image_resolution=16, vision_layers=1, vision_width=64,
                         vision_patch_size=8, context_length=16, transformer_width=64,
                         transformer_heads=1, transformer_layers=1)
T_EDIT, LR = 500, 0.5
SEQ = train_seq(2, 999, T_EDIT)[0]  # [999]: one edited timestep
WHOLE_TOL, JAX_TOL = 2e-5, 2e-4
ID_W = 2.0  # --id_loss_w
GN_CASES = [(silu, fused) for silu in (False, True) for fused in (None, "pre_add", "scale_shift")]
ATTN_CASES = [(1, False), (4, True)]
CONV_CASES = ["conv3x3", "conv_stride2", "down_pad"]
# (name, config, train target, data ways): the Δ-training cases
TRAIN_CASES = [("ddpm_blocks", "ddpmpp", "blocks", 1), ("ddpm_rows", "ddpmpp", "rows", 1),
               ("openai_2x2", "openai", "blocks", 2)]

WORKER = r'''
import json
import numpy as np
import torch
import torch.nn.functional as F
from asyrp_official_torch.core.schedule import make_schedule
from asyrp_official_torch.losses import clip_loss as pl, clip_model as pm, tokenizer as ptok
from asyrp_official_torch.models import common as cm, delta as tdelta
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.ops import attention as k2, groupnorm as k1
from asyrp_official_torch.parallel import mesh as pmesh, spatial
from asyrp_official_torch.pipelines import train as ttr

root, out = ARGS[0], ARGS[1]
meta = json.loads(open(f"{root}/meta.json").read())
inp = dict(np.load(f"{root}/inputs.npz"))
res = {}
m = pmesh.make_mesh(1, WORLD)
sg = m.spatial_info()


def leaf(a):
    return torch.from_numpy(np.asarray(a)).requires_grad_(True)


def rows(a, dim):
    return spatial.local_rows(torch.from_numpy(np.asarray(a)), dim, sg)


def whole(g, dim):  # a local gradient's rows from every rank, in rank order
    return spatial.gather(g, dim, sg).numpy()


def summed(g):  # a replicated operand's gradient: the ranks' parts summed (rule 3)
    return spatial.all_reduce_sum(g, sg).numpy()


# K1-bwd across ranks
for silu, fused in meta["gn_cases"]:
    tag = f"gn_{int(silu)}_{fused}"
    x = rows(inp["gn_x"], 2).requires_grad_(True)
    w, b = leaf(inp["gn_w"]), leaf(inp["gn_b"])
    kw = {}
    if fused:
        kw[fused] = leaf(inp[f"gn_{fused}"])
    with spatial.sharded(sg):
        y = k1.group_norm_across(
            x, w, b, lambda p: spatial.all_gather_slots(p, sg.group, sg.size),
            reduce=lambda s: spatial.all_reduce_sum(s, sg), groups=32, eps=1e-6, silu=silu,
            **kw)
        (y * rows(inp["gn_cot"], 2)).sum().backward()
    res[f"{tag}_dx"] = whole(x.grad, 2)
    res[f"{tag}_dw"], res[f"{tag}_db"] = summed(w.grad), summed(b.grad)
    if fused:
        res[f"{tag}_d{fused}"] = summed(kw[fused].grad)

# K2-bwd with Tq != Tk through the adjoint gather
for heads, legacy in meta["attn_cases"]:
    tag = f"attn_{heads}"
    q, k, v = (rows(inp[f"attn_{n}"], 1).requires_grad_(True) for n in "qkv")
    with spatial.sharded(sg):
        o = k2.attention(q, spatial.gather(k, 1, sg), spatial.gather(v, 1, sg), num_heads=heads,
                         legacy_scale=legacy)
        (o * rows(inp["attn_cot"], 1)).sum().backward()
    for n, t in zip("qkv", (q, k, v)):
        res[f"{tag}_d{n}"] = whole(t.grad, 1)

# the halos against the unsharded layers
for case in meta["conv_cases"]:
    conv = torch.nn.Conv2d(8, 8, 3)
    conv.weight.data = torch.from_numpy(inp["conv_w"])
    conv.bias.data = torch.from_numpy(inp["conv_b"])
    fn = {"conv3x3": lambda t: cm.conv2d(conv, t), "conv_stride2": lambda t: cm.conv2d(conv, t, stride=2),
          "down_pad": lambda t: cm.downsample_pad_conv(conv, t)}[case]
    x = rows(inp["conv_x"], 2).requires_grad_(True)
    with spatial.sharded(sg):
        y = fn(x)
        (y * spatial.local_rows(torch.from_numpy(inp[f"{case}_cot"]), 2, sg)).sum().backward()
    res[f"{case}_dx"] = whole(x.grad, 2)
    res[f"{case}_dw"], res[f"{case}_db"] = summed(conv.weight.grad), summed(conv.bias.grad)

# the slerp's cross-rank sums
v0, v1 = (rows(inp[f"slerp_{n}"], 2).requires_grad_(True) for n in ("v0", "v1"))
with spatial.sharded(sg):
    y = tdelta.slerp(0.3, v0, v1)
    (y * rows(inp["slerp_cot"], 2)).sum().backward()
res["slerp_dv0"], res["slerp_dv1"] = whole(v0.grad, 2), whole(v1.grad, 2)

# the training loss with the ArcFace ID term (the runner's --id_loss_w
# closure) on row blocks: the ID term on the gathered images, weighted 1/S
from asyrp_official_torch.losses.id_loss import IRSE50
torch.manual_seed(0)
id_net = IRSE50()
x0, x0_t, x0_t_origin = (rows(inp[f"id_{n}"], 1) for n in ("x0", "x0_t", "x0_t_origin"))
x0_t.requires_grad_(True)
with spatial.sharded(sg):
    loss = ttr.default_loss(x0_t, x0_t_origin, x0, cosine=0.9, extra=lambda a, b, c: (
        meta["id_w"] * id_net.id_loss(b.permute(0, 3, 1, 2), c.permute(0, 3, 1, 2)).mean()))
    loss.backward()
res["id_loss"], res["id_dx0_t"] = summed(loss.detach()), whole(x0_t.grad, 1)

# one edited timestep of make_train_step
clip = pm.CLIP(pm.CLIPConfig(**meta["clip_cfg"]), seed=1).eval().requires_grad_(False)
ctx = pl.CLIPContext(clip, pm.CLIPConfig(**meta["clip_cfg"]), ptok.HashTokenizer())
for name, config, target, data in meta["train_cases"]:
    if WORLD // data < 2:  # a 2 x 2 mesh needs 4 ranks
        continue
    mm = m if data == 1 else pmesh.make_mesh(data, WORLD // data)
    spec = spec_from_config(meta["configs"][config])
    model = spec.build()
    model.load_state_dict(torch.load(f"{root}/{config}.pt"))
    model.eval().requires_grad_(False)
    if target == "blocks":
        block = tdelta._BLOCKS[spec.delta_flavor](spec.bottleneck_ch, spec.temb_ch)
        block.load_state_dict(torch.load(f"{root}/{config}_block.pt"))
        edit = tdelta.EditState(blocks=(block.train(),), hs_coeff=torch.tensor([1.0, 1.0]),
                                flavor=spec.delta_flavor)
        params = list(block.parameters())
    else:
        rows_leaf = tdelta.rows_to_nchw(inp["rows"]).requires_grad_(True)
        edit = tdelta.EditState(mode="input", delta_rows=rows_leaf,
                                hs_coeff=torch.tensor([1.0, 1.0]), input_style="add",
                                times=tuple(meta["seq"]))
        params = [rows_leaf]
    extra = pl.train_clip_term(ctx, "face", "smiling face", 1.0, batch_mean=mm.batch_mean)
    step = ttr.make_train_step(
        spec, make_schedule(), meta["seq"], t_edit=meta["t_edit"], train_target=target,
        loss_fn=lambda a, b, c: ttr.default_loss(a, b, c, cosine=0.9, extra=extra),
        sync_grads=mm.sync_grads)
    opt = ttr.make_optimizer(params, meta["lr"])
    with spatial.sharded(mm.spatial_info()):
        metrics = step(model, edit, opt, mm.put(inp[f"{config}_xl"]), mm.put(inp[f"{config}_x0"]),
                       meta["lr"])
    # the one-process loss: the shares summed by the step, then averaged
    # over the data axis as the runner logs it
    res[f"{name}_loss"] = np.array([mm.mean_over_data(float(v))
                                    for v in metrics["loss_per_step"]])
    for i, p in enumerate(params):
        res[f"{name}_p{i}"] = p.detach().numpy().copy()

# precompute_with_h on row blocks: the trajectory gathered whole, the cache
# written once
from asyrp_official_torch.pipelines import precompute as pc
spec = spec_from_config(meta["configs"]["ddpmpp"])
model = spec.build()
model.load_state_dict(torch.load(f"{root}/ddpmpp.pt"))
with spatial.sharded(sg):
    pre = pc.precompute_with_h(spec, model.eval(), make_schedule(), inp["ddpmpp_x0"],
                               n_inv_step=4, device=torch.device("cpu"), cache_key="h",
                               cache_dir=f"{root}/cache_{WORLD}", mesh=m)
res["pre_x_lat"], res["pre_h_traj"] = pre["x_lat"], pre["h_traj"]

if RANK == 0:
    np.savez(out, **res)
'''


def _perturbed(tree, rng):
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.randn(*np.shape(a)))
                        .astype(np.float32), tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs and weights, written for the ranks, and the JAX side."""
    root = tmp_path_factory.mktemp("spatial_train")
    rng = np.random.RandomState(0)
    inp = {"gn_x": rng.randn(2, 64, 16, 8).astype(np.float32) * 3 + 2,
           "gn_w": (rng.rand(64) + 0.5).astype(np.float32),
           "gn_b": rng.randn(64).astype(np.float32),
           "gn_pre_add": rng.randn(2, 64).astype(np.float32),
           "gn_scale_shift": (0.5 * rng.randn(2, 128)).astype(np.float32),
           "gn_cot": rng.randn(2, 64, 16, 8).astype(np.float32),
           "attn_cot": rng.randn(2, 64, 128).astype(np.float32),
           "conv_x": rng.randn(1, 8, 16, 8).astype(np.float32),
           "conv_w": (0.2 * rng.randn(8, 8, 3, 3)).astype(np.float32),
           "conv_b": rng.randn(8).astype(np.float32),
           "slerp_v0": rng.randn(2, 8, 8, 8).astype(np.float32),
           "slerp_v1": rng.randn(2, 8, 8, 8).astype(np.float32),
           "slerp_cot": rng.randn(2, 8, 8, 8).astype(np.float32)}
    for n in "qkv":
        inp[f"attn_{n}"] = rng.randn(2, 64, 128).astype(np.float32)
    for case, h in (("conv3x3", 16), ("conv_stride2", 8), ("down_pad", 8)):
        inp[f"{case}_cot"] = rng.randn(1, 8, h, 8 if case == "conv3x3" else 4).astype(np.float32)

    configs = {"ddpmpp": TINY_DDPMPP_CONFIG, "openai": OPENAI_TINY}
    jax_side = {"configs": {}}
    for i, (name, config) in enumerate(configs.items()):
        jspec, pspec = j_spec_from_config(config), spec_from_config(config)
        wrng = np.random.RandomState(20 + i)
        params = _perturbed(jspec.init(hostrng.PRNGKey(0)), wrng)
        block = _perturbed(jdelta.delta_block_init(hostrng.PRNGKey(1), pspec.bottleneck_ch,
                                                   pspec.temb_ch, flavor=pspec.delta_flavor), wrng)
        tblock = tdelta.delta_block_from_tree(block, pspec.bottleneck_ch, pspec.temb_ch,
                                              flavor=pspec.delta_flavor)
        torch.save(pspec.state_dict_from_jax(params), root / f"{name}.pt")
        torch.save(tblock.state_dict(), root / f"{name}_block.pt")
        b = 2 if name == "openai" else 1
        inp[f"{name}_xl"] = wrng.randn(b, 32, 32, 3).astype(np.float32)
        inp[f"{name}_x0"] = wrng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
        jax_side["configs"][name] = (jspec, pspec, params, block, tblock)
    spec = spec_from_config(TINY_DDPMPP_CONFIG)
    inp["rows"] = (0.2 * rng.randn(len(SEQ), spec.bottleneck_hw, spec.bottleneck_hw,
                                   spec.bottleneck_ch)).astype(np.float32)
    for n in ("x0", "x0_t", "x0_t_origin"):  # 256²: the ID net's face crop is whole
        inp[f"id_{n}"] = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    np.savez(root / "inputs.npz", **inp)
    meta = {"gn_cases": GN_CASES, "attn_cases": ATTN_CASES, "conv_cases": CONV_CASES,
            "train_cases": TRAIN_CASES, "configs": configs, "seq": SEQ, "t_edit": T_EDIT,
            "lr": LR, "id_w": ID_W, "clip_cfg": CLIP_CFG._asdict() if hasattr(CLIP_CFG, "_asdict")
            else CLIP_CFG.__dict__}
    (root / "meta.json").write_text(json.dumps(meta))
    return root, inp, jax_side


@pytest.fixture(scope="module")
def port_runs(setup):
    root = setup[0]
    outs = {}
    for world in (2, 4):
        out = str(root / f"port_{world}.npz")
        run_ranks(WORKER, world, [str(root), out], timeout=300)
        outs[world] = dict(np.load(out))
    return outs


def _t(a):
    return torch.from_numpy(np.asarray(a)).requires_grad_(True)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("silu, fused", GN_CASES)
def test_k1_bwd_across_ranks_matches_the_whole_tensor(setup, port_runs, world, silu, fused):
    """Every gradient of K1 across ranks (x; the weight, bias and fused
    operand as the ranks' partials summed) equals autograd of the plain
    GroupNorm on the whole tensor."""
    inp, got = setup[1], port_runs[world]
    x, w, b = _t(inp["gn_x"]), _t(inp["gn_w"]), _t(inp["gn_b"])
    kw = {fused: _t(inp[f"gn_{fused}"])} if fused else {}
    y = k1.group_norm_plain(x, w, b, groups=32, eps=1e-6, silu=silu, **kw)
    (y * torch.from_numpy(inp["gn_cot"])).sum().backward()
    tag = f"gn_{int(silu)}_{fused}"
    want = {"dx": x.grad, "dw": w.grad, "db": b.grad, **({f"d{fused}": kw[fused].grad}
                                                         if fused else {})}
    for k, v in want.items():
        close_to_scale(v.numpy(), got[f"{tag}_{k}"], f"{tag} {k}, {world} ranks",
                       bound=WHOLE_TOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("heads, legacy", ATTN_CASES)
def test_k2_bwd_tq_tk_through_the_adjoint_gather_matches_jax(setup, port_runs, world, heads,
                                                             legacy):
    """A rank's queries against the gathered keys and values: dq of its
    rows, and dk / dv summed over every rank's queries by the gather's
    adjoint, equal JAX's vjp of `spatial_attention` on the whole tensor."""
    inp, got = setup[1], port_runs[world]
    q, k, v = (jnp.asarray(inp[f"attn_{n}"]) for n in "qkv")
    _, vjp = jax.vjp(lambda a, b_, c: jcommon.spatial_attention(
        a, b_, c, num_heads=heads, legacy_scale=legacy), q, k, v)
    for n, g in zip("qkv", vjp(jnp.asarray(inp["attn_cot"]))):
        close_to_scale(np.asarray(g), got[f"attn_{heads}_d{n}"],
                       f"attention d{n}, {heads} head(s), {world} ranks", bound=WHOLE_TOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CONV_CASES + ["slerp"])
def test_halos_and_sums_match_the_unsharded_layers(setup, port_runs, world, case):
    """The halos' adjoint (each halo row's gradient added to its owner's
    edge row; the edge ranks' zero halos included) and the all-reduce's:
    the unsharded layers' gradients."""
    inp, got = setup[1], port_runs[world]
    if case == "slerp":
        v0, v1 = _t(inp["slerp_v0"]), _t(inp["slerp_v1"])
        (tdelta.slerp(0.3, v0, v1) * torch.from_numpy(inp["slerp_cot"])).sum().backward()
        want = {"dv0": v0.grad, "dv1": v1.grad}
    else:
        conv = torch.nn.Conv2d(8, 8, 3)
        conv.weight.data = torch.from_numpy(inp["conv_w"])
        conv.bias.data = torch.from_numpy(inp["conv_b"])
        x = _t(inp["conv_x"])
        y = {"conv3x3": lambda: cm.conv2d(conv, x),
             "conv_stride2": lambda: cm.conv2d(conv, x, stride=2),
             "down_pad": lambda: cm.downsample_pad_conv(conv, x)}[case]()
        (y * torch.from_numpy(inp[f"{case}_cot"])).sum().backward()
        want = {"dx": x.grad, "dw": conv.weight.grad, "db": conv.bias.grad}
    for k, v in want.items():
        close_to_scale(v.numpy(), got[f"{case}_{k}"], f"{case} {k}, {world} ranks",
                       bound=WHOLE_TOL)


def _jax_train(setup, config, target, data):
    """JAX `make_train_step` on the conftest's virtual mesh: 4 devices, the
    rows split 4 ways (1 x 4) or a 2 x 2 (data, spatial) mesh."""
    inp, jax_side = setup[1], setup[2]
    jspec, pspec, params, block, _ = jax_side["configs"][config]
    mesh = jmesh.make_mesh(4, spatial=2) if data == 2 else jmesh.make_mesh(4)
    put = batch_spatial_shard if data == 2 else spatial_shard
    clip = pm.CLIP(CLIP_CFG, seed=1)
    jclip, jcfg = jm.params_from_torch({k: v.numpy() for k, v in clip.state_dict().items()})
    extra = jl.train_clip_term(jl.CLIPContext(jclip, jcfg, jtok.HashTokenizer()), "face",
                               "smiling face", 1.0)
    opt = jtr.make_optimizer(LR)
    step = jtr.make_train_step(
        jspec, make_schedule(), SEQ, t_edit=T_EDIT, optimizer=opt, train_target=target,
        loss_fn=lambda a, b, c: jtr.default_loss(a, b, c, cosine=0.9, extra=extra))
    if target == "blocks":
        edit = jdelta.EditState(blocks=(jax.tree.map(jnp.asarray, block),),
                                hs_coeff=jnp.array([1.0, 1.0]), flavor=pspec.delta_flavor)
        state = opt.init(edit.blocks)
    else:
        edit = jdelta.EditState(mode="input", delta_rows=jnp.asarray(inp["rows"]),
                                hs_coeff=jnp.array([1.0, 1.0]), input_style="add",
                                times=tuple(SEQ))
        state = opt.init(edit.delta_rows)
    p, e = jmesh.replicate(mesh, jax.tree.map(jnp.asarray, params)), jmesh.replicate(mesh, edit)
    edit, _, metrics = step(p, e, state, put(mesh, inp[f"{config}_xl"]),
                            put(mesh, inp[f"{config}_x0"]), LR)
    return np.asarray(metrics["loss_per_step"]), edit


@pytest.fixture(scope="module")
def jax_train(setup):
    return {name: _jax_train(setup, config, target, data)
            for name, config, target, data in TRAIN_CASES}


@pytest.mark.parametrize("world, name", [(w, c[0]) for w in (2, 4) for c in TRAIN_CASES
                                         if w // c[3] >= 2])
def test_one_edited_timestep_matches_jax_on_sharded_inputs(setup, port_runs, jax_train, world,
                                                            name):
    """One edited timestep's Δ update (lr times the gradient) of the sharded
    port, each rank backpropagating its share of the L1 + CLIP loss and the
    gradients summed over the spatial ranks (averaged over the data axis on
    the 2 x 2 mesh), equals JAX `make_train_step` on spatially sharded
    inputs; the logged loss is the one-process value."""
    config, target, data = next((c, t, d) for n, c, t, d in TRAIN_CASES if n == name)
    got = port_runs[world]
    want_loss, jedit = jax_train[name]
    close_to_scale(want_loss, got[f"{name}_loss"], f"{name} loss, {world} ranks", bound=JAX_TOL)
    pspec = setup[2]["configs"][config][1]
    if target == "rows":
        want = [tdelta.rows_to_nchw(np.asarray(jedit.delta_rows)).numpy()]
        init = [tdelta.rows_to_nchw(setup[1]["rows"]).numpy()]
    else:
        trained = tdelta.delta_block_from_tree(jax.tree.map(np.asarray, jedit.blocks[0]),
                                               pspec.bottleneck_ch, pspec.temb_ch,
                                               flavor=pspec.delta_flavor)
        want = [p.detach().numpy() for p in trained.parameters()]
        init = [p.detach().numpy() for p in setup[2]["configs"][config][4].parameters()]
    assert len(want) == sum(k.startswith(f"{name}_p") for k in got)
    moved = max(float(np.abs(w - i).max()) for w, i in zip(want, init))
    assert moved > 1e-4, f"{name}: the Δ did not move"
    for i, (w, i0) in enumerate(zip(want, init)):
        close_to_scale(w - i0, got[f"{name}_p{i}"] - i0, f"{name} update {i}, {world} ranks",
                       bound=JAX_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_precompute_with_h_gathers_the_trajectory_whole(setup, port_runs, world):
    """DiffStyle's inversion with h on row blocks: x_lat and the NHWC h
    trajectory whole (2e-4 of scale against the unsharded call, JAX's
    sharded bound), and the cache file holds them."""
    from asyrp_official_torch.core.schedule import make_schedule as p_make_schedule
    from asyrp_official_torch.pipelines import precompute as pc

    root, inp = setup[0], setup[1]
    spec = spec_from_config(TINY_DDPMPP_CONFIG)
    model = spec.build()
    model.load_state_dict(torch.load(root / "ddpmpp.pt"))
    want = pc.precompute_with_h(spec, model.eval(), p_make_schedule(), inp["ddpmpp_x0"],
                                n_inv_step=4, device=torch.device("cpu"))
    got = port_runs[world]
    assert got["pre_h_traj"].shape == want["h_traj"].shape
    for k in ("x_lat", "h_traj"):
        close_to_scale(want[k], got[f"pre_{k}"], f"precompute_with_h {k}, {world} ranks",
                       bound=JAX_TOL)
    with np.load(root / f"cache_{world}" / "CUSTOM_inv4_h.npz") as cache:
        for k in ("x_lat", "h_traj"):
            np.testing.assert_array_equal(cache[k], got[f"pre_{k}"])


def _id_loss(inp, with_id=True):
    """The one-process training loss of the `id_*` images (L1, cosine 0.9,
    and the ID term), and x0_t's gradient."""
    from asyrp_official_torch.losses.id_loss import IRSE50
    from asyrp_official_torch.pipelines import train as ttr

    torch.manual_seed(0)
    id_net = IRSE50()
    x0, x0_t, x0_t_origin = (_t(inp[f"id_{n}"]) for n in ("x0", "x0_t", "x0_t_origin"))
    loss = ttr.default_loss(x0_t, x0_t_origin, x0, cosine=0.9, extra=(lambda a, b, c: (
        ID_W * id_net.id_loss(b.permute(0, 3, 1, 2), c.permute(0, 3, 1, 2)).mean()))
        if with_id else None)
    loss.backward()
    return loss.detach().numpy(), x0_t.grad.numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_id_term_shares_sum_to_the_one_process_loss(setup, port_runs, world):
    """The ArcFace ID term (`--id_loss_w`), computed on every rank from the
    gathered 256² images and weighted 1/S (rule 2): the ranks' shares of
    the L1 + ID loss sum to the one-process loss, and x0_t's gradient is the
    one-process one (the ID term reaches no parameter, x0_t's features
    being detached, so only the loss shows its share). Without the 1/S the
    sum is off by S - 1 times the ID term: 0.47 of scale on 2 ranks (a
    mutation check, made on a copy of the port)."""
    inp, got = setup[1], port_runs[world]
    want, want_dx = _id_loss(inp)
    l1_only, _ = _id_loss(inp, with_id=False)
    assert want - l1_only > 0.1 * want, (want, l1_only)  # the ID term is a real share
    close_to_scale(want, got["id_loss"], f"L1 + ID loss, {world} ranks", bound=WHOLE_TOL)
    close_to_scale(want_dx, got["id_dx0_t"], f"d loss / d x0_t, {world} ranks",
                   bound=WHOLE_TOL)
