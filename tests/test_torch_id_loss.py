"""The port's ArcFace ID loss (IR-SE50) against the JAX package, float32 on
the CPU:

  * `extract_feats` and `id_loss` at [2, 256, 256, 3] (NCHW in the port),
    and the gradient w.r.t. x_hat against `jax.grad` (in float64: see the
    test), on the JAX init's weights (BatchNorm statistics and affine
    leaves moved) bridged by `compat.from_jax.irse50_state_dict_from_jax`;
  * a strict `load_state_dict` of a state dict under the reference
    Backbone's key names (what `ir_se50.pth` holds, `num_batches_tracked`
    included) gives the same net as the JAX `params_from_torch` path;
  * one `make_train_step` call with the ID term and L1 against the JAX
    package on a tiny 256² DDPM++ UNet: the per-step losses and the
    updated DeltaBlock;
  * `--run_train --id_loss_w 1 --ir_se50_ckpt` through the port's CLI on
    `--device cpu`, against the same run without the ID net.

Tolerance: `close_to_scale` 1e-4 (max error relative to the scale).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.compat.from_jax import irse50_state_dict_from_jax
from asyrp_official_torch.core.schedule import make_schedule as p_make_schedule
from asyrp_official_torch.losses.id_loss import IRSE50
from asyrp_official_torch.models.delta import EditState as PEdit, init_delta_blocks
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import train as ptr
from asyrp_official_tpu.core.schedule import make_schedule, train_seq
from asyrp_official_tpu.losses import id_loss as jid
from asyrp_official_tpu.models.delta import EditState as JEdit, delta_block_init
from asyrp_official_tpu.pipelines import train as jtr
from asyrp_official_tpu.runner import spec_from_config as j_spec_from_config
from asyrp_official_tpu.utils import hostrng
from asyrp_official_tpu.utils.tinyws import TINY_DDPMPP_CONFIG, tiny_base_argv, write_tiny_workspace

# the tiny DDPM++ at 256², where the face crop [35:223, 32:220] is whole
CONFIG_256 = copy.deepcopy(TINY_DDPMPP_CONFIG)
CONFIG_256["data"]["image_size"] = 256
CONFIG_256["model"]["ch_mult"] = [1, 1, 2]
CONFIG_256["model"]["attn_resolutions"] = []
T_EDIT, LR, SEED = 500, 0.05, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """The JAX init's tree, its running statistics and affine leaves moved
    away from 0 / 1 so that the BatchNorm bridge is exercised, and the
    port's net loaded from it. (On torch's default init instead, the input
    gradient is ill-conditioned in float32: the port's float32 gradient is
    3.5e-4 of scale from its own float64 one.)"""
    tree = jax.tree.map(np.asarray, jid.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)

    def move(path, v):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        if any(k in name for k in ("'mean'", "'scale'", "'bias'", "'a'")):
            return (v + 0.05 * rng.randn(*v.shape)).astype(np.float32)
        return v

    tree = jax.tree_util.tree_map_with_path(move, tree)
    net = IRSE50()
    net.load_state_dict(irse50_state_dict_from_jax(tree))
    return tree, net.eval().requires_grad_(False)


def _images(seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32) for _ in range(2)]


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_extract_feats_and_id_loss_match_jax(nets):
    """Features and loss against the JAX package in float32; the gradient
    against `jax.grad` in float64. JAX's own float32 gradient of this net is
    4.2e-3 of scale from its float64 one (measured on this input; the error
    is in the embedding's backward, the pooling adds none), while the
    port's float32 gradient is within 4e-6 of it."""
    tree, net = nets
    x, x_hat = _images(0)
    jt = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        feats = net.extract_feats(_nchw(x)).numpy()
    close_to_scale(np.asarray(jid.extract_feats(jt, jnp.asarray(x))), feats, "extract_feats")
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, rtol=1e-5)

    assert float(jid.id_loss(jt, jnp.asarray(x), jnp.asarray(x_hat)).min()) > 0
    xh = _nchw(x_hat).requires_grad_(True)
    loss = net.id_loss(_nchw(x), xh)
    loss.sum().backward()
    assert loss.shape == (2,)
    close_to_scale(np.asarray(jid.id_loss(jt, jnp.asarray(x), jnp.asarray(x_hat))),
                   loss.detach().numpy(), "id_loss")
    assert all(p.grad is None for p in net.parameters())
    with jax.enable_x64(True):
        jt64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), tree)
        grad = jax.jit(jax.grad(lambda p, a, b: jid.id_loss(p, a, b).sum(), argnums=2))
        want = np.asarray(grad(jt64, jnp.asarray(x, jnp.float64), jnp.asarray(x_hat, jnp.float64)))
    close_to_scale(want, xh.grad.permute(0, 2, 3, 1).numpy(), "d id_loss / d x_hat")


def test_reference_state_dict_loads_strictly(nets):
    tree, net = nets
    # the reference Backbone's state dict: the port's keys are its keys
    ref_sd = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    assert "body.3.shortcut_layer.0.weight" in ref_sd and "body.4.shortcut_layer.0.weight" not in ref_sd
    assert "output_layer.4.weight" in ref_sd and "input_layer.2.weight" in ref_sd
    assert any(k.endswith("num_batches_tracked") for k in ref_sd)
    loaded = IRSE50()
    loaded.load_state_dict({k: torch.as_tensor(v) for k, v in ref_sd.items()})  # strict
    via_jax = jid.params_from_torch(ref_sd)
    want = jax.tree.leaves(via_jax)
    got = jax.tree.leaves(tree)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    x, _ = _images(1)
    with torch.no_grad():
        np.testing.assert_array_equal(loaded.extract_feats(_nchw(x)).numpy(),
                                      net.extract_feats(_nchw(x)).numpy())


def _updates(trained, init):
    return {k: trained[k] - init[k] for k in init}


def test_train_step_with_id_term_matches_jax(nets):
    """The ID term is id_loss(x0_t, x0_t_origin): x0_t's features detached,
    x0_t_origin (the un-edited trajectory) the differentiated side. It adds
    to each step's loss and, as in the JAX package and the reference, no
    gradient reaches the DeltaBlock through it."""
    tree, net = nets
    jt = jax.tree.map(jnp.asarray, tree)
    spec, jspec = spec_from_config(CONFIG_256), j_spec_from_config(CONFIG_256)
    params = spec.init(hostrng.PRNGKey(0))
    model = spec.build()
    model.load_state_dict(spec.state_dict_from_jax(params))
    model.eval().requires_grad_(False)
    seq = train_seq(4, 999, T_EDIT)[0]
    rng = np.random.RandomState(0)
    x_lat = rng.randn(1, 256, 256, 3).astype(np.float32)
    x0 = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)

    def p_extra(x0_, x0_t, x0_t_origin):
        return 2.0 * net.id_loss(x0_t.permute(0, 3, 1, 2), x0_t_origin.permute(0, 3, 1, 2)).mean()

    def j_extra(x0_, x0_t, x0_t_origin):
        return 2.0 * jid.id_loss(jt, x0_t, x0_t_origin).mean()

    (block,) = init_delta_blocks(SEED, 1, spec.bottleneck_ch, spec.temb_ch)
    init = {k: v.numpy().copy() for k, v in block.state_dict().items()}
    edit = PEdit(blocks=(block.train(),), hs_coeff=torch.tensor([1.0, 1.0]))
    step = ptr.make_train_step(spec, p_make_schedule(), seq, t_edit=T_EDIT,
                               loss_fn=lambda a, b, c: ptr.default_loss(a, b, c, l1_w=3.0,
                                                                         extra=p_extra))
    got = step(model, edit, ptr.make_optimizer(block.parameters(), 1.0), torch.from_numpy(x_lat),
               torch.from_numpy(x0), LR)
    got_sd = {k: v.detach().numpy() for k, v in block.state_dict().items()}

    jblock = delta_block_init(hostrng.PRNGKey(SEED), spec.bottleneck_ch, spec.temb_ch)
    jedit = JEdit(blocks=(jax.tree.map(jnp.asarray, jblock),), hs_coeff=jnp.array([1.0, 1.0]))
    opt = jtr.make_optimizer(LR)
    jstep = jtr.make_train_step(jspec, make_schedule(), seq, t_edit=T_EDIT, optimizer=opt,
                                loss_fn=lambda a, b, c: jtr.default_loss(a, b, c, l1_w=3.0,
                                                                         extra=j_extra))
    jedit, _, want = jstep(jax.tree.map(jnp.asarray, params), jedit, opt.init(jedit.blocks),
                           jnp.asarray(x_lat), jnp.asarray(x0), LR)
    jb = jedit.blocks[0]
    want_sd = {"conv1.weight": jb["conv1"]["w"].T[:, :, None, None], "conv1.bias": jb["conv1"]["b"],
               "temb_proj.weight": jb["temb_proj"]["w"].T, "temb_proj.bias": jb["temb_proj"]["b"],
               "norm2.weight": jb["norm2"]["scale"], "norm2.bias": jb["norm2"]["bias"],
               "conv2.weight": jb["conv2"]["w"].T[:, :, None, None], "conv2.bias": jb["conv2"]["b"]}
    want_sd = {k: np.asarray(v) for k, v in want_sd.items()}
    close_to_scale(np.asarray(want["loss_per_step"]), got["loss_per_step"].numpy(), "losses")
    want_up, got_up = _updates(want_sd, init), _updates(got_sd, init)
    for k in want_up:
        close_to_scale(want_up[k], got_up[k], k)


def test_cli_trains_with_the_id_term(nets, tmp_path, caplog):
    """`--id_loss_w 1 --ir_se50_ckpt <ir_se50.pth>` on the tiny 256²
    workspace: the ID term adds to the logged loss; the trained block is
    the one trained without it (the term reaches no parameter)."""
    import logging

    import yaml

    from asyrp_official_torch.cli.main import main
    from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint

    _, net = nets
    _, imgs = write_tiny_workspace(str(tmp_path), n_images=2, image_size=256)
    cfg = str(tmp_path / "tiny256.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(CONFIG_256, f)
    pth = str(tmp_path / "ir_se50.pth")
    torch.save(net.state_dict(), pth)
    caplog.set_level(logging.INFO, logger="asyrp_official_torch.runner")
    blocks = {}
    for name, extra in (("id", ["--id_loss_w", "1", "--ir_se50_ckpt", pth]), ("plain", [])):
        argv = tiny_base_argv(cfg, imgs, str(tmp_path), str(tmp_path / "runs" / name),
                              n_img=1, bs_train=1, extra=[
                                  "--run_train", "--train_delta_block", "--do_test", "0",
                                  "--n_inv_step", "3", "--n_train_step", "3",
                                  "--device", "cpu"] + extra)
        assert main(argv) == 0, name
        blocks[name] = load_delta_checkpoint(os.path.join(
            tmp_path, "checkpoint", f"{name}_LC_CUSTOM_t999_ninv3_ngen3_0.pth"))["blocks"][0]
    loss_id, loss_plain = [r.args[1] for r in caplog.records
                           if r.name == "asyrp_official_torch.runner"
                           and r.getMessage().startswith("iter ")]
    assert loss_id > loss_plain > 0
    for g in blocks["plain"]:
        for k in blocks["plain"][g]:
            close_to_scale(blocks["plain"][g][k], blocks["id"][g][k], f"{g}/{k}")
