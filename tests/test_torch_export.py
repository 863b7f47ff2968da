"""The port's serving export (`pipelines/export.py`, `torch.export` of the
inversion, edited-decode and plain-decode steps), on the CPU, on the tiny
DDPM++ config of the engine tests (4 + 4 steps, t_edit 500, t_addnoise 300,
batch 2): the loaded artifact against the port's live `make_invert_edit`
and the JAX package's, from the same x0 and key (the eta noise is
`jax.random.normal(fold_in(key, step))` in all three); on the tiny OpenAI
learn_sigma UNet (eps a strided view) against the port's live engine; every
exported graph names the kernels' registered ops and holds no
`aten.group_norm`, SDPA or softmax; the state-dict key-count guard; the
temp-then-replace write; and hostrng's `fold_in` is JAX's.

Tolerance: `close_to_scale` 1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import close_to_scale

from asyrp_official_torch.core.schedule import make_schedule, uniform_seq
from asyrp_official_torch.models import delta as tdelta
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import engine as tengine
from asyrp_official_torch.pipelines import export as texport
from asyrp_official_torch.utils import hostrng

from test_torch_engine import T_ADDNOISE, T_EDIT, JSPEC, weights  # noqa: F401 (fixture)
from test_torch_engine import SPEC as DDPMPP_SPEC
from asyrp_official_tpu.core.schedule import make_schedule as j_make_schedule
from asyrp_official_tpu.pipelines import engine as jengine

SEQ = uniform_seq(4, 999)
KEY = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _export(spec, model, edit, path, batch=2, size=32):
    artifact, meta = texport.export_invert_edit(
        spec, make_schedule(), SEQ, SEQ, model, edit, t_edit=T_EDIT, t_addnoise=T_ADDNOISE,
        batch=batch, image_size=size)
    texport.save_serving(str(path), artifact, meta)
    return texport.load_serving(str(path))


@pytest.fixture(scope="module")
def served(weights, tmp_path_factory):  # noqa: F811
    jparams, model, jedit, tedit = weights
    path = tmp_path_factory.mktemp("export") / "serve.pt2"
    return _export(DDPMPP_SPEC, model, tedit, path), path


def test_fold_in_is_jax_fold_in():
    for data in (0, 3, 39, 2**31 + 5):
        np.testing.assert_array_equal(
            hostrng.fold_in(hostrng.PRNGKey(KEY), data),
            np.asarray(jax.random.fold_in(jax.random.PRNGKey(KEY), data)))


def test_artifact_matches_the_live_engines(weights, served):  # noqa: F811
    jparams, model, jedit, tedit = weights
    fn, _ = served
    x0 = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    got = fn(model.state_dict(), tedit, torch.from_numpy(x0), hostrng.PRNGKey(KEY))
    live = tengine.make_invert_edit(DDPMPP_SPEC, make_schedule(), SEQ, SEQ, t_edit=T_EDIT,
                                    t_addnoise=T_ADDNOISE)(
        model, tedit, torch.from_numpy(x0), noise_fn=texport.engine_noise_fn(hostrng.PRNGKey(KEY)))
    want = jengine.make_invert_edit(JSPEC, j_make_schedule(), SEQ, SEQ, t_edit=T_EDIT,
                                    t_addnoise=T_ADDNOISE)(jparams, jedit, jnp.asarray(x0),
                                                           jax.random.PRNGKey(KEY))
    close_to_scale(live.numpy(), got.numpy(), "artifact vs the port's live engine")
    close_to_scale(np.asarray(want), got.numpy(), "artifact vs JAX's live engine")
    assert np.abs(got.numpy() - x0).max() > 1e-2


def test_exported_graphs_name_the_registered_ops(served):
    fn, _ = served
    assert set(fn.programs) == {"invert", "decode", "edit"}
    for kind, prog in fn.programs.items():
        targets = {str(n.target) for n in prog.graph.nodes if n.op == "call_function"}
        for op in ("asyrp.group_norm.default", "asyrp.attention.default",
                   "asyrp.ddim_step.default"):
            assert op in targets, (kind, op)
        hidden = [t for t in targets if any(s in t for s in (
            "group_norm", "scaled_dot_product", "softmax")) and not t.startswith("asyrp.")]
        assert not hidden, (kind, hidden)


def test_key_count_guard(weights, served):  # noqa: F811
    _, model, _, tedit = weights
    fn, _ = served
    state = dict(model.state_dict())
    state.pop(next(iter(state)))
    x0 = torch.zeros(2, 32, 32, 3)
    with pytest.raises(ValueError, match="state entries"):
        fn(state, tedit, x0, hostrng.PRNGKey(0))
    two = tdelta.EditState(blocks=tedit.blocks * 2, hs_coeff=torch.ones(3))
    with pytest.raises(ValueError, match="edit entries"):
        fn(model.state_dict(), two, x0, hostrng.PRNGKey(0))
    with pytest.raises(ValueError, match="deltablock"):
        fn(model.state_dict(), tdelta.EditState(mode="interp_batch"), x0, hostrng.PRNGKey(0))


def test_save_writes_then_replaces(served, tmp_path):
    fn, path = served
    assert sorted(os.listdir(path.parent)) == ["serve.pt2", "serve.pt2.meta.json"]
    target = tmp_path / "bad.pt2"
    with pytest.raises(TypeError):  # meta that JSON cannot write: no file of it is left
        texport.save_serving(str(target), b"abc", {"x": object()})
    assert sorted(os.listdir(tmp_path)) == ["bad.pt2"]
    assert target.read_bytes() == b"abc"


def test_learn_sigma_artifact_matches_the_live_engine(tmp_path):
    """eps and eps_mod reach the registered K3 op as the strided first C
    channels of the 2C-channel output."""
    from test_torch_openai import OPENAI_TINY_CONFIG, perturbed, perturbed_block

    spec = spec_from_config(OPENAI_TINY_CONFIG)
    model = spec.build()
    model.load_state_dict(spec.state_dict_from_jax(perturbed(spec.init(hostrng.PRNGKey(5)))))
    model.eval()
    block = tdelta.delta_block_from_tree(perturbed_block(9), spec.bottleneck_ch, spec.temb_ch,
                                         flavor="openai")
    edit = tdelta.EditState(blocks=(block.eval(),), hs_coeff=torch.tensor([1.0, 1.0]),
                            flavor="openai")
    fn = _export(spec, model, edit, tmp_path / "oai.pt2", batch=1)
    x0 = torch.from_numpy(np.random.RandomState(1).randn(1, 32, 32, 3).astype(np.float32))
    got = fn(model.state_dict(), edit, x0, hostrng.PRNGKey(KEY))
    live = tengine.make_invert_edit(spec, make_schedule(), SEQ, SEQ, t_edit=T_EDIT,
                                    t_addnoise=T_ADDNOISE)(
        model, edit, x0, noise_fn=texport.engine_noise_fn(hostrng.PRNGKey(KEY)))
    close_to_scale(live.numpy(), got.numpy(), "learn_sigma artifact vs the live engine")
