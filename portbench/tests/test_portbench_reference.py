"""The plain reference and the program agree at a tiny width on the CPU:
one UNet eval with and without the DeltaBlock for both families, and the
whole edit chain."""
import pytest
import torch

from portbench import harness, program, weights
from portbench.reference.ops import RefOps
from portbench.reference.unets import RefUNet
from portbench.tests.tiny import tiny_cell, tiny_config


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("family", ["ddpmpp", "openai"])
def test_one_eval_and_the_dual_decode(family):
    from asyrp_official_torch.models import delta
    from asyrp_official_torch.models.registry import spec_from_config

    cfg = tiny_config(family)
    spec = spec_from_config(cfg)
    model, shapes = program.seeded_module(spec.build, 3, "unet", "cpu")
    cls = delta.DeltaBlock if spec.delta_flavor == "ddpm" else delta.OpenAIDeltaBlock
    block, bshapes = program.seeded_module(lambda: cls(spec.bottleneck_ch, spec.temb_ch), 3,
                                           "delta", "cpu")
    edit = delta.EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0]),
                           flavor=spec.delta_flavor)
    x = weights.normals((2, 32, 32, 3), 3, "latents", "cpu")
    t = torch.tensor([999.0, 420.0])
    with torch.no_grad():
        eps, eps_mod, _, _ = spec.apply(model, x, t, edit=edit)
        ref = RefUNet(weights.draw_state(shapes, 3, "unet", "cpu"), cfg, RefOps())
        h, hs, temb = ref.encode(x.permute(0, 3, 1, 2).contiguous(), t)
        want = ref.decode(h, hs, temb).permute(0, 2, 3, 1)
        want_mod = ref.decode(h + ref.delta(h, temb, weights.draw_state(bshapes, 3, "delta", "cpu")),
                              hs, temb).permute(0, 2, 3, 1)
    assert _rel(eps, want) < 1e-5
    assert _rel(eps_mod, want_mod) < 1e-5
    assert _rel(eps_mod, eps) > 1e-3  # the edit changes the decode


@pytest.mark.parametrize("workload", ["celebahq-edit-f32-bs1", "afhq-edit-bf16-bs16"])
def test_edit_chain(workload):
    cell = tiny_cell(workload, steps=8, batch=2)
    cell.traffic["dtype"] = "float32"
    state = harness.start_cell(cell, 12, "cpu")
    state.request(0)
    got = state.readings()
    state.finish()
    gaps = state.gaps(got, state.reference("f32"))
    for name in ("img_rel_rms", "eps_rel", "step_rel"):
        assert gaps.get(name, 0.0) < 1e-4, gaps
    for name in ("answer_exact", "chain_exact", "coef_exact"):
        assert gaps.get(name, 0.0) == 0.0, gaps
