"""The port's own spans and counters (`asyrp_official_torch/utils/profiling.py`)
on the CPU, through the serving path `pipelines/engine.make_invert_edit` of
tiny DDPM++ and OpenAI UNets (32 x 32, two levels; 3 inversion steps, then
4 generation steps of which 2 edited):

  * with no profiler recording, a request records nothing and never enters
    a record function;
  * under `torch.profiler.profile`, the profiler's events hold the spans
    of the table in `utils/profiling.py`, nested request > chain > step >
    eval > encode / decode / delta > layer under one request, and the
    in-memory record keeps the evals with their `edited` attr;
  * `weight_casts` counts every conv and linear tensor converted at use in
    bf16 (the stacked dual decode at batch 2, the split one at batch 1), and
    nothing in f32;
  * the outputs are bit-identical with and without a profiler;
  * `trace(dir)`, what `--trace_dir` runs under, writes the spans into its
    `.pt.trace.json` and keeps nothing in memory;
  * `scripts/span_table.py` ties device work to the innermost span.
"""
import collections
import json
import os
from unittest import mock

import pytest
import torch
from torch import nn

from asyrp_official_torch.core.schedule import make_schedule, uniform_seq
from asyrp_official_torch.core.steptable import generation_table, inversion_table
from asyrp_official_torch.models import ddpmpp, delta, openai_unet
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import engine
from asyrp_official_torch.utils import profiling as prof

STEPS, T_EDIT, T_ADDNOISE = 4, 500, 200
CONFIGS = {
    "ddpmpp": {"data": {"dataset": "CelebA_HQ", "image_size": 32, "channels": 3},
               "model": {"family": "ddpmpp", "in_channels": 3, "out_ch": 3, "ch": 32,
                         "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [16],
                         "resamp_with_conv": True}},
    "openai": {"data": {"dataset": "AFHQ", "image_size": 32, "channels": 3},
               "model": {"family": "openai", "in_channels": 3, "out_ch": 6, "ch": 32,
                         "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [16],
                         "learn_sigma": True, "num_head_channels": 32,
                         "use_scale_shift_norm": True, "resblock_updown": True}},
}
# the layer modules each span stands for (DDPM++ resamples by `_Resample`)
LAYER_TYPES = {
    prof.RES: (ddpmpp.ResnetBlock, openai_unet.ResBlock),
    prof.ATTN: (ddpmpp.AttnBlock, openai_unet.AttentionBlock),
    prof.RESAMPLE: (ddpmpp._Resample, openai_unet.Downsample, openai_unet.Upsample),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_record():
    prof.reset()
    yield
    prof.reset()


def _serving(family, dtype=torch.float32, batch=2):
    """(request, model, block): `request()` edits a fixed batch through
    make_invert_edit."""
    spec = spec_from_config(CONFIGS[family])
    torch.manual_seed(0)
    model = spec.build().eval().requires_grad_(False)
    cls = delta.DeltaBlock if spec.delta_flavor == "ddpm" else delta.OpenAIDeltaBlock
    block = cls(spec.bottleneck_ch, spec.temb_ch).eval().requires_grad_(False)
    edit = delta.EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0]),
                           flavor=spec.delta_flavor)
    seq = uniform_seq(STEPS, 999)
    run = engine.make_invert_edit(spec, make_schedule(), seq, seq, t_edit=T_EDIT,
                                  t_addnoise=T_ADDNOISE, compute_dtype=dtype)
    x0 = torch.rand(batch, 32, 32, 3) * 2 - 1
    noise = torch.randn(STEPS, batch, 32, 32, 3)
    return (lambda: run(model, edit, x0, noise_fn=lambda i, shape: noise[i])), model, block


def _evals():
    """(plain, edited) evals of one request."""
    seq = uniform_seq(STEPS, 999)
    n_inv = inversion_table(seq).num_steps
    gen = generation_table(seq, t_edit=T_EDIT, t_addnoise=T_ADDNOISE)
    n_edit = int(gen.use_delta.sum())
    return n_inv + gen.num_steps - n_edit, n_edit


def _profiled(request):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        out = request()
    return out, p


def _weights(module, skip=()):
    """The conv and linear tensors of `module`, outside the submodules `skip`."""
    return [w for name, m in module.named_modules()
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear))
            and not any(name.startswith(s) for s in skip)
            for w in m.parameters(recurse=False)]


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_no_profiler_records_nothing_and_never_enters_record_function(family):
    request, _, _ = _serving(family, torch.bfloat16)
    entered = AssertionError("a record function was entered")
    with mock.patch.object(torch.profiler, "record_function", side_effect=entered), \
            mock.patch.object(prof, "_RecordFunctionFast", side_effect=entered):
        request()
    assert prof.records() == [] and prof.counters() == {}


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_spans_nest_under_one_request(family):
    """The nesting, as the profiler's events hold it; the in-memory record
    keeps the evals alone, in order, with their attrs."""
    request, model, _ = _serving(family)
    _, p = _profiled(request)
    spans = sorted((e for e in p.events() if e.name.startswith("asyrp.")),
                   key=lambda e: e.time_range.start)

    def parent(e):
        e = e.cpu_parent
        while e is not None and not e.name.startswith("asyrp."):
            e = e.cpu_parent
        return None if e is None else e.id

    kids = collections.defaultdict(list)
    for e in spans:
        kids[parent(e)].append(e)

    def names(e):
        return collections.Counter(k.name for k in kids[e.id])

    (req,) = kids[None]  # one request holds every span
    assert req.name == prof.REQUEST
    chains = kids[req.id]
    assert [c.name for c in chains] == [prof.CHAIN] * 2
    n_plain, n_edit = _evals()
    steps = [s for c in chains for s in kids[c.id]]
    assert {s.name for s in steps} == {prof.STEP} and len(steps) == n_plain + n_edit
    evals = [e for s in steps for e in kids[s.id]]
    assert [e.name for e in evals] == [prof.EVAL] * len(steps)

    recs = prof.records()
    assert [r.name for r in recs] == [prof.EVAL] * len(evals)
    assert all(r.device_ms is None for r in recs)  # no CUDA events here
    assert sum(r.attrs["edited"] for r in recs) == n_edit
    want = {name: sum(isinstance(m, types) for m in model.modules())
            for name, types in LAYER_TYPES.items()}
    for e, r in zip(evals, recs):
        assert r.attrs == {"edited": r.attrs["edited"]}
        # the stacked dual decode: one decoder pass on 2B
        assert names(e) == collections.Counter(
            {prof.ENCODE: 1, prof.DECODE: 1, **({prof.DELTA: 1} if r.attrs["edited"] else {})})
        layers = collections.Counter()
        for part in kids[e.id]:
            layers += names(part)
            assert part.name == prof.DELTA or names(part)[prof.CONV] == 1
        assert layers - collections.Counter({prof.CONV: 2}) == collections.Counter(
            {k: v for k, v in want.items() if v})
    for e in spans:  # layers are leaves of the encoder and decoder
        if e.name in (prof.RES, prof.ATTN, prof.RESAMPLE, prof.CONV):
            assert not kids[e.id] and e.cpu_parent is not None
            assert parent(e) in {s.id for s in spans if s.name in (prof.ENCODE, prof.DECODE)}


@pytest.mark.parametrize("family", sorted(CONFIGS))
@pytest.mark.parametrize("batch", [1, 2])
def test_weight_casts_count_every_converted_tensor(family, batch):
    """bf16: each eval converts the UNet's conv and linear tensors but the
    timestep MLP's (it runs in f32); an edited eval also the DeltaBlock's,
    and at batch 1, where the dual decode is split, the decoder's again."""
    request, model, block = _serving(family, torch.bfloat16, batch)
    request()  # no profiler: nothing counted
    assert prof.counters() == {}
    _profiled(request)
    unet = _weights(model, skip=("temb", "time_embed"))
    decoder = _weights(model, skip=("temb", "time_embed", "conv_in", "down", "mid",
                                    "input_blocks", "middle_block"))
    per_edit = _weights(block) + (decoder if batch == 1 else [])
    n_plain, n_edit = _evals()
    casts = (n_plain + n_edit) * len(unet) + n_edit * len(per_edit)
    assert prof.counters() == {prof.WEIGHT_CASTS: casts}

    prof.reset()
    f32, _, _ = _serving(family, torch.float32, batch)
    _profiled(f32)
    assert prof.records() and prof.counters() == {}


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_outputs_bit_identical_with_and_without_a_profiler(family):
    request, _, _ = _serving(family, torch.bfloat16)
    plain = request()
    traced, _ = _profiled(request)
    assert torch.equal(plain, traced)


def test_trace_dir_trace_holds_the_spans(tmp_path):
    request, _, _ = _serving("ddpmpp")
    with prof.trace(str(tmp_path)):
        request()
    (path,) = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    with open(tmp_path / path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {prof.REQUEST, prof.STEP, prof.EVAL, prof.RES} <= names


def test_trace_dir_keeps_no_record_in_memory(tmp_path):
    """`trace(dir)` wraps a whole `--trace_dir` run, and its file holds the
    spans: the in-memory record and the counters stay empty."""
    request, _, _ = _serving("openai", torch.bfloat16)
    with prof.trace(str(tmp_path)):
        request()
        assert prof.records() == [] and prof.counters() == {}
    assert prof.records() == [] and prof.counters() == {}
    _profiled(request)  # outside it, a profiler's record is kept again
    assert prof.records() and prof.counters()[prof.WEIGHT_CASTS] > 0


def test_span_table_ties_device_work_to_the_innermost_span():
    """scripts/span_table.py: a kernel belongs to the innermost span open on
    its launching thread when it was launched (by correlation id)."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "span_table.py")
    spec = importlib.util.spec_from_file_location("span_table", path)
    st = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(st)

    def ann(name, ts, dur, tid=1):
        return {"cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}

    def launch(ts, corr, tid=1):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "pid": 0,
                "tid": tid, "args": {"correlation": corr}}

    def kernel(name, corr, dur, op=None):
        return {"cat": "kernel", "name": name, "ts": 0, "dur": dur, "pid": 1, "tid": 7,
                "args": {"correlation": corr, "External id": op}}

    events = [ann(prof.EVAL, 0, 100), ann(prof.DECODE, 10, 50), ann(prof.RES, 20, 10),
              ann(prof.CONV, 40, 10), ann("other", 0, 100), ann(prof.STEP, 0, 100, tid=2),
              launch(5, 1), launch(25, 2), launch(35, 3), launch(45, 4), launch(70, 5),
              launch(150, 6), launch(25, 7, tid=2),
              {"cat": "cpu_op", "name": "aten::conv2d", "ts": 44, "dur": 3, "pid": 0, "tid": 1,
               "args": {"External id": 99}},
              kernel("cast", 1, 1000), kernel("gemm", 2, 2000), kernel("cat", 3, 3000),
              kernel("gemm", 4, 4000, op=99), kernel("permute", 5, 5000), kernel("k3", 6, 6000),
              kernel("noise", 7, 7000), {"cat": "gpu_user_annotation", "name": prof.EVAL,
                                         "dur": 100000, "args": {"correlation": 1}}]
    by_span, kernels = st.table(events)
    assert by_span == {prof.EVAL: 6.0, prof.RES: 2.0, prof.DECODE: 3.0, prof.CONV: 4.0,
                       st.NONE: 6.0, prof.STEP: 7.0}
    assert kernels[prof.EVAL] == {("cast", "?"): 1.0, ("permute", "?"): 5.0}
    assert kernels[prof.CONV] == {("gemm", "aten::conv2d"): 4.0}
