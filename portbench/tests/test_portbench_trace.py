"""The trace's reading: device intervals unioned over the traced span,
span annotations left out, kernels sorted into families, and idle gaps
named by the host; a traced run profiles only the traffic's
`trace_requests` first requests of its window."""
import contextlib
import time
from unittest import mock

import pytest
from torch.autograd import DeviceType

from portbench import bench, counting, harness, trace
from portbench.tests.tiny import cells, tiny_cell
from portbench.window import Window


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, linked=0, tid=1, annotation=False):
        self._v = (name, dev, start, dur, corr, linked, tid, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def _events():
    return [
        Ev(trace.TRACED_SPAN, CPU, 0, 1000, annotation=True),
        Ev(trace.REQUEST_SPAN, GPU, 0, 1000, annotation=True),  # the span's device side
        Ev("aten::cudnn_convolution", CPU, 90, 20, corr=7),
        Ev("cudaLaunchKernel", CPU, 100, 5, corr=11, linked=7),
        Ev("sm90_xmma_fprop_implicit_gemm_bf16", GPU, 100, 200, corr=11, linked=7),
        Ev("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", GPU, 300, 50, corr=12),
        Ev("cudaLaunchKernel", CPU, 520, 5, corr=13),
        Ev("void gn_fwd<float, 4, 256>", GPU, 600, 100, corr=13),
        Ev("aten::add", CPU, 750, 150, corr=8),
        Ev("Memcpy HtoD (Pageable -> Device)", GPU, 950, 10),
        Ev("void gn_fwd<float, 4, 256>", GPU, 2000, 100, corr=14),  # outside the window
    ]


def test_summary():
    s = trace.summarize(_events())
    assert s.window_s == pytest.approx(1e-6)
    # 100-350 and 600-700 and 950-960: 360 ns of 1000
    assert s.busy_s == pytest.approx(360e-9)
    assert s.n_kernels == 3
    assert s.family_s == pytest.approx({"gemm": 200e-9, "layout": 50e-9, "k1": 100e-9})
    gaps = dict(s.idle_gaps)
    assert gaps["aten::add"] == pytest.approx(250e-9)  # 700-950, the host inside aten::add
    assert gaps["_host_between_ops_"] == pytest.approx(100e-9 + 250e-9 + 40e-9)


def test_no_traced_span_no_summary():
    assert trace.summarize([e for e in _events() if e.name() != trace.TRACED_SPAN]) is None


class CountingTracer(trace.Tracer):
    """A tracer that profiles nothing and counts the requests it saw
    between start() and stop()."""
    made = []

    def __init__(self, enabled):
        super().__init__(enabled)
        self.running, self.requests = False, 0
        CountingTracer.made.append(self)

    def start(self):
        self.running = True

    def stop(self):
        self.running = False

    def span(self, name):
        if self.running and name == trace.REQUEST_SPAN:
            self.requests += 1
        return contextlib.nullcontext()


@pytest.mark.parametrize("workload", cells())
def test_only_the_first_requests_are_traced(workload):
    cell = tiny_cell(workload, steps=4, batch=2)
    cell.traffic.update(dtype="float32", trace_requests=2)
    CountingTracer.made.clear()
    with mock.patch.object(harness, "Tracer", CountingTracer):
        result = harness.run_cell(cell, seed=5, seconds=1.0, trace=True,
                                  t_start=time.perf_counter(), device="cpu")
    assert result["attempted"] > 2
    assert [t.requests for t in CountingTracer.made] == [2]
    assert not CountingTracer.made[0].running


@pytest.mark.parametrize("name,linked,fam", [
    ("void (anonymous namespace)::gn_bwd<float, 4, 256>(BwdParams)", "", "k1"),
    ("void fwd::attn_fwd<__nv_bfloat16>", "", "k2"),
    ("void attn_bwd_d<float>", "", "k2"),
    ("ddim_fwd_rows", "", "k3"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16>", "", "layout"),
    ("void fft2d_r2c_32x32<float>", "", "gemm"),
    ("void gemv2N_kernel<int, int, float2>", "", "gemm"),
    ("void at::native::elementwise_kernel<128, 4>", "aten::addmm", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4>", "aten::add", "other"),
])
def test_families(name, linked, fam):
    assert trace.family(name, linked) == fam


def test_union():
    busy, gaps = trace.union_s([(10, 20), (15, 30), (50, 60), (-5, 2)], 0, 100)
    assert busy == pytest.approx(32e-9)
    assert gaps == [(2, 10), (30, 50), (60, 100)]


def test_mfu_and_device_time_read_their_requests():
    """mfu reads the requests after the traced ones (no profiler on the
    host); device_ms_per_image the traced ones' device time."""
    c = counting.Counter(4)
    c.add("gemm", int(67e12), 0)  # one second of f32 peak per image
    s = trace.summarize(_events())
    win = Window(0.0, 9.0, [3.0, 2.0, 2.0, 2.0], 4)
    out = harness.Outcome("float32", "image", 1.0, win, c, s, traced_requests=2, traced_work=2)
    read = {m: bench.load_module(bench.reader_path(m), m).read for m in
            ("mfu.lat", "device_ms_per_image.lat")}
    assert read["mfu.lat"](out) == pytest.approx(50.0)  # 2 images in 4 s
    assert read["device_ms_per_image.lat"](out) == pytest.approx(360e-9 * 1e3 / 2)
