"""The device trace of a `--trace 1` run: `torch.profiler` (host and CUDA)
over the first `trace_requests` whole requests of the measured window (the
cell's traffic file sets how many), read back from the profiler's raw
events. A profiler over a whole 51-s window would record about a million
kernels and slow the host it measures; a fixed number of requests keeps
its cost the same in every run.

What a summary holds, all within the benchmark's "portbench.traced" span,
which opens before the first traced request and closes once the last one
is complete on the device:

  * `window_s`, and `busy_s`: the union of the intervals in which a device
    operation (kernel, copy, set) ran, so gaps between requests count as
    idle;
  * every kernel's time by family (`family`: K1, K2, K3, cuDNN's layout
    conversions, convolutions and GEMMs, other) and their count;
  * the breakdown: the kernels that took most time, and the longest idle
    gaps summed by what the host was doing when they happened (the deepest
    host event that covers the gap's middle, else `_host_between_ops_`).
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

__all__ = ["family", "Tracer", "TraceSummary", "summarize", "union_s"]

TRACED_SPAN, REQUEST_SPAN = "portbench.traced", "portbench.request"

_GEMM_OPS = {"aten::cudnn_convolution", "aten::convolution", "aten::_convolution",
             "aten::convolution_backward", "aten::conv2d", "aten::mm", "aten::addmm",
             "aten::bmm", "aten::baddbmm", "aten::matmul", "aten::linear", "aten::einsum"}
_GEMM_NAME = re.compile(r"gemm|xmma|cutlass|conv|fft|gemv|splitk|winograd|cudnn|cublas",
                        re.IGNORECASE)


def family(name: str, linked_op: str = "") -> str:
    """A device kernel's family, by its name, then by the host op that
    launched it."""
    if any(k in name for k in ("gn_fwd", "gn_bwd", "gn_part", "gn_apply")):
        return "k1"
    if "attn_fwd" in name or "attn_bwd" in name:
        return "k2"
    if any(k in name for k in ("ddim_fwd", "ddim_bwd", "ddpm_fwd")):
        return "k3"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "layout"
    if linked_op in _GEMM_OPS or _GEMM_NAME.search(name):
        return "gemm"
    return "other"


def union_s(intervals: List[Tuple[int, int]], lo: int, hi: int) -> Tuple[float, List[Tuple[int, int]]]:
    """Seconds of [lo, hi] (ns) covered by the union of `intervals`, and
    the uncovered gaps in order."""
    busy, gaps, cur = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        busy += e - cur
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy / 1e9, gaps


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    n_kernels: int
    kernel_s: float
    family_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:]", "_", name)[:64]


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    return int(f()) if f is not None else int(getattr(e, what + "_us")() * 1000)


def summarize(events, top: int = 10) -> Optional[TraceSummary]:
    """A summary of the profiler's raw events (`kineto_results.events()`),
    or None where the traced span or any device operation is missing."""
    from torch.autograd import DeviceType

    cpu, dev, op_name = [], [], {}
    for e in events:
        name = e.name()
        start = _ns(e, "start")
        end = start + int(e.duration_ns()) if hasattr(e, "duration_ns") else _ns(e, "end")
        if e.device_type() == DeviceType.CPU:
            cpu.append((start, end, name, e.start_thread_id()))
            if name.startswith("aten::"):
                op_name[e.correlation_id()] = name
        elif not (name.startswith("portbench.") or e.is_user_annotation()):
            # (the device side of a host span is an annotation, not work)
            dev.append((start, end, name, e.linked_correlation_id()))
    spans = [c for c in cpu if c[2] == TRACED_SPAN]
    if not spans or not dev:
        return None
    w0, w1, _, main_tid = spans[0]

    fam_s, by_name = collections.Counter(), collections.Counter()
    n_kernels, kernel_ns, busy = 0, 0, []
    for s, e, name, linked in dev:
        if e <= w0 or s >= w1:
            continue
        busy.append((s, e))
        if name.startswith("Memcpy") or name.startswith("Memset"):
            continue
        n_kernels += 1
        kernel_ns += e - s
        fam_s[family(name, op_name.get(linked, ""))] += (e - s) / 1e9
        by_name[name] += (e - s) / 1e9
    busy_s, gaps = union_s(busy, w0, w1)

    host = sorted((s, e, n) for s, e, n, tid in cpu
                  if tid == main_tid and not n.startswith("portbench.") and e > w0 and s < w1)
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for g0, g1 in gaps:
        mid, what = (g0 + g1) // 2, "_host_between_ops_"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                what = host[j][2]
                break
        idle[what] += (g1 - g0) / 1e9
    return TraceSummary(
        window_s=(w1 - w0) / 1e9, busy_s=busy_s, n_kernels=n_kernels, kernel_s=kernel_ns / 1e9,
        family_s=dict(fam_s),
        device_ops=[(_short(n), s) for n, s in by_name.most_common(top)],
        idle_gaps=[(_short(n), s) for n, s in idle.most_common(top)])


class Tracer:
    """The profiler, when `enabled`, from `start()` to `stop()`, inside the
    traced span; `span(name)` marks a host range in the trace while it
    runs (a no-op otherwise)."""

    def __init__(self, enabled: bool):
        self.enabled, self.prof, self._span = enabled, None, None

    def start(self) -> None:
        if self.enabled and self.prof is None:
            from torch.profiler import ProfilerActivity, profile, record_function

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._span = record_function(TRACED_SPAN)
            self._span.__enter__()

    def stop(self) -> None:
        """Closes the traced span and the profiler; the caller has waited
        for the device."""
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self._span = None

    def span(self, name: str):
        if self._span is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def summary(self) -> Optional[TraceSummary]:
        if self.prof is None:
            return None
        return summarize(self.prof.profiler.kineto_results.events())
