"""Tracing of the port: its own spans and counters, and `trace(dir)`.

  * `trace(dir)` — a `torch.profiler` context (host and, where there is one,
    the CUDA device) writing a TensorBoard-loadable trace
    (`{dir}/*.pt.trace.json`, the torch-tb-profiler layout) of the run, the
    port's spans in it.
  * `span(name, **attrs)` — a context manager around one piece of the work
    (the names are the constants below). It enters the profiler's record
    function in its C++ form (`torch._C._profiler._RecordFunctionFast`, a
    `cpu_op` event; `torch.profiler.record_function` costs the host several
    times as much), so the span lies in the same Kineto trace as the device
    kernels, on the same clock. The trace holds the spans' nesting, and
    `scripts/span_table.py` ties each kernel to its span by correlation id.
  * An `asyrp.eval` span, whose device time a benchmark metric reads without
    the trace, also appends its name and attrs to an in-memory record with,
    once CUDA is initialised, a pair of timing events on the current stream;
    its device time, between them, includes the device's idle time inside
    the span. No other span records events: each is a device API call the
    host pays for inside the work it measures.
  * `count(name, n)` — adds n to a named counter.
  * `records()`, `counters()`, `reset()` — that record, resolved.

All of it happens only while a torch profiler is recording (`trace`, the
benchmark's traced requests, any `torch.profiler.profile`). With none, a
span site costs one flag read and returns one shared no-op context: no
record function, no allocation; `count` returns after the same read.
Inside `trace(dir)`, whose file holds every span, nothing is kept in
memory, so a long traced run does not grow the record.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "span", "count", "records", "counters", "reset", "Span",
           "REQUEST", "CHAIN", "STEP", "EVAL", "ENCODE", "DECODE", "DELTA", "RES", "ATTN",
           "RESAMPLE", "CONV", "WEIGHT_CASTS", "CHANNELS_LAST_CONVS"]

REQUEST = "asyrp.request"    # one serving call (pipelines/engine.make_invert_edit)
CHAIN = "asyrp.chain"        # one trajectory (core/sampler.sample_chain)
STEP = "asyrp.step"          # one step of it: the eval, the noise, the step kernel
EVAL = "asyrp.eval"          # one UNet eval (attr edited)
ENCODE = "asyrp.encode"      # the encoder through the middle block
DECODE = "asyrp.decode"      # one decoder pass, output head included
DELTA = "asyrp.delta"        # the edit of h (models/delta.apply_edit)
RES = "asyrp.res"            # a resblock
ATTN = "asyrp.attn"          # an attention block
RESAMPLE = "asyrp.resample"  # a down- or upsampling layer
CONV = "asyrp.conv"          # the input convolution or the output head

WEIGHT_CASTS = "weight_casts"  # weights converted to the activation dtype at use
CHANNELS_LAST_CONVS = "channels_last_convs"  # convolutions handed a channels-last input

_KEPT = frozenset({EVAL})  # the spans the in-memory record keeps


@dataclasses.dataclass
class Span:
    """One kept span, as `records()` gives it; `device_ms` is None where it
    recorded no CUDA events."""
    name: str
    attrs: dict
    device_ms: Optional[float]


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_lock = threading.Lock()
_spans: List["_Kept"] = []
_counts: Dict[str, int] = collections.Counter()
_keep = True  # False inside trace(dir)


class _Kept:
    """A span in the trace and in the in-memory record."""
    __slots__ = ("rf", "name", "attrs", "ev0", "ev1")

    def __init__(self, name: str, attrs: dict):
        self.rf = _RecordFunctionFast(name)
        self.name, self.attrs, self.ev0, self.ev1 = name, attrs, None, None

    def __enter__(self):
        self.rf.__enter__()
        with _lock:
            _spans.append(self)
        if torch.cuda.is_initialized():
            self.ev0, self.ev1 = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
            self.ev0.record()
        return self

    def __exit__(self, *exc):
        if self.ev1 is not None:
            self.ev1.record()
        self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager that marks `name` while a profiler records, and
    otherwise does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if _keep and name in _KEPT:
        return _Kept(name, attrs)
    return _RecordFunctionFast(name)  # in the trace only


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while a profiler records (outside
    `trace(dir)`)."""
    if _autograd_profiler._is_profiler_enabled and _keep:
        with _lock:
            _counts[name] += n


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _counts.clear()


def records() -> List[Span]:
    """The kept spans recorded so far, in the order they opened, each with
    its device time read from its events (waiting for the device once)."""
    with _lock:
        spans = list(_spans)
    if any(s.ev1 is not None for s in spans):
        torch.cuda.synchronize()
    return [Span(s.name, dict(s.attrs),
                 None if s.ev1 is None else float(s.ev0.elapsed_time(s.ev1)))
            for s in spans]


@contextlib.contextmanager
def trace(log_dir: str):
    global _keep
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _keep = False
    try:
        with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        ):
            yield
    finally:
        _keep = True
