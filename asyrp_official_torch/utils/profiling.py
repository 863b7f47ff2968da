"""Profiling and tracing — the port of the JAX package's
`utils/profiling.py`:

  * `trace(dir)` — a `torch.profiler` context (host and, where there is one,
    the CUDA device) writing a TensorBoard-loadable trace
    (`{dir}/*.pt.trace.json`, the torch-tb-profiler layout) of the run;
  * `Timer` — accumulating wall timers that synchronise the device at the
    end of each section, so a section's time includes the work it queued;
  * `throughput` — calls per second of a callable, with its output
    optionally fed back into one of its arguments.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["trace", "Timer", "throughput", "sync"]


def sync(device=None) -> None:
    """Wait for the device's queued work (a no-op for the CPU)."""
    dev = torch.device(device) if device is not None else None
    if dev is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


class Timer:
    """Accumulating section timer; each section ends with a device sync."""

    def __init__(self, device=None):
        self.device = device
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.times.items() if v}


def throughput(fn: Callable, args, *, iters: int = 10, batch_axis_size: int = 1,
               chain_index: Optional[int] = None, device=None) -> float:
    """Items per second of `fn(*args)` (`batch_axis_size` items per call).
    With `chain_index`, each call's output replaces that positional argument
    of the next, so the calls form one dependent chain."""
    out = fn(*args)
    sync(device)
    args = list(args)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
        if chain_index is not None:
            args[chain_index] = out
    sync(device)
    dt = (time.perf_counter() - t0) / iters
    return batch_axis_size / dt
