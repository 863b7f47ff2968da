#!/usr/bin/env python3
"""Device time by the port's own spans, read from a torch.profiler trace
(`--trace_dir`'s `*.pt.trace.json`, or `export_chrome_trace`'s file):

    python3 scripts/span_table.py TRACE.json [--images N] [--top K]

Each device kernel, copy and set is tied by its correlation id to the host
call that launched it, and that call to the innermost `asyrp.*` span open on
its thread at the time. Printed per span name: the device time so tied,
which is the span's self time (what none of its child spans holds), in ms,
per image where `--images` gives the images the trace covers, and as a
share of all device time; then each name's largest kernels, each with
the operator that launched it. "(none)" holds the device work launched
outside every span. Times are the kernels' own, so the device's idle time
counts nowhere.
"""
from __future__ import annotations

import argparse
import collections
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "cpu_op"  # the port's spans, beside the operators
NONE = "(none)"


def owners(events: List[dict]) -> Dict[int, str]:
    """Correlation id of each launch -> the innermost `asyrp.*` span open on
    the launching thread at its start."""
    spans, launches = collections.defaultdict(list), collections.defaultdict(list)
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if cat == SPAN_CAT and e.get("name", "").startswith("asyrp."):
            spans[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[(e.get("pid"), e.get("tid"))].append((float(e["ts"]), args["correlation"]))
    out = {}
    for thread, calls in launches.items():
        opened = sorted(spans.get(thread, ()), key=lambda s: (s[0], -s[1]))
        stack, j = [], 0
        for ts, corr in sorted(calls):
            while j < len(opened) and opened[j][0] <= ts:
                while stack and stack[-1][1] <= opened[j][0]:
                    stack.pop()
                stack.append(opened[j])
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[corr] = stack[-1][2] if stack else NONE
    return out


def table(events: List[dict]) -> Tuple[Dict[str, float], Dict[str, collections.Counter]]:
    """(ms of device work by owning span, {span: Counter((kernel, op) -> ms)})."""
    owner = owners(events)
    ops = {e["args"]["External id"]: e.get("name", "?") for e in events
           if e.get("cat") == SPAN_CAT and "External id" in e.get("args", {})
           and not e.get("name", "").startswith("asyrp.")}
    by_span, kernels = collections.Counter(), collections.defaultdict(collections.Counter)
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            args = e.get("args", {})
            name = owner.get(args.get("correlation"), NONE)
            ms = float(e.get("dur", 0)) / 1e3
            by_span[name] += ms
            kernels[name][(e.get("name", "?"), ops.get(args.get("External id"), "?"))] += ms
    return dict(by_span), kernels


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace")
    p.add_argument("--images", type=int, default=0, help="images the trace covers")
    p.add_argument("--top", type=int, default=3, help="kernels shown per span")
    a = p.parse_args(argv)
    with open(a.trace) as f:
        events = json.load(f)["traceEvents"]
    by_span, kernels = table(events)
    total = sum(by_span.values())
    per = f"ms/image (of {a.images})" if a.images else ""
    print(f"{'span':<16} {'self ms':>12} {per:>22} {'share':>7}")
    for name, ms in sorted(by_span.items(), key=lambda kv: -kv[1]):
        img = f"{ms / a.images:22.3f}" if a.images else " " * 22
        print(f"{name:<16} {ms:12.3f} {img} {100 * ms / total:6.2f}%")
    print(f"{'all':<16} {total:12.3f}")
    for name, ms in sorted(by_span.items(), key=lambda kv: -kv[1]):
        for (k, op), kms in kernels[name].most_common(a.top):
            print(f"  {name:<16} {kms:10.3f} ms  {op:<28} {k[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
