#!/usr/bin/env python3
"""One plain UNet eval of the full-width CelebA-HQ DDPM++ (`custom.yml`,
random weights of seed 1234) per batch size, on one NVIDIA GPU:

    python3 scripts/bench_batch_evals.py

Batch 1, 2, 4, 9 and 18 (18: the stacked dual decode of a 9-coefficient
sweep at batch 1), f32 with TF32 off (as the port's runner sets it) and
bf16 (the input cast, the weights cast per call, as `--bf16` runs): the
wall p50 of 3 evals after one warm-up, ending in a device sync; the device
time of one eval under torch.profiler with its device kernel count; its
three kernels of the most device time; and its five convolution input
shapes of the most device time. Then f32 at batch 2 and 9 again with
cuDNN's benchmark mode over all its engines (`torch.backends.cudnn.benchmark`,
`benchmark_limit = 0`) in place of its heuristics. Prints the card
(`nvidia-smi` name and power limit) and one JSON line of the rows.
"""
from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (1, 2, 4, 9, 18)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from asyrp_official_torch.cli.main import load_config
    from asyrp_official_torch.models.registry import spec_from_config
    from asyrp_official_torch.utils import hostrng

    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    spec = spec_from_config(load_config("custom.yml"))
    model = spec.build()
    model.load_state_dict(spec.state_dict_from_jax(spec.init(hostrng.PRNGKey(1234))))
    model = model.to(dev).eval().requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(max(BATCHES), 256, 256, 3, generator=g, device=dev)
    t = torch.full((max(BATCHES),), 999.0, device=dev)
    rows = []
    runs = [(torch.float32, b, False) for b in BATCHES] + [
        (torch.bfloat16, b, False) for b in BATCHES] + [(torch.float32, b, True) for b in (2, 9)]
    for dtype, b, bench in runs:
        torch.backends.cudnn.benchmark = bench
        torch.backends.cudnn.benchmark_limit = 0 if bench else 10

        @torch.no_grad()
        def ev():
            return spec.apply(model, x[:b].to(dtype), t[:b])[0]

        ev()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            ev()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            ev()
            torch.cuda.synchronize()
        kern = sorted(((e.key, e.device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_time_total > 0 and e.device_type.name == "CUDA"),
                      key=lambda r: -r[1])
        convs = sorted(((str(e.input_shapes[:2]), e.device_time_total / 1e3, e.count)
                        for e in prof.key_averages(group_by_input_shape=True)
                        if e.key == "aten::convolution"), key=lambda r: -r[1])
        row = {"dtype": str(dtype).split(".")[-1], "batch": b, "cudnn_benchmark": bench,
               "wall_ms_p50": sorted(walls)[1], "device_ms": sum(r[1] for r in kern),
               "device_kernels": sum(r[2] for r in kern),
               "top": [{"kernel": k[:100], "ms": ms, "count": c} for k, ms, c in kern[:3]],
               "convs": [{"input, weight": k, "ms": ms, "count": c}
                         for k, ms, c in convs[:5]]}
        rows.append(row)
        mode = ", cudnn benchmark" if bench else ""
        print(f"{row['dtype']} bs {b}{mode}: wall p50 {row['wall_ms_p50']:.1f} ms, device "
              f"{row['device_ms']:.1f} ms in {row['device_kernels']} kernels; top: "
              + "; ".join(f"{r['ms']:.1f} ms x{r['count']} {r['kernel'][:60]}"
                          for r in row["top"]), flush=True)
        print("    convolutions: " + "; ".join(
            f"{c['ms']:.1f} ms x{c['count']} {c['input, weight']}" for c in row["convs"]),
            flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
