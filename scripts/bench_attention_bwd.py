#!/usr/bin/env python3
"""Device time per call of the attention backward (K2-bwd, K2-bwd-MH)
against SDPA's backward and the bound, on one NVIDIA GPU:

    python3 scripts/bench_attention_bwd.py [--out chiprun_out/bench_attention_bwd.json]

Rows: one head at [1,256,512] (DDPM++ training) and [1,1024,512]; 8 heads
of 64 with the legacy scale at [1,256,512] (AFHQ training), [1,64,512],
[1,1024,512] and [1,4096,512]; f32 and bf16. Per row: the kernel's
and SDPA's backward's device time per call, run back to back behind
`torch.cuda._sleep` (`chip_smoke.device_ms`, gaps between launches
included), and the sum of their device events in torch.profiler
(`chip_smoke.profiled_device_ms`, no gaps); the bound (bytes or
operations, as `chip_smoke.py` phase 3 counts them), and the max error relative to
scale against autograd through the plain forward.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (((1, 256, 512), 1, False), ((1, 1024, 512), 1, False), ((1, 256, 512), 8, True),
        ((1, 64, 512), 8, True), ((1, 1024, 512), 8, True), ((1, 4096, 512), 8, True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the rows as JSON here")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this benchmark needs an NVIDIA GPU")
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from asyrp_official_torch.ops import attention as k2

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.tensor([], dtype=dtype).element_size()
        for shape, heads, legacy in ROWS:
            kw = dict(num_heads=heads, legacy_scale=legacy)
            q, k, v, d_o = (torch.randn(*shape, generator=gen, device=dev).to(dtype)
                            for _ in range(4))
            qg, kg, vg = (a.clone().requires_grad_() for a in (q, k, v))
            want = torch.autograd.grad(k2.attention_plain(qg, kg, vg, **kw), (qg, kg, vg), d_o)
            o, lse = k2._attention_cuda(q, k, v, True, heads, legacy)
            got = k2.attention_backward(q, k, v, o, d_o, lse, **kw)
            err = max(cs.errs(g.float(), w.float())[1] for g, w in zip(got, want))
            bsz, t_len, c = shape
            hd = c // heads
            q4, k4, v4, do4 = (a.view(bsz, t_len, heads, hd).transpose(1, 2)
                               for a in (qg, kg, vg, d_o))
            o_lib = F.scaled_dot_product_attention(q4, k4, v4, scale=hd ** -0.5)
            lib = lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do4, retain_graph=True)
            run_k = lambda: k2.attention_backward(q, k, v, o, d_o, lse, **kw)
            kernel_ms, kernel_prof_ms = cs.device_ms(run_k), cs.profiled_device_ms(run_k)
            sdpa_ms, sdpa_b2b_ms = cs.profiled_device_ms(lib), cs.device_ms(lib)
            b_ms, b_by = cs.bound(8 * bsz * t_len * c * es + 4 * bsz * heads * t_len,
                                  10 * bsz * t_len * t_len * c, cs.PEAK_FLOPS[dname])
            row = {"shape": list(shape), "heads": heads, "legacy_scale": legacy, "dtype": dname,
                   "rel_err": err, "device_ms": kernel_ms, "profiled_ms": kernel_prof_ms,
                   "sdpa_bwd_profiled_ms": sdpa_ms, "sdpa_bwd_device_ms": sdpa_b2b_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            out.append(row)
            fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
            print(f"{dname} {list(shape)} heads={heads}: rel err {err:.3e}; kernel {kernel_ms:.4f} "
                  f"ms back to back, {fmt(kernel_prof_ms)} profiled; SDPA backward "
                  f"{sdpa_b2b_ms:.4f} ms back to back, {fmt(sdpa_ms)} profiled; bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
            del want, got, o_lib
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
