#!/usr/bin/env python3
"""Device time per call of GroupNorm(+SiLU) (K1) and its backward (K1-bwd)
at every shape one 256^2 UNet eval gives them, on one NVIDIA GPU:

    python3 scripts/bench_groupnorm.py [--repo DIR] [--evals | --across] [--out FILE.json]

The shapes and their calls per eval come from `chip_smoke.py`'s recorders:
one edited eval (dual decode) and one training-mode eval of the full-width
DDPM++ (`custom.yml`) and AFHQ (`afhq.yml`) UNets at batch 1, f32 and bf16.
Per row: the max error relative to scale against the plain version; the
kernel's device time per call back to back behind `torch.cuda._sleep`
(`chip_smoke.device_ms`), its CUDA-event time per call (host included,
`chip_smoke.time_ms`), its device kernels per call in torch.profiler; the
library call's device time (`F.group_norm`(+`F.silu`), or autograd of it
for the backward; for a fused row the unfused composition: K1, then the
torch ops it replaces); and the bound (`chip_smoke.py` phase 3's bytes).
Then each family's sums per eval. `--repo` takes the package under test
from another checkout (e.g. a parent commit unpacked with `git archive`);
the recorders and timers stay this checkout's. `--evals` instead times
whole UNet evals (single and dual decode, f32 and bf16, both families, at
batch 1, random weights from `torch.manual_seed(0)`): wall p50 of 20 and
one eval under torch.profiler, as `chip_smoke.py` phase 6 reads them; run
it for two checkouts in one call, in turns, to compare their walls.
`--across` instead times K1 across ranks and K1-bwd across ranks (the
entries spatial sharding runs, `chip_smoke.py` phase 15) at the same
shapes with the rows split as phase 15 (c) and (e) split them: DDPM++ over
4 ranks, AFHQ over 2. One call is what a rank runs on the card: the part
kernel, the exchange's result stood in by a copy of its parts (or sums)
S times, and the apply kernel with whatever torch ops the checkout puts
between them; both designs' entries are read, so `--repo` can time the
parent's package beside this one's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fwd_rows(seen):
    """(family, shape, silu, eps, fused, calls per eval) of the forward."""
    for fam, key_name in (("custom.yml", "group_norm"), ("afhq.yml", "group_norm_afhq")):
        for key, count in sorted(seen[key_name].items(), key=str):
            shape, silu, eps, fused = (tuple(key) + (None,) * 4)[:4]
            yield fam, shape, silu, 1e-6 if eps is None else eps, fused, count


def bwd_rows(seen):
    """(family, shape, silu, weight_grad, eps, calls per train eval)."""
    for fam, key_name in (("custom.yml", "group_norm_bwd"), ("afhq.yml", "group_norm_bwd_afhq")):
        for key, count in sorted(seen[key_name].items(), key=str):
            shape, silu, wgrad, eps = (tuple(key) + (None,))[:4]
            yield fam, shape, silu, wgrad, 1e-6 if eps is None else eps, count


class _Spec:
    """The one method of a model spec that `chip_smoke.profile_phase` calls."""

    @staticmethod
    def apply(model, x, t, edit=None):
        return model.apply(x, t, edit=edit)


def eval_profiles(torch, dev, card, cs):
    """`chip_smoke.profile_phase` on the full-width DDPM++ and AFHQ UNets."""
    from asyrp_official_torch.models.ddpmpp import CELEBA_CONFIG, DDPMpp
    from asyrp_official_torch.models.delta import DeltaBlock, EditState, OpenAIDeltaBlock
    from asyrp_official_torch.models.openai_unet import AFHQ_CONFIG, OpenAIUNet

    out = {}
    for fam, cfg, net, blk, flavor in (("custom.yml", CELEBA_CONFIG, DDPMpp, DeltaBlock, "ddpm"),
                                       ("afhq.yml", AFHQ_CONFIG, OpenAIUNet, OpenAIDeltaBlock,
                                        "openai")):
        torch.manual_seed(0)
        model = net(cfg).to(dev).eval().requires_grad_(False)
        block = blk(cfg.bottleneck_ch, cfg.temb_ch).to(dev).eval().requires_grad_(False)
        edit = EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0], device=dev),
                         flavor=flavor)
        print(f"{fam}:", flush=True)
        out[fam] = cs.profile_phase(torch, dev, card, (_Spec, model, edit))
        del model, block
        torch.cuda.empty_cache()
    return out


ACROSS_RANKS = {"custom.yml": 4, "afhq.yml": 2}  # phase 15 (c) and (e): --tp_spatial 4, --sp 2


def across_calls(k1, s: int):
    """(forward, backward) factories for K1 across ranks on one rank of
    `s`, for the checkout's design: this one (the apply kernels take the
    gathered parts and the summed sums, and combine or divide in their
    prologue) or the one before it (Chan's combination and the divide as
    torch ops between the kernels). Each returns (kernel call, plain call)."""
    import inspect

    fused_combine = "parts" in inspect.signature(k1.group_norm_apply).parameters

    def fwd(x, w, b, eps, silu, kw):
        def run(part, apply):
            parts = part(x, pre_add=kw.get("pre_add"))
            gathered = parts.expand(s, *parts.shape).contiguous()
            if fused_combine:
                return apply(x, w, b, gathered, eps=eps, silu=silu, **kw)
            mean, rstd = k1.combine_group_stats(gathered, eps)
            return apply(x, w, b, mean, rstd, silu=silu, **kw)

        return (lambda: run(k1.group_norm_part_stats, k1.group_norm_apply),
                lambda: run(k1.group_norm_part_stats_plain, k1.group_norm_apply_plain))

    def bwd(x, dy, w, b, mean, rstd, count, silu):
        def run(part, apply):
            sums, wsum = part(x, dy, w, b, mean, rstd, silu=silu)
            summed = s * sums
            if fused_combine:
                return apply(x, dy, w, b, mean, rstd, summed, count, silu=silu), wsum
            return apply(x, dy, w, b, mean, rstd, summed / count, silu=silu), wsum

        return (lambda: run(k1.group_norm_bwd_part, k1.group_norm_bwd_apply),
                lambda: run(k1.group_norm_bwd_part_plain, k1.group_norm_bwd_apply_plain))

    return fwd, bwd


def across_rows(torch, cs, k1, seen, randn, add):
    """`--across`: every forward and backward shape of `seen`, its rows
    split over the family's ranks, f32 and bf16."""
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.tensor([], dtype=dtype).element_size()
        for fam, shape, silu, eps, fused, count in fwd_rows(seen):
            s = ACROSS_RANKS[fam]
            shape = (shape[0], shape[1], shape[2] // s) + tuple(shape[3:])
            bsz, c = shape[:2]
            x = (randn(*shape) * 2.0 + 0.5).to(dtype)
            w, b = 1.0 + 0.1 * randn(c), 0.1 * randn(c)
            kw, extra_bytes = {}, 0
            if fused == "pre_add":
                kw["pre_add"] = randn(bsz, c).to(dtype)
                extra_bytes = bsz * c * es
            elif fused == "scale_shift":
                kw["scale_shift"] = (0.1 * randn(bsz, 2 * c)).to(dtype)
                extra_bytes = 2 * bsz * c * es
            run_k, run_p = across_calls(k1, s)[0](x, w, b, eps, silu, kw)
            err = cs.errs(run_k().float(), run_p().float())[1]
            n = x.numel()
            b_ms, b_by = cs.bound(2 * n * es + 2 * c * 4 + extra_bytes, n * (10 + 4 * silu),
                                  cs.PEAK_FLOPS["float32"])
            row = {"family": fam, "kernel": "K1 across", "dtype": dname, "shape": list(shape),
                   "ranks": s, "silu": bool(silu), "eps": eps, "fused": fused,
                   "calls_per_eval": count, "rel_err": err, "device_ms": cs.device_ms(run_k),
                   "event_ms": cs.time_ms(run_k),
                   "device_events_per_call": cs.device_kernels_per_call(run_k)[0],
                   "library_device_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            add(row, count)
            print(f"K1 across {fam} {dname} {list(shape)} of {s} ranks silu={int(silu)} "
                  f"eps={eps:g} fused={fused} x{count}: rel err {err:.3e}; device "
                  f"{row['device_ms']:.4f} ms, event {row['event_ms']:.4f} ms, "
                  f"{fmt(row['device_events_per_call'])} device events per call; bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
        for fam, shape, silu, wgrad, eps, count in bwd_rows(seen):
            s = ACROSS_RANKS[fam]
            shape = (shape[0], shape[1], shape[2] // s) + tuple(shape[3:])
            bsz, c = shape[:2]
            x = (randn(*shape) * 2.0 + 0.5).to(dtype)
            w, b = 1.0 + 0.1 * randn(c), 0.1 * randn(c)
            dy = randn(*shape).to(dtype)
            mean, rstd = cs.gn_stats(x, eps=eps)
            count_g = s * x[0, : c // 32].numel()
            run_k, run_p = across_calls(k1, s)[1](x, dy, w, b, mean, rstd, count_g, silu)
            got, want = run_k(), run_p()
            err = max(cs.errs(got[0].float(), want[0].float())[1],
                      cs.errs(got[1], want[1])[1])
            n = x.numel()
            b_ms, b_by = cs.bound(3 * n * es + (2 + 2 * bsz) * c * 4 + 6 * bsz * 32 * 4,
                                  n * (17 + 10 * silu), cs.PEAK_FLOPS["float32"])
            row = {"family": fam, "kernel": "K1-bwd across", "dtype": dname, "shape": list(shape),
                   "ranks": s, "silu": bool(silu), "eps": eps, "calls_per_eval": count,
                   "rel_err": err, "device_ms": cs.device_ms(run_k), "event_ms": cs.time_ms(run_k),
                   "device_events_per_call": cs.device_kernels_per_call(run_k)[0],
                   "library_device_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            add(row, count)
            print(f"K1-bwd across {fam} {dname} {list(shape)} of {s} ranks silu={int(silu)} "
                  f"eps={eps:g} x{count}: rel err {err:.3e}; device {row['device_ms']:.4f} ms, "
                  f"event {row['event_ms']:.4f} ms, {fmt(row['device_events_per_call'])} device "
                  f"events per call; bound {b_ms:.4f} ms ({b_by})", flush=True)
            del got, want


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=REPO, help="take asyrp_official_torch from this checkout")
    ap.add_argument("--evals", action="store_true", help="time whole UNet evals instead")
    ap.add_argument("--across", action="store_true",
                    help="time K1 and K1-bwd across ranks (phase 15's splits) instead")
    ap.add_argument("--out", default=None, help="also write the rows as JSON here")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this benchmark needs an NVIDIA GPU")
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.repo))
    from asyrp_official_torch.ops import groupnorm as k1

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(k1.__file__))))
    if pkg_root != os.path.abspath(args.repo):
        print(f"asyrp_official_torch came from {k1.__file__}, not from {args.repo}")
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    if args.evals:
        profiles = eval_profiles(torch, dev, card, cs)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"card": card, "repo": os.path.abspath(args.repo),
                           "profiles": profiles}, f, indent=1)
        return 0
    seen = {**cs.record_path_shapes(torch, dev), **cs.record_afhq_shapes(torch, dev)}
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    out, sums = [], {}

    def add(row, count):
        out.append(row)
        key = f"{row['family']} {row['kernel']} {row['dtype']}"
        s = sums.setdefault(key, {"calls": 0})
        s["calls"] += count
        for k in ("device_ms", "event_ms", "library_device_ms", "bound_ms"):
            if row.get(k) is not None:
                s[k] = s.get(k, 0.0) + row[k] * count

    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    for dtype in (torch.float32, torch.bfloat16) if not args.across else ():
        dname = str(dtype).split(".")[-1]
        es = torch.tensor([], dtype=dtype).element_size()
        for fam, shape, silu, eps, fused, count in fwd_rows(seen):
            bsz, c = shape[:2]
            x = (randn(*shape) * 2.0 + 0.5).to(dtype)
            w, b = 1.0 + 0.1 * randn(c), 0.1 * randn(c)
            wl, bl = w.to(dtype), b.to(dtype)
            kw = dict(eps=eps, silu=silu)
            extra_bytes = 0
            if fused == "pre_add":
                kw["pre_add"] = randn(bsz, c).to(dtype)
                extra_bytes = bsz * c * es
            elif fused == "scale_shift":
                kw["scale_shift"] = (0.1 * randn(bsz, 2 * c)).to(dtype)
                extra_bytes = 2 * bsz * c * es
            run_k = lambda: k1.group_norm(x, w, b, **kw)
            if fused:
                run_l = lambda: k1.group_norm_unfused(x, w, b, **kw)
            else:
                run_l = lambda: (F.silu(F.group_norm(x, 32, wl, bl, eps)) if silu
                                 else F.group_norm(x, 32, wl, bl, eps))
            err = cs.errs(run_k().float(), k1.group_norm_plain(x, w, b, **kw).float())[1]
            n = x.numel()
            b_ms, b_by = cs.bound(2 * n * es + 2 * c * 4 + extra_bytes, n * (8 + 4 * silu),
                                  cs.PEAK_FLOPS["float32"])
            row = {"family": fam, "kernel": "K1", "dtype": dname, "shape": list(shape),
                   "silu": bool(silu), "eps": eps, "fused": fused, "calls_per_eval": count,
                   "rel_err": err, "device_ms": cs.device_ms(run_k), "event_ms": cs.time_ms(run_k),
                   "device_events_per_call": cs.device_kernels_per_call(run_k)[0],
                   "library_device_ms": cs.device_ms(run_l), "bound_ms": b_ms, "bound_by": b_by}
            add(row, count)
            print(f"K1 {fam} {dname} {list(shape)} silu={int(silu)} eps={eps:g} fused={fused} "
                  f"x{count}: rel err {err:.3e}; device {row['device_ms']:.4f} ms, event "
                  f"{row['event_ms']:.4f} ms, {fmt(row['device_events_per_call'])} device events "
                  f"per call; library {row['library_device_ms']:.4f} ms; bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
        for fam, shape, silu, wgrad, eps, count in bwd_rows(seen):
            c = shape[1]
            x = (randn(*shape) * 2.0 + 0.5).to(dtype)
            w, b = 1.0 + 0.1 * randn(c), 0.1 * randn(c)
            dy = randn(*shape).to(dtype)
            mean, rstd = cs.gn_stats(x, eps=eps)
            run_k = lambda: k1.group_norm_backward(x, dy, w, b, mean, rstd, silu=silu,
                                                   weight_grad=wgrad)
            got = run_k()
            want = k1.group_norm_backward_plain(x, dy, w, b, mean, rstd, silu=silu,
                                                weight_grad=wgrad)
            err = max(cs.errs(g_.float(), w_.float())[1] for g_, w_ in zip(got, want)
                      if g_ is not None)
            xl = x.clone().requires_grad_()
            wl = w.to(dtype).requires_grad_(wgrad)
            bl = b.to(dtype).requires_grad_(wgrad)
            y_lib = F.group_norm(xl, 32, wl, bl, eps)
            y_lib = F.silu(y_lib) if silu else y_lib
            ins = (xl, wl, bl) if wgrad else (xl,)
            run_l = lambda: torch.autograd.grad(y_lib, ins, dy, retain_graph=True)
            n = x.numel()
            b_ms, b_by = cs.bound(3 * n * es + (4 if wgrad else 2) * c * 4,
                                  n * (14 + 10 * silu + 3 * wgrad), cs.PEAK_FLOPS["float32"])
            row = {"family": fam, "kernel": "K1-bwd", "dtype": dname, "shape": list(shape),
                   "silu": bool(silu), "weight_grad": bool(wgrad), "eps": eps,
                   "calls_per_eval": count, "rel_err": err, "device_ms": cs.device_ms(run_k),
                   "event_ms": cs.time_ms(run_k),
                   "device_events_per_call": cs.device_kernels_per_call(run_k)[0],
                   "library_device_ms": cs.device_ms(run_l), "bound_ms": b_ms, "bound_by": b_by}
            add(row, count)
            print(f"K1-bwd {fam} {dname} {list(shape)} silu={int(silu)} dweight={int(wgrad)} "
                  f"eps={eps:g} x{count}: rel err {err:.3e}; device {row['device_ms']:.4f} ms, "
                  f"event {row['event_ms']:.4f} ms, {fmt(row['device_events_per_call'])} device "
                  f"events per call; library {row['library_device_ms']:.4f} ms; bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
            del y_lib, got, want
    if args.across:
        across_rows(torch, cs, k1, seen, randn, add)
    for key, s in sums.items():
        lib = s.get("library_device_ms")
        print(f"per eval, {key}: {s['calls']} calls; device {s['device_ms']:.3f} ms, event "
              f"{s['event_ms']:.3f} ms, library {'none' if lib is None else f'{lib:.3f} ms'}, "
              f"bound {s['bound_ms']:.3f} ms", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "repo": os.path.abspath(args.repo), "rows": out,
                       "per_eval": sums}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
