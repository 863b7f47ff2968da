#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels K1 (GroupNorm+SiLU, with K1-bwd) and K2
     (attention with one head or several, with K2-bwd) with nvcc for
     sm_90a, one nvcc per source, all started together; K3 (DDIM step,
     Triton) compiles at its first launch. Per attention entry (forward and
     backward, f32 and bf16) its HGMMA / HMMA count, registers and spills:
     a bf16 entry without HGMMA (wgmma) or an f32 one without HMMA
     (mma.sync) fails;
  3. each kernel against its plain PyTorch version on the card, in float32
     and bfloat16: the forwards at every shape the serving path gives them
     (recorded from one edited UNet eval of the full-width CelebA-HQ DDPM++
     UNet), the backwards at every shape the training path gives them
     (recorded from one training-mode eval: the edited decode and the
     DeltaBlock) against `torch.autograd.grad` through the plain forward.
     Per row: median CUDA-event times of the kernel, the plain version and
     the one PyTorch call that computes the same function, their device
     times per call run back to back, and the bound (the least time the
     card could take for the row's bytes or operations). The K2-bwd rows
     also run off the path (count 0: ragged T, batch 8, T = 1024 with one
     head, T = 4096 with 8), read SDPA's backward from torch.profiler and
     check that two calls agree bit for bit;
  4. the serving path through the port's CLI, in-process: `--run_test` on
     `custom.yml` (256^2, 113.7M params, random weights from --seed), two
     random 256^2 images and a seeded DeltaBlock checkpoint, 40-step
     inversion + 40-step edited generation at batch 1, once in float32 and
     once with --bf16; the kernels' launch counters are zeroed just before
     each run and must all be > 0 after it;
  5. the float32 serving chain (inversion + edit) run with the kernels and
     with the plain versions on the card, from the same image and noise,
     compared scale-relatively;
  6. where the time goes in one UNet eval at batch 1 (single and dual
     decode, float32 and bfloat16): torch.profiler device time by kernel
     family, kernel count, and the device's idle share;
  7. the training path through the port's CLI, in-process: `--run_train
     --train_delta_block` on `custom.yml` with the CLIP directional loss (a
     random ViT-B/16 written by the port's CLIP module) and the L1 term, two
     random images, 40-step grids, t_edit 513, 2 iterations at batch 1, then
     the `--do_test` grid; once in float32 and once with --bf16. The launch
     counters (forward and backward) are zeroed just before each run and
     must all be > 0 after it. The float32 run is repeated from the same
     latents with the plain versions: the trained DeltaBlock held to 1e-3
     and its update from the init to 5e-2 (max error over the whole block
     relative to its largest value). The gate of the backward kernels is
     one edited timestep's gradient with respect to the DeltaBlock (through
     K1-bwd, K2-bwd and K3's backward), kernels vs plain versions per leaf:
     1e-3 in float32 (which must catch two planted 1% faults in K1-bwd);
     in bfloat16 the kernels' gradient may be at most 2x as far from the
     float32 one as the plain versions' bfloat16 gradient is. Also the L1
     term per dtype (how much of the bf16 loss is rounding), and one edited
     timestep's launches and torch.profiler breakdown per dtype.
  8. the OpenAI-family serving path (iDDPM AFHQ/FFHQ, `afhq.yml`: 256^2,
     93.6M params, 8-head attention at 16^2 and 8^2, learn_sigma) through
     the port's CLI, in-process: a perturbed AFHQ `.pt` state dict under the
     reference key names (the seeded init's all-zero output layers redrawn,
     so eps is far from zero), two random 256^2 images as
     `afhq/test/dog/*.png` and an OpenAI-flavor Δ checkpoint; `--run_test
     --model_path <that .pt>`, 40 + 40 steps at batch 1, float32 and
     --bf16, then 10 + 10 steps of `--sample_type ddpm` in float32. K1, the
     multi-head K2 and K3 (and `ddpm_step` in the ddpm run) must launch;
     then the float32 AFHQ invert+edit chain with the kernels against the
     plain versions, and where the time goes in one AFHQ eval (as in 6).
     Phase 3 also holds K1 at eps 1e-5, the multi-head K2 (and at T = 1024,
     IMAGENET's 32^2 level), K3 on the strided learn_sigma channels and
     `ddpm_step` against their plain versions at the AFHQ path's shapes;
     and, at the AFHQ training path's shapes (recorded from one
     training-mode eval), K1-bwd at eps 1e-5 with and without SiLU and
     K2-bwd-MH (the multi-head legacy-scale attention backward, 8 heads of
     64, at T = 256, 64 and 1024) against `torch.autograd.grad` through the
     plain forward, with a control: the backward read as one head must be
     far off;
  9. the OpenAI-family training path through the port's CLI, in-process:
     `--run_train --train_delta_block --edit_attr dog_smiling` on
     `afhq.yml` from phase 8's perturbed `.pt`, with the CLIP directional
     loss (the random ViT-B/16 of phase 7) and the L1 term, two random
     images as `afhq/train/dog/*.png`, 40-step grids, t_edit 513, 2
     iterations at batch 1, then the `--do_test` grid; float32 and --bf16.
     The launch counters are zeroed just before each run and read just
     after: K1, K1-bwd, the multi-head K2 and K2-bwd-MH, and K3 must all
     have launched, the single-head K2 and K2-bwd not at all. The gate of
     K2-bwd-MH is phase 7's gradient check on the AFHQ UNet (1e-3 float32,
     2x in bfloat16), where the cotangents reaching K2-bwd-MH must have a
     norm above 0 and a planted fault (D summed over all C instead of the
     head's d) must fail it.
The float32 runs use full float32 convolutions and matmuls (TF32 off), as
the port's runner sets it on CUDA.

Needs a CUDA device and this repository around the script. Prints the
`nvidia-smi` line and a JSON line of per-kernel results before the last
line, which is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import concurrent.futures
import glob
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 40
CONFIG, IMAGE, DEVICE = "custom.yml", 256, "cuda"
AFHQ_CONFIG, DDPM_STEPS = "afhq.yml", 10
T_EDIT, T_ADDNOISE = 513, 167
SEED = 1234
TOL = {"group_norm": {"float32": 1e-5, "bfloat16": 2e-2},
       "attention": {"float32": 1e-5, "bfloat16": 2e-2},
       "group_norm_afhq": {"float32": 1e-5, "bfloat16": 2e-2},
       "attention_mh": {"float32": 1e-5, "bfloat16": 2e-2},
       "group_norm_bwd": {"float32": 1e-4, "bfloat16": 5e-2},
       "attention_bwd": {"float32": 1e-4, "bfloat16": 5e-2},
       "group_norm_bwd_afhq": {"float32": 1e-4, "bfloat16": 5e-2},
       "attention_bwd_mh": {"float32": 1e-4, "bfloat16": 5e-2},
       "ddim_step": {"float32": 1e-6}, "ddim_step_learn_sigma": 1e-6,
       "ddpm_step": 1e-6}
# the OpenAI UNet's eps on perturbed weights must be far from zero, or its
# comparisons would hold zeros against zeros
MIN_EPS_STD = 0.1
# the multi-head K2 against the one-head plain version: a control that the
# row's comparison sees a wrong head split
CONTROL_MIN = 1e-2
TRAIN_KERNELS = ("group_norm", "group_norm_bwd", "attention", "attention_bwd", "ddim_step")
AFHQ_TRAIN_KERNELS = ("group_norm", "group_norm_bwd", "attention_mh", "attention_mh_bwd",
                      "ddim_step")
AFHQ_ATTR = "dog_smiling"  # an AFHQ attribute of assets/src_trg_prompts.json
CHAIN_TOL = 1e-3
# the f32 trained block, kernels vs plain run: the whole block, and its update
# from the init (which the L1 term's sign makes noisy, see train_phase)
TRAIN_TOL, UPDATE_TOL = 1e-3, 5e-2
# one timestep's gradient w.r.t. the DeltaBlock, per leaf: float32 kernels vs
# plain; bf16 kernels no farther from the float32 gradient than this many
# times the plain versions in bf16 are (bf16 rounding, amplified by x0_t's
# 1/sqrt(a_t) at t=999, sets the floor)
GRAD_TOL, BF16_GRAD_FACTOR = 1e-3, 2.0
# NVIDIA H100 SXM data sheet: HBM3 bytes/s; dense FLOP/s of float32 on the
# CUDA cores (TF32 off) and of bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
DTYPES = ("float32", "bfloat16")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(msg: str) -> None:
    print(msg, flush=True)


def errs(a, b):
    """(max |a - b|, max |a - b| / max |b|), in float64 on the host."""
    a, b = a.double().cpu(), b.double().cpu()
    d = float((a - b).abs().max())
    return d, d / max(float(b.abs().max()), 1e-30)


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs: int = 20) -> float:
    """Device time per call, back to back: `torch.cuda._sleep` holds the
    stream while the host queues `runs` calls behind it, so the CUDA events
    around them time the device alone, without the host's time between
    launches (which `time_ms` includes). The sleep is lengthened until the
    host has queued every call before it ends."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if queued_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / runs
        cycles *= 4
    fail("the host could not queue the timed calls within the device's sleep")


def profiled_device_ms(fn, runs: int = 10):
    """Device time per call from torch.profiler's device events (kernels and
    copies): for a call whose host time is not the kernels' own, e.g. the
    autograd engine's backward of SDPA. A profile that records no device
    event is repeated, at most twice; then None (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
        if busy > 0.0:
            return busy / runs / 1e3
    return None


def bound(n_bytes: float, n_flops: float, flops_per_s: float):
    """(ms, "bytes" | "operations"): the larger of bytes over the memory rate
    and operations over the peak rate."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def counters():
    from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1
    from asyrp_official_torch.ops import ddpm_step as kddpm

    return {"group_norm": k1.group_norm.launches, "group_norm_bwd": k1.group_norm.bwd_launches,
            "attention": k2.attention.launches, "attention_mh": k2.attention.mh_launches,
            "attention_bwd": k2.attention.bwd_launches,
            "attention_mh_bwd": k2.attention.mh_bwd_launches, "ddim_step": k3.ddim_step.launches,
            "ddpm_step": kddpm.ddpm_step.launches}


def zero_counters() -> None:
    from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1
    from asyrp_official_torch.ops import ddpm_step as kddpm

    k1.group_norm.launches = k1.group_norm.bwd_launches = 0
    k2.attention.launches = k2.attention.mh_launches = k2.attention.bwd_launches = 0
    k2.attention.mh_bwd_launches = 0
    k3.ddim_step.launches = kddpm.ddpm_step.launches = 0


def require_launches(counts, names, what: str) -> None:
    if not all(counts[n] for n in names):
        fail(f"{what} did not launch every kernel of its path {list(names)}: {counts}")


def plain_versions():
    """Every kernel's wrapper replaced by its plain version (autograd then
    differentiates the plain forward)."""
    from contextlib import ExitStack
    from unittest import mock

    from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1
    from asyrp_official_torch.ops import ddpm_step as kddpm

    stack = ExitStack()
    stack.enter_context(mock.patch.object(k1, "group_norm", k1.group_norm_plain))
    stack.enter_context(mock.patch.object(k2, "attention", k2.attention_plain))
    stack.enter_context(mock.patch.object(k3, "ddim_step", k3.ddim_step_plain))
    stack.enter_context(mock.patch.object(kddpm, "ddpm_step", kddpm.ddpm_step_plain))
    return stack


def record_path_shapes(torch, dev):
    """Shapes and call counts each kernel sees in one edited UNet eval at
    batch 1 (dual decode, the serving path) and in one training-mode eval
    (split decode with a trained DeltaBlock): the forward calls, and the
    calls whose input or weight needs a gradient. The plain versions stand
    in while recording."""
    from unittest import mock

    from asyrp_official_torch.models.ddpmpp import CELEBA_CONFIG, DDPMpp
    from asyrp_official_torch.models.delta import DeltaBlock, EditState
    from asyrp_official_torch.ops import attention as k2, groupnorm as k1

    seen = {"group_norm": {}, "attention": {}, "group_norm_bwd": {}, "attention_bwd": {},
            "train_group_norm": 0, "train_attention": 0}
    training = [False]

    def bump(key, k):
        seen[key][k] = seen[key].get(k, 0) + 1

    def gn(x, w, b, **kw):
        if training[0]:
            seen["train_group_norm"] += 1
            if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
                bump("group_norm_bwd", (tuple(x.shape), kw.get("silu", False), w.requires_grad))
        else:
            bump("group_norm", (tuple(x.shape), kw.get("silu", False)))
        return k1.group_norm_plain(x, w, b, **kw)

    def attn(q, k, v):
        if training[0]:
            seen["train_attention"] += 1
            if torch.is_grad_enabled() and q.requires_grad:
                bump("attention_bwd", tuple(q.shape))
        else:
            bump("attention", tuple(q.shape))
        return k2.attention_plain(q, k, v)

    torch.manual_seed(0)
    model = DDPMpp(CELEBA_CONFIG).to(dev).eval().requires_grad_(False)
    block = DeltaBlock(CELEBA_CONFIG.bottleneck_ch, CELEBA_CONFIG.temb_ch).to(dev)
    edit = EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0], device=dev))
    x = torch.randn(1, IMAGE, IMAGE, 3, device=dev)
    t = torch.full((1,), 500.0, device=dev)
    with mock.patch.object(k1, "group_norm", gn), mock.patch.object(k2, "attention", attn):
        with torch.no_grad():
            model.apply(x, t, edit=edit)
        training[0] = True
        model.apply(x, t, edit=edit, decode_mode="split")
    # shapes off the eval (count 0): ragged T, batch 8, T = 1024
    for shape in ((1, 200, 512), (8, 256, 512), (1, 1024, 512)):
        seen["attention"][shape] = 0
    for shape in ((1, 200, 512), (2, 100, 512), (8, 256, 512), (1, 1024, 512)):
        seen["attention_bwd"].setdefault(shape, 0)
    del model, block
    torch.cuda.empty_cache()
    return seen


def record_afhq_shapes(torch, dev):
    """Shapes and call counts K1 and K2 see in one edited eval of the
    full-width AFHQ UNet at batch 1 (the split dual decode, as served) and
    in one training-mode eval (split decode with a trained OpenAI
    DeltaBlock): the forward calls, and the calls whose input or weight
    needs a gradient; and IMAGENET's 32^2 attention (T = 1024), checked
    though not run here, and the 8^2 middle-block attention's backward (the
    training path runs the encoder without grad). The plain versions stand
    in while recording."""
    from unittest import mock

    from asyrp_official_torch.models.delta import EditState, OpenAIDeltaBlock
    from asyrp_official_torch.models.openai_unet import AFHQ_CONFIG, OpenAIUNet
    from asyrp_official_torch.ops import attention as k2, groupnorm as k1

    seen = {"group_norm_afhq": {}, "attention_mh": {}, "group_norm_bwd_afhq": {},
            "attention_bwd_mh": {}, "train_group_norm_afhq": 0, "train_attention_mh": 0}
    training = [False]

    def bump(key, k):
        seen[key][k] = seen[key].get(k, 0) + 1

    def gn(x, w, b, **kw):
        silu, eps = kw.get("silu", False), kw.get("eps", 1e-6)
        if not training[0]:
            bump("group_norm_afhq", (tuple(x.shape), silu, eps))
        else:
            seen["train_group_norm_afhq"] += 1
            if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
                bump("group_norm_bwd_afhq", (tuple(x.shape), silu, w.requires_grad, eps))
        return k1.group_norm_plain(x, w, b, **kw)

    def attn(q, k, v, num_heads=1, legacy_scale=False):
        if not training[0]:
            bump("attention_mh", (tuple(q.shape), num_heads, legacy_scale))
        else:
            seen["train_attention_mh"] += 1
            if torch.is_grad_enabled() and q.requires_grad:
                bump("attention_bwd_mh", (tuple(q.shape), num_heads, legacy_scale))
        return k2.attention_plain(q, k, v, num_heads=num_heads, legacy_scale=legacy_scale)

    torch.manual_seed(0)
    cfg = AFHQ_CONFIG
    model = OpenAIUNet(cfg).to(dev).eval().requires_grad_(False)
    block = OpenAIDeltaBlock(cfg.bottleneck_ch, cfg.temb_ch).to(dev).eval().requires_grad_(False)
    edit = EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0], device=dev),
                     flavor="openai")
    x = torch.randn(1, IMAGE, IMAGE, 3, device=dev)
    t = torch.full((1,), 500.0, device=dev)
    with mock.patch.object(k1, "group_norm", gn), mock.patch.object(k2, "attention", attn):
        with torch.no_grad():
            model.apply(x, t, edit=edit)
        training[0] = True
        block.train().requires_grad_(True)
        model.apply(x, t, edit=edit, decode_mode="split")
    # shapes off the eval (count 0): IMAGENET's 32^2 level, ragged T, batch 8
    for shape in ((1, 1024, 512), (2, 100, 512), (8, 256, 512)):
        seen["attention_mh"][(shape, 8, True)] = 0
    for shape in ((1, 64, 512), (1, 1024, 512), (2, 100, 512), (1, 200, 512), (8, 256, 512),
                  (1, 4096, 512)):
        seen["attention_bwd_mh"].setdefault((shape, 8, True), 0)
    del model, block
    torch.cuda.empty_cache()
    return seen


def gn_stats(x, groups: int = 32, eps: float = 1e-6):
    """Per-(sample, group) mean and rstd, the statistics K1-bwd reads."""
    import torch

    var, mean = torch.var_mean(x.float().reshape(x.shape[0], groups, -1), dim=2, unbiased=False)
    return mean, (var + eps).rsqrt()


def kernel_rows(torch, dev, seen):
    """Phase 3: every row's check and times. Returns {kernel: {dtype: {...}}}
    with per-eval sums (a row's time times its calls per eval)."""
    import torch.nn.functional as F

    from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1
    from asyrp_official_torch.ops import ddpm_step as kddpm

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    names = [n for n in ("group_norm", "group_norm_bwd", "attention", "attention_bwd",
                         "group_norm_afhq", "attention_mh", "group_norm_bwd_afhq",
                         "attention_bwd_mh") if n in seen]
    out = {n: {} for n in names + ["ddim_step", "ddim_step_learn_sigma", "ddpm_step"]}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.tensor([], dtype=dtype).element_size()
        for name in names:
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0, "max_rel_err": 0.0, "calls": 0}
            bound_ms_by = {"bytes": 0.0, "operations": 0.0}
            for key, count in sorted(seen[name].items()):
                if name in ("group_norm", "group_norm_afhq"):
                    shape, silu, gn_eps = key if len(key) == 3 else (*key, 1e-6)
                    x = (randn(*shape) * 2.0 + 0.5).to(dtype)
                    w, b = 1.0 + 0.1 * randn(shape[1]), 0.1 * randn(shape[1])
                    wl, bl = w.to(dtype), b.to(dtype)
                    run_k = lambda: k1.group_norm(x, w, b, eps=gn_eps, silu=silu)
                    run_p = lambda: k1.group_norm_plain(x, w, b, eps=gn_eps, silu=silu)
                    lib = lambda: (F.silu(F.group_norm(x, 32, wl, bl, gn_eps)) if silu
                                   else F.group_norm(x, 32, wl, bl, gn_eps))
                    got, want = [run_k()], [run_p()]
                    n = x.numel()
                    b_ms, b_by = bound(2 * n * es + 2 * shape[1] * 4, n * (8 + 4 * silu),
                                       PEAK_FLOPS["float32"])
                    label = f"{list(shape)} silu={int(silu)} eps={gn_eps:g}"
                elif name in ("group_norm_bwd", "group_norm_bwd_afhq"):
                    shape, silu, wgrad, gn_eps = key if len(key) == 4 else (*key, 1e-6)
                    x = (randn(*shape) * 2.0 + 0.5).to(dtype).requires_grad_()
                    w = (1.0 + 0.1 * randn(shape[1])).requires_grad_(wgrad)
                    b = (0.1 * randn(shape[1])).requires_grad_(wgrad)
                    dy = randn(*shape, dtype=dtype)
                    ins = (x, w, b) if wgrad else (x,)
                    want = torch.autograd.grad(
                        k1.group_norm_plain(x, w, b, eps=gn_eps, silu=silu), ins, dy)
                    got = torch.autograd.grad(k1.group_norm(x, w, b, eps=gn_eps, silu=silu), ins,
                                              dy)
                    mean, rstd = gn_stats(x.detach(), eps=gn_eps)
                    xd = x.detach()
                    run_k = lambda: k1.group_norm_backward(xd, dy, w, b, mean, rstd, silu=silu,
                                                           weight_grad=wgrad)
                    run_p = lambda: k1.group_norm_backward_plain(xd, dy, w, b, mean, rstd,
                                                                 silu=silu, weight_grad=wgrad)
                    wl = w.detach().to(dtype).requires_grad_(wgrad)
                    bl = b.detach().to(dtype).requires_grad_(wgrad)
                    y_lib = F.group_norm(x, 32, wl, bl, gn_eps)
                    y_lib = F.silu(y_lib) if silu else y_lib
                    ins_lib = (x, wl, bl) if wgrad else (x,)
                    lib = lambda: torch.autograd.grad(y_lib, ins_lib, dy, retain_graph=True)
                    n = x.numel()
                    b_ms, b_by = bound(3 * n * es + (4 if wgrad else 2) * shape[1] * 4,
                                       n * (14 + 10 * silu + 3 * wgrad), PEAK_FLOPS["float32"])
                    label = f"{list(shape)} silu={int(silu)} dweight={int(wgrad)} eps={gn_eps:g}"
                elif name in ("attention", "attention_mh"):
                    shape, heads, legacy = key if name == "attention_mh" else (key, 1, False)
                    q, kk, v = (randn(*shape, dtype=dtype) for _ in range(3))
                    bsz, t_len, c = shape
                    hd = c // heads
                    kw = dict(num_heads=heads, legacy_scale=legacy)
                    run_k = lambda: k2.attention(q, kk, v, **kw)
                    run_p = lambda: k2.attention_plain(q, kk, v, **kw)
                    # the library call: [B, H, T, d] views, scale d^-0.5 on unscaled q, k
                    q4, k4, v4 = (a.view(bsz, t_len, heads, hd).transpose(1, 2)
                                  for a in (q, kk, v))
                    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=hd ** -0.5)
                    # o from the wrapper, then o and the lse K2-bwd reads from the
                    # with-lse launch, against the plain version's
                    o_p, lse_p = k2._plain_with_lse(q, kk, v, heads, legacy)
                    got = [run_k(), *k2._attention_cuda(q, kk, v, True, heads, legacy)]
                    want = [o_p, o_p, lse_p]
                    parts = ("o", "o (with lse)", "lse")
                    b_ms, b_by = bound(4 * bsz * t_len * c * es, 4 * bsz * t_len * t_len * c,
                                       PEAK_FLOPS[dname])
                    label = (f"{list(shape)}" if name == "attention"
                             else f"{list(shape)} heads={heads} legacy_scale={int(legacy)}")
                else:  # attention_bwd, attention_bwd_mh
                    shape, heads, legacy = key if name == "attention_bwd_mh" else (key, 1, False)
                    kw = dict(num_heads=heads, legacy_scale=legacy)
                    q, kk, v = (randn(*shape, dtype=dtype).requires_grad_() for _ in range(3))
                    d_o = randn(*shape, dtype=dtype)
                    bsz, t_len, c = shape
                    hd = c // heads
                    want = torch.autograd.grad(k2.attention_plain(q, kk, v, **kw), (q, kk, v), d_o)
                    got = torch.autograd.grad(k2.attention(q, kk, v, **kw), (q, kk, v), d_o)
                    qd, kd, vd = q.detach(), kk.detach(), v.detach()
                    o, lse = k2._plain_with_lse(qd, kd, vd, heads, legacy)
                    run_k = lambda: k2.attention_backward(qd, kd, vd, o, d_o, lse, **kw)
                    run_p = lambda: k2.attention_backward_plain(qd, kd, vd, o, d_o, lse, **kw)
                    # the library call: autograd of SDPA on [B, H, T, d] views (scale d^-0.5
                    # on unscaled q, k: the same function)
                    q4, k4, v4, do4 = (a.view(bsz, t_len, heads, hd).transpose(1, 2)
                                       for a in (q, kk, v, d_o))
                    o_lib = F.scaled_dot_product_attention(q4, k4, v4, scale=hd ** -0.5)
                    lib = lambda: torch.autograd.grad(o_lib, (q, kk, v), do4, retain_graph=True)
                    parts = ("dq", "dk", "dv")
                    b_ms, b_by = bound(8 * bsz * t_len * c * es + 4 * bsz * heads * t_len,
                                       10 * bsz * t_len * t_len * c, PEAK_FLOPS[dname])
                    label = (f"{list(shape)}" if name == "attention_bwd"
                             else f"{list(shape)} heads={heads} legacy_scale={int(legacy)}")
                torch.cuda.synchronize()
                abs_err = rel_err = 0.0
                part_errs = []
                for g_, w_ in zip(got, want):
                    if not torch.isfinite(g_.float()).all():
                        fail(f"{name} {label} {dname}: non-finite output")
                    a_, r_ = errs(g_.float(), w_.float())
                    abs_err, rel_err = max(abs_err, a_), max(rel_err, r_)
                    part_errs.append(r_)
                ms_k, ms_p, ms_l = time_ms(run_k), time_ms(run_p), time_ms(lib)
                dev_t = (device_ms(run_k), device_ms(run_p), device_ms(lib))
                if name.startswith("attention_bwd"):
                    # the library's backward and the kernels, profiled alike (the sum of
                    # their device events, without the gaps between launches)
                    dev_t += (profiled_device_ms(lib), profiled_device_ms(run_k))
                    # no atomics: two calls on the same inputs agree bit for bit
                    again = [run_k(), run_k()]
                    if not all(torch.equal(a_, b_) for a_, b_ in zip(*again)):
                        fail(f"{name} {label} {dname}: two backward calls on the same inputs "
                             "differ")
                tol = TOL[name][dname]
                ok = rel_err <= tol
                control = ""
                if name == "attention_mh":
                    # the check must tell head splits apart: against the
                    # one-head plain version the kernel's output is far off
                    ctrl = errs(got[0].float(), k2.attention_plain(q, kk, v).float())[1]
                    control = f", vs one head {ctrl:.3e} (must exceed {CONTROL_MIN:g})"
                    ok = ok and ctrl > CONTROL_MIN
                elif name == "attention_bwd_mh":
                    # the multi-head backward read as one head (the gradient
                    # of the one-head plain forward) must be far off
                    one = torch.autograd.grad(k2.attention_plain(q, kk, v), (q, kk, v), d_o)
                    ctrl = max(errs(g_.float(), w_.float())[1] for g_, w_ in zip(got, one))
                    control = f", vs one head {ctrl:.3e} (must exceed {CONTROL_MIN:g})"
                    ok = ok and ctrl > CONTROL_MIN
                by_part = ""
                if name.startswith("attention"):
                    by_part = " [" + ", ".join(f"{p_} {e_:.3e}" for p_, e_ in
                                               zip(parts, part_errs)) + "]"
                timing = (f"kernel {ms_k:.4f} ms per call ({ms_k * count:.4f} per eval), plain "
                          f"{ms_p:.4f} ms, library {ms_l:.4f} ms")
                if name.startswith("attention_bwd"):
                    timing += "; bitwise equal across two calls"
                timing += (f"; device time per call, back to back: kernel {dev_t[0]:.4f} "
                           f"ms ({dev_t[0] * count:.4f} per eval), plain {dev_t[1]:.4f} ms, "
                           f"library {dev_t[2]:.4f} ms")
                if len(dev_t) > 3:
                    prof = ["not measured" if v_ is None else f"{v_:.4f} ms" for v_ in dev_t[3:]]
                    timing += (f"; device events in torch.profiler per call: library {prof[0]}, "
                               f"kernel {prof[1]}")
                phase(f"  {name} {dname} {label} x{count}: rel err {rel_err:.3e}{by_part} (tol "
                      f"{tol:g}{control}) {timing}, bound {b_ms:.4f} ms ({b_by})"
                      f"{'' if ok else '  <-- FAIL'}")
                if not ok:
                    fail(f"{name} {label} {dname} disagrees with its plain version: {rel_err:.3e}"
                         f"{control}")
                dev_keys = ("device_ms", "plain_device_ms", "library_device_ms",
                            "library_profiled_ms", "profiled_ms")
                for k_, v_ in (("ms", ms_k), ("plain_ms", ms_p), ("library_ms", ms_l),
                               ("bound_ms", b_ms), *zip(dev_keys, dev_t)):
                    if v_ is not None:
                        tot[k_] = tot.get(k_, 0.0) + v_ * count
                tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
                tot["max_rel_err"] = max(tot["max_rel_err"], rel_err)
                bound_ms_by[b_by] += b_ms * count
                tot["calls"] += count
            # what bounds most of the eval's bound time
            tot["bound_by"] = max(bound_ms_by, key=bound_ms_by.get)
            out[name][dname] = tot
            dev_sum = (f"; device time {tot['device_ms']:.3f} ms (kernel) vs "
                       f"{tot['plain_device_ms']:.3f} ms (plain), "
                       f"{tot['library_device_ms']:.3f} ms (library)")
            if "library_profiled_ms" in tot:
                dev_sum += (f"; profiled: library {tot['library_profiled_ms']:.3f} ms, kernel "
                            f"{tot.get('profiled_ms', float('nan')):.3f} ms")
            phase(f"  {name} {dname}: {tot['calls']} calls per eval take {tot['ms']:.3f} ms "
                  f"(kernel) vs {tot['plain_ms']:.3f} ms (plain), {tot['library_ms']:.3f} ms "
                  f"(library), bound {tot['bound_ms']:.3f} ms{dev_sum}")

    shape = (1, 256, 256, 3)
    x, eps, eps_mod, noise = (randn(*shape) for _ in range(4))
    cases = [  # (label, at, at_next, eta, noise, dt_lambda, apply_dt)
        ("generation eta=0", 0.30, 0.35, 0.0, None, 1.0, None),
        ("generation eta=1", 0.80, 0.85, 1.0, noise, 1.0, None),
        ("t_next=-1 eta=1", 0.9999, 1.0, 1.0, noise, 1.0, None),
        ("inversion", 0.35, 0.30, 0.0, None, 1.0, None),
        ("dt_lambda", 0.30, 0.35, 0.0, None, 0.9, torch.ones(1, device=dev)),
    ]
    res = {"max_abs_err": 0.0, "max_rel_err": 0.0, "library_ms": None, "calls": 1}
    for label, a, an, eta, z, dtl, adt in cases:
        a_t, an_t = torch.tensor([a], device=dev), torch.tensor([an], device=dev)
        eta_t = torch.tensor([eta], device=dev)
        run_k = lambda: k3.ddim_step(x, eps, eps_mod, a_t, an_t, eta_t, z, dt_lambda=dtl,
                                     apply_dt=adt)
        run_p = lambda: k3.ddim_step_plain(x, eps, eps_mod, a_t, an_t, eta_t, z, dt_lambda=dtl,
                                           apply_dt=adt)
        (xn_k, x0_k), (xn_p, x0_p) = run_k(), run_p()
        e1, e2 = errs(xn_k, xn_p), errs(x0_k, x0_p)
        rel_err = max(e1[1], e2[1])
        ms_k, ms_p = time_ms(run_k), time_ms(run_p)
        n = x.numel()
        b_ms, b_by = bound((5 + (z is not None)) * n * 4, 25 * n, PEAK_FLOPS["float32"])
        res["max_abs_err"] = max(res["max_abs_err"], e1[0], e2[0])
        res["max_rel_err"] = max(res["max_rel_err"], rel_err)
        if label == "generation eta=1":  # the step the eta window runs
            res.update(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)
        ok = rel_err <= TOL["ddim_step"]["float32"]
        phase(f"  ddim_step float32 {list(shape)} {label}: rel err {rel_err:.3e} (tol 1e-06) "
              f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, library n/a, bound {b_ms:.4f} ms "
              f"({b_by}){'' if ok else '  <-- FAIL'}")
        if not ok:
            fail(f"ddim_step {label} disagrees with its plain version: {rel_err:.3e}")
    out["ddim_step"]["float32"] = res

    # The OpenAI path's elementwise steps. The carry is float32; eps (and
    # eps_mod, and the learned log-variance) are strided views of a
    # learn_sigma model's [1, 256, 256, 6] output, in the model's dtype.
    a_t, an_t, one = (torch.tensor([v], device=dev) for v in (0.80, 0.85, 1.0))
    bt = torch.tensor([0.02], device=dev)
    raw, raw_mod = randn(*shape[:-1], 6), randn(*shape[:-1], 6)
    raw[..., 3:] = -2.0 + 0.5 * raw[..., 3:]  # a log-variance's range
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.tensor([], dtype=dtype).element_size()
        r, r_mod = raw.to(dtype), raw_mod.to(dtype)
        n = x.numel()
        steps = [  # (row, label, kernel, plain, bytes, flops)
            ("ddim_step_learn_sigma", "eta=1", lambda: k3.ddim_step(
                x, r[..., :3], r_mod[..., :3], a_t, an_t, one, noise),
             lambda: k3.ddim_step_plain(x, r[..., :3], r_mod[..., :3], a_t, an_t, one, noise),
             n * (4 + 2 * es + 4 + 8), 25 * n)]
        for label, lv, t_ in (("learned logvar", r[..., 3:], 999.0),
                              ("table logvar", torch.tensor([-3.9], device=dev), 999.0),
                              ("learned logvar, t=0", r[..., 3:], 0.0)):
            tt = torch.tensor([t_], device=dev)
            per_elem = lv.dim() == 4
            steps.append((
                "ddpm_step", label,
                lambda lv=lv, tt=tt: kddpm.ddpm_step(x, r[..., :3], lv, bt, a_t, tt, noise),
                lambda lv=lv, tt=tt: kddpm.ddpm_step_plain(x, r[..., :3], lv, bt, a_t, tt, noise),
                n * (4 + es + es * per_elem + 4 + 4), 12 * n))
        for row, label, run_k, run_p, n_bytes, n_flops in steps:
            got, want = run_k(), run_p()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            abs_err = rel_err = 0.0
            for g_, w_ in zip(got, want):
                if not torch.isfinite(g_).all():
                    fail(f"{row} {label} {dname}: non-finite output")
                a_, r_ = errs(g_, w_)
                abs_err, rel_err = max(abs_err, a_), max(rel_err, r_)
            ms_k, ms_p = time_ms(run_k), time_ms(run_p)
            b_ms, b_by = bound(n_bytes, n_flops, PEAK_FLOPS["float32"])
            ok = rel_err <= TOL[row]
            phase(f"  {row} {list(shape)} float32 carry, {dname} model output, {label}: rel err "
                  f"{rel_err:.3e} (tol {TOL[row]:g}) kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
                  f"library n/a, bound {b_ms:.4f} ms ({b_by}){'' if ok else '  <-- FAIL'}")
            if not ok:
                fail(f"{row} {label} {dname} disagrees with its plain version: {rel_err:.3e}")
            res = out[row].setdefault(dname, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                              "library_ms": None, "calls": 1})
            res["max_abs_err"] = max(res["max_abs_err"], abs_err)
            res["max_rel_err"] = max(res["max_rel_err"], rel_err)
            if "ms" not in res:  # the row's time: its first case, the one the path runs most
                res.update(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)
    return out


class _RunnerLog(logging.Handler):
    """Collects the runner's per-grid serving records and per-iteration
    training records."""

    def __init__(self):
        super().__init__()
        self.grids, self.iters = [], []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("serving on"):
            self.grids.append(record.args)
        elif msg.startswith("iter "):
            self.iters.append(msg)


def write_images(ws: str, n: int = 2, sub: str = "imgs") -> str:
    import numpy as np
    from PIL import Image

    imgs = os.path.join(ws, sub)
    os.makedirs(imgs, exist_ok=True)
    rng = np.random.RandomState(SEED)
    for i in range(n):
        Image.fromarray((rng.rand(IMAGE, IMAGE, 3) * 255).astype(np.uint8)).save(
            os.path.join(imgs, f"{i}.png"))
    return imgs


def make_serving_workspace(ws: str) -> None:
    from asyrp_official_torch.cli.main import load_config
    from asyrp_official_torch.compat import save_delta_checkpoint
    from asyrp_official_torch.models.delta import delta_block_init
    from asyrp_official_torch.utils import hostrng
    from asyrp_official_torch.models.registry import spec_from_config

    write_images(ws)
    spec = spec_from_config(load_config(CONFIG))
    block = delta_block_init(hostrng.PRNGKey(7), spec.bottleneck_ch, spec.temb_ch)
    save_delta_checkpoint(os.path.join(ws, "checkpoint", "smoke_delta.pth"), blocks=[block])


def serve_argv(ws: str, bf16: bool):
    imgs = os.path.join(ws, "imgs")
    argv = ["--config", CONFIG, "--exp", os.path.join(ws, "runs", "smoke"),
            "--run_test", "--train_delta_block", "--allow_random_weights", "--device", DEVICE,
            "--custom_train_dataset_dir", imgs, "--custom_test_dataset_dir", imgs,
            "--work_dir", ws, "--manual_checkpoint_name", "smoke_delta.pth",
            "--n_inv_step", str(STEPS), "--n_test_step", str(STEPS),
            "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
            "--bs_train", "1", "--n_test_img", "2", "--do_train", "0", "--save_x_origin",
            "--seed", str(SEED), "--ni"]
    return argv + (["--bf16"] if bf16 else [])


def main_path_phase(torch, card, log, ws_root):
    import numpy as np
    from PIL import Image

    from asyrp_official_torch.cli.main import main as cli_main

    timings, launches = {}, None
    for bf16 in (False, True):
        dname = "bfloat16" if bf16 else "float32"
        ws = os.path.join(ws_root, dname)
        os.makedirs(os.path.join(ws, "checkpoint"))
        make_serving_workspace(ws)
        zero_counters()
        t0 = time.perf_counter()
        rc = cli_main(serve_argv(ws, bf16))
        wall = time.perf_counter() - t0
        counts = counters()
        if rc != 0:
            fail(f"serving path ({dname}) exited {rc}")
        require_launches(counts, ("group_norm", "attention", "ddim_step"),
                         f"serving path ({dname})")
        grids = sorted(os.path.join(r, f) for r, _, fs in os.walk(os.path.join(ws, "runs"))
                       for f in fs if f.endswith(".png"))
        if len(grids) != 2:
            fail(f"serving path ({dname}): expected 2 grids, found {grids}")
        for g in grids:
            arr = np.asarray(Image.open(g))
            if arr.shape != (2 * IMAGE + 3, IMAGE + 2, 3):
                fail(f"grid {g} has shape {arr.shape}")
        pairs = np.load(os.path.join(ws, "precomputed",
                                     f"CUSTOM_test_t999_nim2_ninv{STEPS}_pairs.npz"))
        for k in ("x_lat", "x_rec"):
            if not np.isfinite(pairs[k]).all():
                fail(f"serving path ({dname}): non-finite {k}")
        _, n_grids, first_ms, last_ms, n_chain, _ = log.grids[-1]
        per_step = last_ms / (2 * n_chain)
        timings[dname] = {"grid_ms_first": first_ms, "grid_ms": last_ms, "ms_per_step": per_step,
                          "run_s": wall}
        if not bf16:
            launches = counts
        phase(f"  serving path {dname} on {card}: rc 0, 2 grids, launches {counts}; "
              f"per grid ({n_chain}-step plain + {n_chain}-step edited generation, bs 1): "
              f"first {first_ms:.1f} ms, second {last_ms:.1f} ms = {per_step:.2f} ms/step; "
              f"whole CLI run incl. init and 2x{STEPS}+{STEPS} precompute steps {wall:.1f} s")
    return timings, launches


def chain_phase(torch, dev, card, ws, argv, config, ckpt, pairs, eps_check=False):
    """The float32 serving chain (invert + edit) with kernels vs plain
    versions on the card, from the CLI run's first test image and the same
    noise; then its time per dtype. With `eps_check`, one edited eval at
    t = 999 must give eps far from zero and eps_mod apart from eps."""
    import numpy as np

    from asyrp_official_torch import uniform_seq
    from asyrp_official_torch.cli.main import build_parser, load_config
    from asyrp_official_torch.models.delta import EditState
    from asyrp_official_torch.pipelines import engine
    from asyrp_official_torch.runner import AsyrpRunner

    args = build_parser().parse_args(argv)
    runner = AsyrpRunner(args, load_config(config), work_dir=ws)
    model = runner.load_pretrained()
    edit = EditState(blocks=(runner._load_blocks(os.path.join(ws, "checkpoint", ckpt)),),
                     hs_coeff=torch.tensor([1.0, 1.0], device=dev),
                     flavor=runner.spec.delta_flavor)
    x0 = np.load(os.path.join(ws, "precomputed", pairs))["x0"][:1]
    x0 = torch.from_numpy(x0).to(dev)
    if eps_check:
        with torch.no_grad():
            eps, eps_mod, _, _ = runner.spec.apply(model, x0, torch.full((1,), 999.0, device=dev),
                                                   edit=edit)
        c = eps.shape[-1] // 2 if runner.spec.learn_sigma else eps.shape[-1]
        std = float(eps[..., :c].std())
        moved = float((eps_mod - eps)[..., :c].abs().max()) / float(eps[..., :c].abs().max())
        phase(f"  one edited eval at t=999: eps std {std:.3f} (must exceed {MIN_EPS_STD:g}), "
              f"max |eps_mod - eps| / max |eps| {moved:.3e}")
        if not std > MIN_EPS_STD or not moved > 1e-3:
            fail(f"eps std {std:.3f}, edit moved eps by {moved:.3e}: the comparison would prove "
                 "nothing")
    seq = uniform_seq(STEPS, 999)
    run = engine.make_invert_edit(runner.spec, runner.schedule, seq, seq, t_edit=T_EDIT,
                                  t_addnoise=T_ADDNOISE)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)
    zero_counters()
    out_k = run(model, edit, x0, gen())
    per_request = counters()
    with plain_versions():
        out_p = run(model, edit, x0, gen())
    if counters() != per_request:
        fail("the plain chain launched a kernel")
    if not (torch.isfinite(out_k).all() and torch.isfinite(out_p).all()):
        fail("non-finite chain output")
    if out_k.shape != (1, IMAGE, IMAGE, 3):
        fail(f"chain output shape {tuple(out_k.shape)}")
    err = errs(out_k, out_p)[1]
    phase(f"  float32 invert+edit chain ({STEPS}+{STEPS} steps, bs 1), kernels vs plain: "
          f"rel err {err:.3e} (tol {CHAIN_TOL:g}), output max |x| {float(out_p.abs().max()):.3f}; "
          f"launches per chain {per_request}")
    if err > CHAIN_TOL:
        fail(f"serving chain with kernels disagrees with the plain chain: {err:.3e}")

    chain_ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        timed = engine.make_invert_edit(runner.spec, runner.schedule, seq, seq, t_edit=T_EDIT,
                                        t_addnoise=T_ADDNOISE, compute_dtype=dtype)
        times = []
        for _ in range(3):  # the first run warms up
            t0 = time.perf_counter()
            out = timed(model, edit, x0, gen())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(out).all():
            fail(f"non-finite {dname} chain output")
        chain_ms[dname] = sorted(times[1:])[0]
        phase(f"  {dname} invert+edit chain ({STEPS}+{STEPS} steps, bs 1) on {card}: "
              f"runs {', '.join(f'{t:.1f}' for t in times)} ms (first warms up)")
    return err, chain_ms, per_request, (runner.spec, model, edit)


def _kernel_family(name: str) -> str:
    n = name.lower()
    if "gn_" in n:
        return "K1 group_norm"
    if "attn_" in n:
        return "K2 attention"
    if any(s in n for s in ("gemm", "conv", "xmma", "cudnn", "cutlass", "winograd")):
        return "conv/gemm"
    return "other"


def profile_phase(torch, dev, card, served):
    """Where the time goes in one UNet eval at batch 1: wall p50 of 20
    unprofiled evals, then one eval under torch.profiler, whose device
    events give the busy time by kernel family; idle share = 1 - busy /
    that eval's wall."""
    from torch.profiler import ProfilerActivity, profile

    spec, model, edit = served
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(1, IMAGE, IMAGE, 3, generator=gen, device=dev)
    t = torch.full((1,), 500.0, device=dev)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, e in (("single", None), ("dual", edit)):
            run = lambda: spec.apply(model, x.to(dtype), t, edit=e)
            walls = []
            with torch.no_grad():
                for i in range(23):  # 3 warm-up evals
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    if i >= 3:
                        walls.append((time.perf_counter() - t0) * 1e3)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    prof_wall = (time.perf_counter() - t0) * 1e3
            row = {"wall_ms_p50": statistics.median(walls),
                   **device_time(prof, prof_wall, f"{dname} {label}")}
            rows[f"{dname}_{label}"] = row
            phase(f"  {dname} {label} decode on {card}: wall p50 {row['wall_ms_p50']:.2f} ms; "
                  + fmt_device_time(row))
    return rows


def device_time(prof, wall_ms: float, what: str):
    """Device busy time by kernel family, event count and idle share (1 -
    busy / wall) of one profiled window."""
    from torch.autograd import DeviceType

    fam, n_dev = {}, 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        n_dev += 1
        f = _kernel_family(ev.name)
        fam[f] = fam.get(f, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy = sum(fam.values())
    if busy <= 0.0:
        fail(f"profile {what}: torch.profiler recorded no device time")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "device_events": n_dev, "ms_by_family": fam}


def fmt_device_time(row) -> str:
    return (f"profiled wall {row['profiled_wall_ms']:.2f} ms, device busy "
            f"{row['device_busy_ms']:.2f} ms, idle share {row['idle_share']:.3f}, "
            f"{row['device_events']} device events; "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(row["ms_by_family"].items())))


def train_argv(ws: str, imgs: str, clip_ckpt: str, exp: str, bf16: bool = False, extra=()):
    argv = ["--config", CONFIG, "--exp", os.path.join(ws, "runs", exp),
            "--run_train", "--train_delta_block", "--edit_attr", "smiling",
            "--allow_random_weights", "--device", DEVICE, "--clip_ckpt", clip_ckpt,
            "--clip_loss_w", "1", "--l1_loss_w", "3", "--get_h_num", "1",
            "--n_inv_step", str(STEPS), "--n_train_step", str(STEPS), "--n_iter", "2",
            "--n_train_img", "2", "--bs_train", "1", "--lr_training", "0.5",
            "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
            "--do_test", "1", "--n_test_img", "1",
            "--custom_train_dataset_dir", imgs, "--custom_test_dataset_dir", imgs,
            "--work_dir", ws, "--seed", str(SEED), "--ni"]
    return argv + (["--bf16"] if bf16 else []) + list(extra)


def trained_block(ws: str, exp: str, category: str = "CUSTOM"):
    from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint

    path = os.path.join(ws, "checkpoint",
                        f"{exp}_LC_{category}_t999_ninv{STEPS}_ngen{STEPS}_1.pth")
    if not os.path.exists(path):
        fail(f"training wrote no checkpoint {path}")
    return load_delta_checkpoint(path)["blocks"][0]


def cli_train_run(torch, card, log, argv, ws: str, exp: str, what: str, kernels, init,
                  category: str = "CUSTOM"):
    """One `--run_train --train_delta_block` run through the port's CLI,
    in-process, with the launch counters zeroed just before it and read just
    after: rc 0, every kernel of `kernels` launched, the `.pth` moved from
    `init`, finite losses of both iterations, one finite `--do_test` grid.
    Returns (results, trained block)."""
    import numpy as np
    from PIL import Image

    from asyrp_official_torch.cli.main import main as cli_main

    n_edit = sum(1 for t in np.linspace(0, 1, STEPS) * 999 if t >= T_EDIT)
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    n_logs = len(log.iters)
    t0 = time.perf_counter()
    rc = cli_main(argv)
    wall = time.perf_counter() - t0
    counts = counters()
    if rc != 0:
        fail(f"{what} exited {rc}")
    require_launches(counts, kernels, what)
    blk = trained_block(ws, exp, category)
    moved = max(float(np.abs(blk[g][k] - init[g][k]).max()) for g in init for k in init[g])
    if not moved > 0:
        fail(f"{what}: the DeltaBlock did not move from its init")
    iters = log.iters[n_logs:]
    losses = [float(re.search(r"mean loss (\S+)", m).group(1)) for m in iters]
    if len(losses) != 2 or not all(np.isfinite(losses)):
        fail(f"{what}: losses {losses} from {iters}")
    timing = [re.search(r"([\d.]+) ms/batch -> ([\d.]+) ms/edit-timestep", m) for m in iters]
    ms_batch, ms_step = (float(timing[-1].group(1)), float(timing[-1].group(2)))
    grids = [os.path.join(r, f) for r, _, fs in os.walk(os.path.join(ws, "runs"))
             for f in fs if f.startswith("test_")]
    if len(grids) != 1:
        fail(f"{what}: expected 1 test grid, found {grids}")
    grid = np.asarray(Image.open(grids[0]), np.float32)
    if grid.shape != (IMAGE + 2, IMAGE + 2, 3) or not np.isfinite(grid).all():
        fail(f"{what}: test grid {grids[0]} has shape {grid.shape}")
    (test_pairs,) = glob.glob(os.path.join(ws, "precomputed", f"{category}_test_*_pairs.npz"))
    if not np.isfinite(np.load(test_pairs)["x_lat"]).all():
        fail(f"{what}: non-finite test latents")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    res = {"rc": rc, "losses": losses, "ms_per_batch": ms_batch, "ms_per_edit_timestep": ms_step,
           "edited_timesteps": n_edit, "run_s": wall, "launches": counts, "peak_gb": peak_gb,
           "block_max_abs_change": moved}
    phase(f"  {what} on {card}: rc 0, losses per iteration {losses}, block moved by up to "
          f"{moved:.3e} from its init, test grid {grid.shape}; {ms_batch:.0f} ms/batch -> "
          f"{ms_step:.1f} ms per edited timestep ({n_edit} per batch, 2nd iteration, origin "
          f"cache on); launches {counts}; peak device memory {peak_gb:.2f} GiB; whole CLI run "
          f"{wall:.1f} s")
    return res, blk


def train_phase(torch, card, log, ws_root, clip_ckpt: str):
    """Phase 7: Δ-training through the port's CLI, float32 and bfloat16,
    then the float32 run again with the plain versions."""
    from asyrp_official_torch.cli.main import load_config, main as cli_main
    from asyrp_official_torch.models.delta import delta_block_init
    from asyrp_official_torch.utils import hostrng
    from asyrp_official_torch.models.registry import spec_from_config

    # each run has a work dir of its own (its own latents cache); they share
    # the images and the random CLIP weights
    imgs = write_images(os.path.join(ws_root, "train"))
    spec = spec_from_config(load_config(CONFIG))
    init = delta_block_init(hostrng.PRNGKey(SEED), spec.bottleneck_ch, spec.temb_ch)
    results, blocks, launches = {}, {}, None
    for dname in DTYPES:
        ws, exp = os.path.join(ws_root, "train", dname), f"train_{dname}"
        results[dname], blocks[dname] = cli_train_run(
            torch, card, log, train_argv(ws, imgs, clip_ckpt, exp, bf16=dname == "bfloat16"),
            ws, exp, f"training path {dname}", TRAIN_KERNELS, init)
        if dname == "float32":
            launches = results[dname]["launches"]

    # The float32 run again, from the same latents (its pairs cache), with the
    # plain versions. 76 SGD steps through the L1 term's sign amplify any
    # rounding difference (two runs of the kernels, whose cuDNN backward sums
    # in no fixed order, drift apart about as far as kernels and plain), so
    # the trained update is a coarse end-to-end check; the one-timestep
    # gradient below is the kernels' gate.
    ws_f32 = os.path.join(ws_root, "train", "float32")
    ws = os.path.join(ws_root, "train", "plain")
    shutil.copytree(os.path.join(ws_f32, "precomputed"), os.path.join(ws, "precomputed"))
    before = counters()
    t0 = time.perf_counter()
    with plain_versions():
        rc = cli_main(train_argv(ws, imgs, clip_ckpt, "plain",
                                 extra=["--do_test", "0", "--save_train_image", "0"]))
    plain_s = time.perf_counter() - t0
    if counters() != before:
        fail("the plain training run launched a kernel")
    if rc != 0:
        fail(f"training path (plain versions) exited {rc}")
    plain = trained_block(ws, "plain")
    whole = block_err(blocks["float32"], plain)
    update = block_err(minus(blocks["float32"], init), minus(plain, init))
    phase(f"  float32 training from the same latents, kernels vs plain versions, max |a - b| / "
          f"max |b| over the whole block: trained block {whole:.3e} (tol {TRAIN_TOL:g}), its "
          f"update from the init {update:.3e} (tol {UPDATE_TOL:g}); plain run {plain_s:.1f} s")
    if whole > TRAIN_TOL or update > UPDATE_TOL:
        fail(f"the block trained with the kernels disagrees with the plain run: block {whole:.3e}, "
             f"update {update:.3e}")

    check = gradient_check(torch, train_argv(ws_f32, imgs, clip_ckpt, "train_float32"), CONFIG,
                           {"K1-bwd dweight x 1.01": lambda: k1_bwd_fault(1.01, 1.0),
                            "K1-bwd dx x 1.01": lambda: k1_bwd_fault(1.0, 1.01)})
    gate(check, card)
    results["float32_vs_plain"] = {"whole_block_rel_err": whole, "update_rel_err": update,
                                   "plain_run_s": plain_s}
    results["gradient_check"] = check
    return results, launches


def afhq_train_argv(ws: str, model_path: str, clip_ckpt: str, exp: str, bf16: bool = False):
    argv = ["--config", AFHQ_CONFIG, "--exp", os.path.join(ws, "runs", exp),
            "--run_train", "--train_delta_block", "--edit_attr", AFHQ_ATTR,
            "--model_path", model_path, "--device", DEVICE, "--clip_ckpt", clip_ckpt,
            "--clip_loss_w", "1", "--l1_loss_w", "3", "--get_h_num", "1",
            "--n_inv_step", str(STEPS), "--n_train_step", str(STEPS), "--n_iter", "2",
            "--n_train_img", "2", "--bs_train", "1", "--lr_training", "0.5",
            "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
            "--do_test", "1", "--n_test_img", "1", "--work_dir", ws, "--seed", str(SEED), "--ni"]
    return argv + (["--bf16"] if bf16 else [])


def afhq_train_phase(torch, card, log, root: str, data: str, model_path: str, clip_ckpt: str):
    """Phase 9: Δ-training of an OpenAI DeltaBlock on the full-width AFHQ
    UNet (the perturbed `.pt` of phase 8) through the port's CLI, float32
    and bfloat16, each run in a work dir of its own; then the gate of the
    multi-head attention backward (K2-bwd-MH)."""
    from asyrp_official_torch.cli.main import load_config
    from asyrp_official_torch.models.delta import delta_block_init
    from asyrp_official_torch.models.registry import spec_from_config
    from asyrp_official_torch.utils import hostrng

    write_images(os.path.join(data, "afhq", "train"), sub="dog")
    spec = spec_from_config(load_config(AFHQ_CONFIG))
    init = delta_block_init(hostrng.PRNGKey(SEED), spec.bottleneck_ch, spec.temb_ch,
                            flavor="openai")
    results = {}
    for dname in DTYPES:
        ws, exp = os.path.join(root, f"train_{dname}"), f"afhq_{dname}"
        results[dname], _ = cli_train_run(
            torch, card, log,
            afhq_train_argv(ws, model_path, clip_ckpt, exp, bf16=dname == "bfloat16"), ws, exp,
            f"AFHQ training path {dname}", AFHQ_TRAIN_KERNELS, init, category="AFHQ")
        counts = results[dname]["launches"]
        if counts["attention"] or counts["attention_bwd"]:
            fail(f"AFHQ training path {dname} launched the single-head attention: {counts}")
    check = gradient_check(
        torch, afhq_train_argv(os.path.join(root, "train_float32"), model_path, clip_ckpt,
                               "afhq_float32"), AFHQ_CONFIG,
        {"K2-bwd-MH D summed over all C": d_over_all_channels})
    norms = check["mh_bwd_cotangent_norms"]
    phase(f"  the cotangents reaching K2-bwd-MH in that timestep: {len(norms)} calls, norms "
          f"{', '.join(f'{v:.3e}' for v in norms)} (each must exceed 0)")
    if not norms or min(norms) <= 0.0:
        fail(f"no nonzero cotangent reached K2-bwd-MH: {norms}")
    if not check["launches"]["float32"]["attention_mh_bwd"]:
        fail(f"the gradient check did not launch K2-bwd-MH: {check['launches']}")
    gate(check, card)
    results["gradient_check"] = check
    return results, results["float32"]["launches"]


def gate(check, card) -> None:
    """Prints one timestep's gradient check and fails where it does: the
    float32 kernels vs the plain versions within GRAD_TOL, every planted
    fault beyond it, bf16 within BF16_GRAD_FACTOR of the plain versions'
    bf16 distance from float32."""
    what = ("one edited timestep's gradient w.r.t. the DeltaBlock (t=999, the first step, "
            "deterministic cuDNN) per leaf, max |a - b| / max |b|")
    f32, bf = check["float32"], check["bfloat16"]
    phase(f"  {what}, float32, kernels vs plain versions: {fmt(f32)}; worst {max(f32.values()):.3e} "
          f"(tol {GRAD_TOL:g}); launches of that timestep {check['launches']['float32']}")
    for label, err in check["planted_faults"].items():
        phase(f"  planted fault, {label}: the float32 check reads {err:.3e} (tol {GRAD_TOL:g})"
              f"{'' if err > GRAD_TOL else '  <-- MISSED'}")
    phase(f"  {what}, bfloat16 against the float32 plain versions: kernels {fmt(bf['kernels'])}; "
          f"plain versions {fmt(bf['plain'])}; worst {max(bf['kernels'].values()):.3e} vs "
          f"{max(bf['plain'].values()):.3e} (tol {BF16_GRAD_FACTOR:g}x); bfloat16 kernels vs "
          f"plain {fmt(bf['kernels_vs_plain'])}; without the CLIP term "
          f"{fmt(bf['kernels_vs_plain_no_clip'])}; launches {check['launches']['bfloat16']}")
    for dname, row in check["l1_term"].items():
        phase(f"  L1 term (3 x mean |x0_t - x0_t_origin|) with the initial block along the float32 "
              f"origin trajectory, {dname}: mean over the {len(row)} edited timesteps "
              f"{statistics.fmean(row):.4f}; per timestep {', '.join(f'{v:.3f}' for v in row)}")
    for dname, prof in check["profile"].items():
        phase(f"  one edited timestep (forward + backward, {dname}, kernels) on {card}: "
              + fmt_device_time(prof))
    if max(f32.values()) > GRAD_TOL:
        fail(f"the float32 DeltaBlock gradient with the kernels disagrees with the plain one: "
             f"{max(f32.values()):.3e}")
    if min(check["planted_faults"].values()) <= GRAD_TOL:
        fail(f"the gradient check does not see a planted fault: {check['planted_faults']}")
    if max(bf["kernels"].values()) > BF16_GRAD_FACTOR * max(bf["plain"].values()):
        fail("the bfloat16 DeltaBlock gradient with the kernels is farther from the float32 one "
             f"than {BF16_GRAD_FACTOR:g}x the plain versions' bfloat16 gradient")


def minus(a, b):
    """a - b, leaf by leaf, of two JAX-layout blocks."""
    return {g: {k: a[g][k] - b[g][k] for k in b[g]} for g in b}


def block_err(a, b) -> float:
    """max |a - b| / max |b| over all leaves of two JAX-layout blocks."""
    import numpy as np

    diff = max(float(np.abs(a[g][k] - b[g][k]).max()) for g in b for k in b[g])
    return diff / max(float(np.abs(b[g][k]).max()) for g in b for k in b[g])


def fmt(errs_by_leaf) -> str:
    return ", ".join(f"{k} {v:.2e}" for k, v in errs_by_leaf.items())


def k1_bwd_fault(d_weight: float, d_x: float):
    """K1-bwd with its weight gradient and its input gradient scaled."""
    from unittest import mock

    from asyrp_official_torch.ops import groupnorm as k1

    real = k1.group_norm_backward

    def bwd(*a, **kw):
        dx, dw, db = real(*a, **kw)
        return dx * d_x, None if dw is None else dw * d_weight, db
    return mock.patch.object(k1, "group_norm_backward", bwd)


def d_over_all_channels():
    """K2-bwd-MH run with D (rowsum of dO * O) summed over all C channels of
    a row instead of its head's d: each head's slice of the O the kernel
    reads gets a component along dO that lifts its dot with dO to the whole
    row's (O enters the backward only through D)."""
    from unittest import mock

    from asyrp_official_torch.ops import attention as k2

    real = k2.attention_backward

    def bwd(q, k, v, o, d_o, lse, *, num_heads=1, legacy_scale=False):
        if num_heads > 1:
            b, t, c = o.shape
            dof = d_o.float().reshape(b, t, num_heads, -1)
            of = o.float().reshape(b, t, num_heads, -1)
            d_head = (dof * of).sum(-1, keepdim=True)
            lift = (d_head.sum(-2, keepdim=True) - d_head) / dof.square().sum(-1, keepdim=True)
            o = (of + dof * lift).reshape(b, t, c).to(o.dtype)
        return real(q, k, v, o, d_o, lse, num_heads=num_heads, legacy_scale=legacy_scale)
    return mock.patch.object(k2, "attention_backward", bwd)


def gradient_check(torch, argv, config: str, faults):
    """The gradient with respect to a freshly initialized DeltaBlock of the
    first edited timestep's CLIP term plus a fixed random linear functional
    of x0_t, through the full-width UNet and K3's backward, with the kernels
    and with the plain versions, from the latents of the float32 run of
    `argv`, in float32 and bfloat16. The functional stands in for the L1
    term: at the first step eps_mod - eps is a small difference of large
    outputs, and the L1 term's sign flips on the elements where it is within
    float noise, while the functional sends a fixed cotangent down the same
    backward path. cuDNN runs its deterministic algorithms for the
    comparison, so the kernels are the only difference. Each of `faults`
    (label -> a context that plants a fault in a backward kernel) must move
    the float32 gradient beyond GRAD_TOL. Records the norm of every
    cotangent that reaches the multi-head attention backward in the float32
    kernels run.

    Also measures the L1 term with the initial block at each edited timestep
    of the float32 origin trajectory in both dtypes (how much of the bf16
    training loss is rounding), and profiles one timestep per dtype with the
    kernels and the default cuDNN."""
    from unittest import mock

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from asyrp_official_torch.cli.main import build_contexts, build_parser, load_config
    from asyrp_official_torch.core.schedule import train_seq
    from asyrp_official_torch.losses.clip_loss import train_clip_term
    from asyrp_official_torch.models.delta import EditState, init_delta_blocks
    from asyrp_official_torch.ops import attention as k2, ddim_step as k3
    from asyrp_official_torch.runner import AsyrpRunner

    args = build_parser().parse_args(argv)
    dev = torch.device(DEVICE)
    ctx = build_contexts(args, dev)
    runner = AsyrpRunner(args, load_config(config), clip_ctx=ctx, work_dir=args.work_dir)
    runner.set_interval()
    spec = runner.spec
    model = runner.load_pretrained()
    pairs = runner.get_pairs(model, "train")  # the run's cache
    x = torch.from_numpy(pairs["x_lat"][:1]).to(dev)
    x0 = torch.from_numpy(pairs["x0"][:1]).to(dev)
    seq, seq_next = train_seq(STEPS, 999, T_EDIT)
    acp = torch.from_numpy(runner.schedule.alphas_cumprod_ext).to(dev)
    extra = train_clip_term(ctx, runner.src_txts[0], runner.trg_txts[0], 1.0)
    cotangent = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)

    (block,) = init_delta_blocks(SEED, 1, spec.bottleneck_ch, spec.temb_ch,
                                 flavor=spec.delta_flavor)
    block = block.to(dev).train()
    edit = EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0], device=dev),
                     flavor=spec.delta_flavor)

    def eps_of(out):  # the eps channels (the first C of a learn_sigma model's 2C)
        return out[..., : x.shape[-1]]

    def coeffs(i):  # the i-th edited timestep from the top, as the generation table runs them
        t, t_next = seq[-1 - i], seq_next[-1 - i]
        return (torch.full((1,), float(t), device=dev), acp[t + 1].reshape(1),
                acp[t_next + 1].reshape(1))

    t_b, at, at_next = coeffs(0)

    def grads(dtype, clip: bool = True):  # the block's weights stay as initialized
        block.zero_grad(set_to_none=True)
        eps, eps_mod, _, _ = spec.apply(model, x.to(dtype), t_b, edit=edit, decode_mode="split")
        _, x0_t = k3.ddim_step(x, eps_of(eps), eps_of(eps_mod), at, at_next, 0.0)
        loss = (x0_t * cotangent).mean()
        (loss + extra(x0, x0_t) if clip else loss).backward()
        return {k: p.grad.detach().float().cpu().numpy() for k, p in block.named_parameters()}

    def rel(a, b):
        return {k: float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)) for k in b}

    cot_norms = []
    real_bwd = k2.attention_backward

    def probe(q, k, v, o, d_o, lse, **kw):
        if kw.get("num_heads", 1) > 1:
            cot_norms.append(float(d_o.float().norm()))
        return real_bwd(q, k, v, o, d_o, lse, **kw)

    out = {"launches": {}, "planted_faults": {}, "profile": {}}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        zero_counters()
        with mock.patch.object(k2, "attention_backward", probe):
            kernels = grads(torch.float32)
        out["launches"]["float32"] = counters()  # one edited timestep, forward and backward
        out["mh_bwd_cotangent_norms"] = cot_norms
        with plain_versions():
            plain = grads(torch.float32)
        out["float32"] = rel(kernels, plain)
        for label, fault in faults.items():
            with fault():
                out["planted_faults"][label] = max(rel(grads(torch.float32), plain).values())
        zero_counters()
        kernels_bf = grads(torch.bfloat16)
        out["launches"]["bfloat16"] = counters()
        kernels_bf_no_clip = grads(torch.bfloat16, clip=False)
        with plain_versions():
            plain_bf = grads(torch.bfloat16)
            plain_bf_no_clip = grads(torch.bfloat16, clip=False)
        out["bfloat16"] = {"kernels": rel(kernels_bf, plain), "plain": rel(plain_bf, plain),
                           "kernels_vs_plain": rel(kernels_bf, plain_bf),
                           "kernels_vs_plain_no_clip": rel(kernels_bf_no_clip, plain_bf_no_clip)}
    finally:
        torch.backends.cudnn.deterministic = deterministic

    with torch.no_grad():
        carry, l1 = x, {"float32": [], "bfloat16": []}
        e = edit.at_step({"use_delta": 1.0})
        for i in range(len(seq)):
            t_i, a_i, an_i = coeffs(i)
            for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
                eps, eps_mod, _, _ = spec.apply(model, carry.to(dtype), t_i, edit=e,
                                                decode_mode="split")
                x_next, x0_origin = k3.ddim_step(carry, eps_of(eps), eps_of(eps), a_i, an_i, 0.0)
                _, x0_t = k3.ddim_step(carry, eps_of(eps), eps_of(eps_mod), a_i, an_i, 0.0)
                l1[dname].append(3.0 * float((x0_t - x0_origin).abs().mean()))
            carry = x_next  # the float32 step, run last
    out["l1_term"] = l1

    # where the time goes in that timestep with the kernels and the run's
    # default cuDNN: two warm-up runs, then one under torch.profiler
    for dtype in (torch.float32, torch.bfloat16):
        for _ in range(2):
            grads(dtype)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            grads(dtype)  # ends in a device-to-host copy of the gradients
            wall = (time.perf_counter() - t0) * 1e3
        out["profile"][str(dtype).split(".")[-1]] = device_time(
            prof, wall, f"edited training timestep {dtype}")
    return out


def perturbed(tree, seed: int):
    """`tree` with every all-zero {"w", "b"} layer (the OpenAI init's
    zero_module output layers) redrawn uniformly within its kaiming bound
    1/sqrt(fan_in), from numpy RandomState(seed) in tree order; every other
    leaf unchanged."""
    import math

    import numpy as np

    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"w", "b"} and not (np.any(node["w"]) or np.any(node["b"])):
                w = np.asarray(node["w"])
                lim = 1.0 / math.sqrt(int(np.prod(w.shape[:-1])))
                return {"w": rng.uniform(-lim, lim, w.shape).astype(np.float32),
                        "b": rng.uniform(-lim, lim, np.shape(node["b"])).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node

    return walk(tree)


def make_afhq_workspace(torch, root: str, data: str) -> str:
    """Two random 256^2 images as `{data}/afhq/test/dog/*.png`, the
    perturbed AFHQ UNet as a `.pt` state dict under the reference key names
    and an OpenAI-flavor Δ checkpoint. Returns the `.pt` path."""
    from asyrp_official_torch.cli.main import load_config
    from asyrp_official_torch.compat import save_delta_checkpoint
    from asyrp_official_torch.models.delta import delta_block_init
    from asyrp_official_torch.models.registry import spec_from_config
    from asyrp_official_torch.utils import hostrng

    write_images(os.path.join(data, "afhq", "test"), sub="dog")
    spec = spec_from_config(load_config(AFHQ_CONFIG))
    sd = spec.state_dict_from_jax(perturbed(spec.init(hostrng.PRNGKey(SEED)), SEED))
    n_params = sum(v.numel() for v in sd.values())
    if n_params != 93_563_910:
        fail(f"the afhq.yml UNet has {n_params} parameters, not the reference's 93,563,910")
    model_path = os.path.join(root, "afhq_perturbed.pt")
    torch.save(sd, model_path)
    block = delta_block_init(hostrng.PRNGKey(7), spec.bottleneck_ch, spec.temb_ch, flavor="openai")
    save_delta_checkpoint(os.path.join(root, "afhq_delta.pth"), blocks=[block], flavor="openai")
    return model_path


def afhq_argv(ws: str, model_path: str, bf16: bool = False, steps: int = STEPS,
              sample_type: str = "ddim"):
    argv = ["--config", AFHQ_CONFIG, "--exp", os.path.join(ws, "runs", "afhq"),
            "--run_test", "--train_delta_block", "--model_path", model_path, "--device", DEVICE,
            "--work_dir", ws, "--manual_checkpoint_name", "afhq_delta.pth",
            "--n_inv_step", str(steps), "--n_test_step", str(steps),
            "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
            "--bs_train", "1", "--n_test_img", "2", "--do_train", "0", "--save_x_origin",
            "--sample_type", sample_type, "--seed", str(SEED), "--ni"]
    return argv + (["--bf16"] if bf16 else [])


AFHQ_RUNS = (  # (label, --bf16, steps, --sample_type)
    ("float32", False, STEPS, "ddim"), ("bfloat16", True, STEPS, "ddim"),
    ("ddpm float32", False, DDPM_STEPS, "ddpm"))


def afhq_phase(torch, card, log, root: str, model_path: str):
    """Phase 8: OpenAI-family serving through the port's CLI, one run per
    AFHQ_RUNS entry, each in a work dir of its own; the counters are zeroed
    just before each run and read just after it."""
    import numpy as np
    from PIL import Image

    from asyrp_official_torch.cli.main import main as cli_main

    timings, launches = {}, {}
    for label, bf16, steps, sample_type in AFHQ_RUNS:
        ws = os.path.join(root, label.replace(" ", "_"))
        os.makedirs(os.path.join(ws, "checkpoint"))
        shutil.copy(os.path.join(root, "afhq_delta.pth"), os.path.join(ws, "checkpoint"))
        zero_counters()
        t0 = time.perf_counter()
        rc = cli_main(afhq_argv(ws, model_path, bf16, steps, sample_type))
        wall = time.perf_counter() - t0
        counts = counters()
        if rc != 0:
            fail(f"AFHQ serving path ({label}) exited {rc}")
        require_launches(counts, ("group_norm", "attention_mh", "ddim_step")
                         + (("ddpm_step",) if sample_type == "ddpm" else ()),
                         f"AFHQ serving path ({label})")
        if counts["attention"]:
            fail(f"AFHQ serving path ({label}) launched the single-head attention: {counts}")
        grids = sorted(os.path.join(r, f) for r, _, fs in os.walk(os.path.join(ws, "runs"))
                       for f in fs if f.endswith(".png"))
        if len(grids) != 2:
            fail(f"AFHQ serving path ({label}): expected 2 grids, found {grids}")
        for g in grids:
            arr = np.asarray(Image.open(g))
            if arr.shape != (2 * IMAGE + 3, IMAGE + 2, 3):
                fail(f"grid {g} has shape {arr.shape}")
        pairs = np.load(os.path.join(ws, "precomputed",
                                     f"AFHQ_test_t999_nim2_ninv{steps}_pairs.npz"))
        for k in ("x_lat", "x_rec"):
            if not np.isfinite(pairs[k]).all():
                fail(f"AFHQ serving path ({label}): non-finite {k}")
        _, n_grids, first_ms, last_ms, n_chain, _ = log.grids[-1]
        per_step = last_ms / (2 * n_chain)
        timings[label] = {"grid_ms_first": first_ms, "grid_ms": last_ms, "ms_per_step": per_step,
                          "run_s": wall}
        launches[label] = counts
        phase(f"  AFHQ serving path {label} ({sample_type}) on {card}: rc 0, 2 grids, launches "
              f"{counts}; per grid ({n_chain}-step plain + {n_chain}-step edited generation, bs "
              f"1): first {first_ms:.1f} ms, second {last_ms:.1f} ms = {per_step:.2f} ms/step; "
              f"whole CLI run incl. loading and 2x{steps}+{steps} precompute steps {wall:.1f} s")
    return timings, launches


def _ptxas_by_entry(log: str):
    """{mangled entry name: {"registers": n, "spills": ptxas's spill line}}
    from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill stores" in ln:
            out[name]["spills"] = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def sass_counts(lib: str):
    """{mangled function name: {"HGMMA": n, "HMMA": n}} from `cuobjdump -sass`."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass {lib}: {proc.stderr.strip()[-500:]}")
    out, name = {}, None
    for ln in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = {"HGMMA": 0, "HMMA": 0}
        elif name and re.search(r"\bHGMMA\b", ln):
            out[name]["HGMMA"] += 1
        elif name and re.search(r"\bHMMA\b", ln):
            out[name]["HMMA"] += 1
    return out


def build_kernels():
    """Phase 2: nvcc for every source at once; then, per attention entry
    (forward `attn_fwd`, backward `attn_bwd`, in f32 and bf16), its
    tensor-core instructions (HGMMA from wgmma, HMMA from mma.sync) with
    its registers and spills. Fails if a bf16 entry has no HGMMA or an f32
    entry no HMMA (3xTF32 on mma.sync). Returns {entry label: counts}."""
    from asyrp_official_torch.ops import _build

    t0 = time.perf_counter()
    names = ("groupnorm", "attention")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:  # nvcc runs in parallel
        for f in [pool.submit(_build.load_library, n) for n in names]:
            f.result()
    for name in names:
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        phase(f"phase 2: built csrc/{name}.cu for sm_90a; ptxas: {' | '.join(ptxas)}")
    phase(f"phase 2: nvcc builds took {time.perf_counter() - t0:.1f} s")
    ptxas = _ptxas_by_entry(_build.build_log("attention"))
    entries = {}
    for fn, counts in sass_counts(_build._lib_path("attention")).items():
        m = re.search(r"(attn_fwd|attn_bwd)I(13__nv_bfloat16|f)E", fn)
        if not m:
            continue
        dname = "bfloat16" if m.group(2) != "f" else "float32"
        label = f"{m.group(1)} {dname}"
        info = ptxas.get(fn, {})
        entries[label] = {**counts, "registers": info.get("registers"),
                          "spills": info.get("spills")}
        phase(f"  {label}: {counts['HGMMA']} HGMMA, {counts['HMMA']} HMMA in its SASS; "
              f"{info.get('registers')} registers; {info.get('spills')}")
        if dname == "bfloat16" and not counts["HGMMA"]:
            fail(f"{label} has no HGMMA: the bf16 entry does not run on wgmma")
        if dname == "float32" and not counts["HMMA"]:
            fail(f"{label} has no HMMA: the f32 entry does not run on the tensor cores")
    if len(entries) != 4:
        fail(f"expected 4 attention entries (forward, backward; f32, bf16) in the SASS, found "
             f"{sorted(entries)}")
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(REPO, "asyrp_official_torch")):
        fail(f"no asyrp_official_torch package beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, REPO)
    ws_root = os.path.join(REPO, "runs", f"chip_smoke_{os.getpid()}")
    # the port's dataset paths read ASYRP_TPU_DATA once, when first imported
    os.environ["ASYRP_TPU_DATA"] = os.path.join(ws_root, "afhq", "data")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    phase(f"phase 1: card {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    sass = build_kernels()

    phase("phase 3: kernels against their plain versions (ms = median of 25 CUDA-event runs)")
    seen = record_path_shapes(torch, dev)
    phase(f"  one edited UNet eval at batch 1: {sum(seen['group_norm'].values())} group_norm "
          f"calls over {len(seen['group_norm'])} shapes, {sum(seen['attention'].values())} "
          f"attention calls over {len(seen['attention'])} shapes; one training-mode eval: "
          f"{seen['train_group_norm']} group_norm calls ({sum(seen['group_norm_bwd'].values())} "
          f"with a gradient, over {len(seen['group_norm_bwd'])} shapes), "
          f"{seen['train_attention']} attention calls "
          f"({sum(seen['attention_bwd'].values())} with a gradient)")
    seen_afhq = record_afhq_shapes(torch, dev)
    phase(f"  one edited AFHQ UNet eval at batch 1: {sum(seen_afhq['group_norm_afhq'].values())} "
          f"group_norm calls over {len(seen_afhq['group_norm_afhq'])} shapes, "
          f"{sum(seen_afhq['attention_mh'].values())} multi-head attention calls; plus the "
          "T = 1024 attention of IMAGENET's 32^2 level (x0); one AFHQ training-mode eval: "
          f"{seen_afhq['train_group_norm_afhq']} group_norm calls "
          f"({sum(seen_afhq['group_norm_bwd_afhq'].values())} with a gradient, over "
          f"{len(seen_afhq['group_norm_bwd_afhq'])} shapes), {seen_afhq['train_attention_mh']} "
          f"multi-head attention calls ({sum(seen_afhq['attention_bwd_mh'].values())} with a "
          "gradient; plus the backward at T = 64 and T = 1024, x0)")
    rows = kernel_rows(torch, dev, {**seen, **seen_afhq})

    os.makedirs(ws_root)
    log = _RunnerLog()
    from asyrp_official_torch.losses.clip_model import CLIP, VIT_B16

    # the random CLIP weights the training phases share
    clip_ckpt = os.path.join(ws_root, "clip_vit_b16_random.pt")
    torch.save(CLIP(VIT_B16, seed=SEED).state_dict(), clip_ckpt)
    logging.getLogger("asyrp_official_torch.runner").addHandler(log)
    try:
        phase("phase 4: serving path through the port's CLI (--run_test, custom.yml 256^2)")
        timings, serve_launches = main_path_phase(torch, card, log, ws_root)
        phase("phase 5: float32 serving chain, kernels vs plain versions")
        ws = os.path.join(ws_root, "float32")
        chain_err, chain_ms, per_request, served = chain_phase(
            torch, dev, card, ws, serve_argv(ws, False), CONFIG, "smoke_delta.pth",
            f"CUSTOM_test_t999_nim2_ninv{STEPS}_pairs.npz")
        phase("phase 6: where the time goes in one UNet eval at batch 1 (torch.profiler)")
        profile = profile_phase(torch, dev, card, served)
        del served
        torch.cuda.empty_cache()
        phase("phase 7: training path through the port's CLI (--run_train --train_delta_block, "
              "CLIP directional loss, custom.yml 256^2)")
        training, train_launches = train_phase(torch, card, log, ws_root, clip_ckpt)
        phase("phase 8: OpenAI-family serving through the port's CLI (--run_test, afhq.yml "
              "256^2, --model_path of a perturbed AFHQ .pt)")
        afhq_root = os.path.join(ws_root, "afhq")
        model_path = make_afhq_workspace(torch, afhq_root, os.environ["ASYRP_TPU_DATA"])
        afhq_timings, afhq_launches = afhq_phase(torch, card, log, afhq_root, model_path)
        ws = os.path.join(afhq_root, "float32")
        phase("  the float32 AFHQ serving chain, kernels vs plain versions:")
        afhq_chain_err, afhq_chain_ms, afhq_per_request, afhq_served = chain_phase(
            torch, dev, card, ws, afhq_argv(ws, model_path), AFHQ_CONFIG, "afhq_delta.pth",
            f"AFHQ_test_t999_nim2_ninv{STEPS}_pairs.npz", eps_check=True)
        phase("  where the time goes in one AFHQ UNet eval at batch 1 (torch.profiler):")
        afhq_profile = profile_phase(torch, dev, card, afhq_served)
        del afhq_served
        torch.cuda.empty_cache()
        phase("phase 9: OpenAI-family training through the port's CLI (--run_train "
              f"--train_delta_block, CLIP directional loss, {AFHQ_ATTR}, afhq.yml 256^2, the "
              "perturbed AFHQ .pt)")
        afhq_training, afhq_train_launches = afhq_train_phase(
            torch, card, log, afhq_root, os.environ["ASYRP_TPU_DATA"], model_path, clip_ckpt)
    finally:
        shutil.rmtree(ws_root, ignore_errors=True)

    runs = {"custom.yml serving float32": serve_launches,
            "custom.yml training float32": train_launches,
            **{f"afhq.yml serving {k}": v for k, v in afhq_launches.items()},
            "afhq.yml training float32": afhq_train_launches}
    afhq_f32, afhq_ddpm = afhq_launches["float32"], afhq_launches["ddpm float32"]
    gn_ref = ("asyrp_official_tpu/models/common.py:147 (group_norm; _gn_silu at "
              "models/ddpmpp.py:182; former Pallas ops/groupnorm.py:80 at 4b63bc3^)")
    attn_ref = ("asyrp_official_tpu/models/common.py:238 (spatial_attention; former Pallas "
                "ops/attention.py:82 at 4b63bc3^)")
    meta = {  # row: (route, source, replaces, counter, launches of its path's run)
        "group_norm": ("cuda", "asyrp_official_torch/csrc/groupnorm.cu", gn_ref, "group_norm",
                       serve_launches),
        "group_norm_bwd": ("cuda", "asyrp_official_torch/csrc/groupnorm.cu",
                           "asyrp_official_tpu/models/common.py:147 (group_norm's gradient; "
                           "former jax.custom_vjp ops/groupnorm.py:105-127 at 4b63bc3^)",
                           "group_norm_bwd", train_launches),
        "attention": ("cuda", "asyrp_official_torch/csrc/attention.cu", attn_ref, "attention",
                      serve_launches),
        "attention_bwd": ("cuda", "asyrp_official_torch/csrc/attention.cu",
                          "asyrp_official_tpu/models/common.py:238 (spatial_attention's gradient; "
                          "former jax.custom_vjp ops/attention.py:98-125 at 4b63bc3^)",
                          "attention_bwd", train_launches),
        "ddim_step": ("triton", "asyrp_official_torch/ops/ddim_step.py",
                      "asyrp_official_tpu/core/ddim.py:33 (ddim_step; XLA on the TPU)",
                      "ddim_step", serve_launches),
        "group_norm_afhq": ("cuda", "asyrp_official_torch/csrc/groupnorm.cu",
                            gn_ref[:-1] + "; eps 1e-5, and group_norm_1d at models/common.py:170 "
                            "for the attention norms)", "group_norm", afhq_f32),
        "attention_mh": ("cuda", "asyrp_official_torch/csrc/attention.cu",
                         attn_ref[:-1] + " with num_heads=8, legacy_scale=True, called from "
                         "models/openai_unet.py:286)", "attention_mh", afhq_f32),
        "ddim_step_learn_sigma": ("triton", "asyrp_official_torch/ops/ddim_step.py",
                                  "asyrp_official_tpu/core/ddim.py:33 (ddim_step on the learn_sigma "
                                  "split of core/sampler.py:115-122; XLA on the TPU)", "ddim_step",
                                  afhq_f32),
        "ddpm_step": ("triton", "asyrp_official_torch/ops/ddpm_step.py",
                      "asyrp_official_tpu/core/ddim.py:94 (ddpm_step; XLA on the TPU)",
                      "ddpm_step", afhq_ddpm),
        "group_norm_bwd_afhq": ("cuda", "asyrp_official_torch/csrc/groupnorm.cu",
                                "asyrp_official_tpu/models/common.py:147 (group_norm's gradient "
                                "at eps 1e-5, with and without SiLU; former jax.custom_vjp "
                                "ops/groupnorm.py:105-127 at 4b63bc3^)", "group_norm_bwd",
                                afhq_train_launches),
        "attention_bwd_mh": ("cuda", "asyrp_official_torch/csrc/attention.cu",
                             "asyrp_official_tpu/models/common.py:238 (the gradient XLA derives "
                             "for spatial_attention with num_heads=8, legacy_scale=True, called "
                             "from models/openai_unet.py:286; the former jax.custom_vjp "
                             "ops/attention.py:98-125 at 4b63bc3^ had one head)",
                             "attention_mh_bwd", afhq_train_launches),
    }
    kernels = []
    for name, (route, source, replaces, counter, launches) in meta.items():
        r = rows[name]
        f32 = r["float32"]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[counter],
            "launches_by_run": {k: v[counter] for k, v in runs.items()},
            "max_abs_err": max(v["max_abs_err"] for v in r.values()),
            "max_rel_err_by_dtype": {d: v["max_rel_err"] for d, v in r.items()},
            "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "calls_per_eval": f32["calls"],
            "by_dtype": {d: {k: v[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "device_ms", "plain_device_ms",
                                               "library_device_ms", "library_profiled_ms",
                                               "profiled_ms")
                             if k in v} for d, v in r.items()},
        })
    summary = {"card": card, "attention_sass": sass, "serving": timings,
               "invert_edit_chain_ms_best_of_2": chain_ms,
               "chain_rel_err": chain_err, "launches_per_invert_edit_chain": per_request,
               "profile": profile, "training": training,
               "afhq": {"serving": afhq_timings, "launches": afhq_launches,
                        "invert_edit_chain_ms_best_of_2": afhq_chain_ms,
                        "chain_rel_err": afhq_chain_err,
                        "launches_per_invert_edit_chain": afhq_per_request,
                        "profile": afhq_profile, "training": afhq_training},
               "seconds": time.perf_counter() - t_start}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
