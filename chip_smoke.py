#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels K1 (GroupNorm+SiLU, with K1-bwd) and K2
     (attention, with K2-bwd) with nvcc for sm_90a, one nvcc per source, all
     started together; K3 (DDIM step, Triton) compiles at its first launch;
  3. each kernel against its plain PyTorch version on the card, in float32
     and bfloat16: the forwards at every shape the serving path gives them
     (recorded from one edited UNet eval of the full-width CelebA-HQ DDPM++
     UNet), the backwards at every shape the training path gives them
     (recorded from one training-mode eval: the edited decode and the
     DeltaBlock) against `torch.autograd.grad` through the plain forward.
     Per row: median CUDA-event times of the kernel, the plain version and
     the one PyTorch call that computes the same function, and the bound
     (the least time the card could take for the row's bytes or operations);
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
T_EDIT, T_ADDNOISE = 513, 167
SEED = 1234
TOL = {"group_norm": {"float32": 1e-5, "bfloat16": 2e-2},
       "attention": {"float32": 1e-5, "bfloat16": 2e-2},
       "group_norm_bwd": {"float32": 1e-4, "bfloat16": 5e-2},
       "attention_bwd": {"float32": 1e-4, "bfloat16": 5e-2},
       "ddim_step": {"float32": 1e-6}}
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

    return {"group_norm": k1.group_norm.launches, "group_norm_bwd": k1.group_norm.bwd_launches,
            "attention": k2.attention.launches, "attention_bwd": k2.attention.bwd_launches,
            "ddim_step": k3.ddim_step.launches}


def zero_counters() -> None:
    from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1

    k1.group_norm.launches = k1.group_norm.bwd_launches = 0
    k2.attention.launches = k2.attention.bwd_launches = 0
    k3.ddim_step.launches = 0


def plain_versions():
    """Every kernel's wrapper replaced by its plain version (autograd then
    differentiates the plain forward)."""
    from contextlib import ExitStack
    from unittest import mock

    from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1

    stack = ExitStack()
    stack.enter_context(mock.patch.object(k1, "group_norm", k1.group_norm_plain))
    stack.enter_context(mock.patch.object(k2, "attention", k2.attention_plain))
    stack.enter_context(mock.patch.object(k3, "ddim_step", k3.ddim_step_plain))
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

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    out = {n: {} for n in ("group_norm", "group_norm_bwd", "attention", "attention_bwd",
                           "ddim_step")}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.tensor([], dtype=dtype).element_size()
        for name in ("group_norm", "group_norm_bwd", "attention", "attention_bwd"):
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0, "max_rel_err": 0.0, "calls": 0}
            bound_ms_by = {"bytes": 0.0, "operations": 0.0}
            for key, count in sorted(seen[name].items()):
                if name == "group_norm":
                    shape, silu = key
                    x = (randn(*shape) * 2.0 + 0.5).to(dtype)
                    w, b = 1.0 + 0.1 * randn(shape[1]), 0.1 * randn(shape[1])
                    wl, bl = w.to(dtype), b.to(dtype)
                    run_k = lambda: k1.group_norm(x, w, b, silu=silu)
                    run_p = lambda: k1.group_norm_plain(x, w, b, silu=silu)
                    lib = lambda: (F.silu(F.group_norm(x, 32, wl, bl, 1e-6)) if silu
                                   else F.group_norm(x, 32, wl, bl, 1e-6))
                    got, want = [run_k()], [run_p()]
                    n = x.numel()
                    b_ms, b_by = bound(2 * n * es + 2 * shape[1] * 4, n * (8 + 4 * silu),
                                       PEAK_FLOPS["float32"])
                    label = f"{list(shape)} silu={int(silu)}"
                elif name == "group_norm_bwd":
                    shape, silu, wgrad = key
                    x = (randn(*shape) * 2.0 + 0.5).to(dtype).requires_grad_()
                    w = (1.0 + 0.1 * randn(shape[1])).requires_grad_(wgrad)
                    b = (0.1 * randn(shape[1])).requires_grad_(wgrad)
                    dy = randn(*shape, dtype=dtype)
                    ins = (x, w, b) if wgrad else (x,)
                    want = torch.autograd.grad(k1.group_norm_plain(x, w, b, silu=silu), ins, dy)
                    got = torch.autograd.grad(k1.group_norm(x, w, b, silu=silu), ins, dy)
                    mean, rstd = gn_stats(x.detach())
                    xd = x.detach()
                    run_k = lambda: k1.group_norm_backward(xd, dy, w, b, mean, rstd, silu=silu,
                                                           weight_grad=wgrad)
                    run_p = lambda: k1.group_norm_backward_plain(xd, dy, w, b, mean, rstd,
                                                                 silu=silu, weight_grad=wgrad)
                    wl = w.detach().to(dtype).requires_grad_(wgrad)
                    bl = b.detach().to(dtype).requires_grad_(wgrad)
                    y_lib = F.group_norm(x, 32, wl, bl, 1e-6)
                    y_lib = F.silu(y_lib) if silu else y_lib
                    ins_lib = (x, wl, bl) if wgrad else (x,)
                    lib = lambda: torch.autograd.grad(y_lib, ins_lib, dy, retain_graph=True)
                    n = x.numel()
                    b_ms, b_by = bound(3 * n * es + (4 if wgrad else 2) * shape[1] * 4,
                                       n * (14 + 10 * silu + 3 * wgrad), PEAK_FLOPS["float32"])
                    label = f"{list(shape)} silu={int(silu)} dweight={int(wgrad)}"
                elif name == "attention":
                    q, kk, v = (randn(*key, dtype=dtype) for _ in range(3))
                    bsz, t_len, c = key
                    run_k = lambda: k2.attention(q, kk, v)
                    run_p = lambda: k2.attention_plain(q, kk, v)
                    lib = lambda: F.scaled_dot_product_attention(q, kk, v, scale=c ** -0.5)
                    got, want = [run_k()], [run_p()]
                    b_ms, b_by = bound(4 * bsz * t_len * c * es, 4 * bsz * t_len * t_len * c,
                                       PEAK_FLOPS[dname])
                    label = f"{list(key)}"
                else:
                    q, kk, v = (randn(*key, dtype=dtype).requires_grad_() for _ in range(3))
                    d_o = randn(*key, dtype=dtype)
                    bsz, t_len, c = key
                    want = torch.autograd.grad(k2.attention_plain(q, kk, v), (q, kk, v), d_o)
                    got = torch.autograd.grad(k2.attention(q, kk, v), (q, kk, v), d_o)
                    qd, kd, vd = q.detach(), kk.detach(), v.detach()
                    o = k2.attention_plain(qd, kd, vd)
                    lse = torch.logsumexp(torch.matmul(qd.float(), kd.float().transpose(1, 2))
                                          * c ** -0.5, dim=-1)
                    run_k = lambda: k2.attention_backward(qd, kd, vd, o, d_o, lse)
                    run_p = lambda: k2.attention_backward_plain(qd, kd, vd, o, d_o, lse)
                    o_lib = F.scaled_dot_product_attention(q, kk, v, scale=c ** -0.5)
                    lib = lambda: torch.autograd.grad(o_lib, (q, kk, v), d_o, retain_graph=True)
                    b_ms, b_by = bound(8 * bsz * t_len * c * es + 4 * bsz * t_len,
                                       10 * bsz * t_len * t_len * c, PEAK_FLOPS[dname])
                    label = f"{list(key)}"
                torch.cuda.synchronize()
                abs_err = rel_err = 0.0
                for g_, w_ in zip(got, want):
                    if not torch.isfinite(g_.float()).all():
                        fail(f"{name} {label} {dname}: non-finite output")
                    a_, r_ = errs(g_.float(), w_.float())
                    abs_err, rel_err = max(abs_err, a_), max(rel_err, r_)
                ms_k, ms_p, ms_l = time_ms(run_k), time_ms(run_p), time_ms(lib)
                tol = TOL[name][dname]
                ok = rel_err <= tol
                phase(f"  {name} {dname} {label} x{count}: rel err {rel_err:.3e} (tol {tol:g}) "
                      f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, library {ms_l:.4f} ms, "
                      f"bound {b_ms:.4f} ms ({b_by}){'' if ok else '  <-- FAIL'}")
                if not ok:
                    fail(f"{name} {label} {dname} disagrees with its plain version: {rel_err:.3e}")
                for k_, v_ in (("ms", ms_k), ("plain_ms", ms_p), ("library_ms", ms_l),
                               ("bound_ms", b_ms)):
                    tot[k_] += v_ * count
                tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
                tot["max_rel_err"] = max(tot["max_rel_err"], rel_err)
                bound_ms_by[b_by] += b_ms * count
                tot["calls"] += count
            # what bounds most of the eval's bound time
            tot["bound_by"] = max(bound_ms_by, key=bound_ms_by.get)
            out[name][dname] = tot
            phase(f"  {name} {dname}: {tot['calls']} calls per eval take {tot['ms']:.3f} ms "
                  f"(kernel) vs {tot['plain_ms']:.3f} ms (plain), {tot['library_ms']:.3f} ms "
                  f"(library), bound {tot['bound_ms']:.3f} ms")

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


def write_images(ws: str, n: int = 2) -> str:
    import numpy as np
    from PIL import Image

    imgs = os.path.join(ws, "imgs")
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
        fwd = {k: counts[k] for k in ("group_norm", "attention", "ddim_step")}
        if not all(fwd.values()):
            fail(f"serving path ({dname}) did not launch every kernel: {counts}")
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


def chain_phase(torch, dev, card, ws_root):
    """The float32 serving chain with kernels vs plain versions on the card."""
    import numpy as np

    from asyrp_official_torch import uniform_seq
    from asyrp_official_torch.cli.main import build_parser, load_config
    from asyrp_official_torch.models.delta import EditState
    from asyrp_official_torch.pipelines import engine
    from asyrp_official_torch.runner import AsyrpRunner

    ws = os.path.join(ws_root, "float32")
    args = build_parser().parse_args(serve_argv(ws, False))
    runner = AsyrpRunner(args, load_config(CONFIG), work_dir=ws)
    model = runner.load_pretrained()
    edit = EditState(blocks=(runner._load_blocks(os.path.join(ws, "checkpoint", "smoke_delta.pth")),),
                     hs_coeff=torch.tensor([1.0, 1.0], device=dev))
    x0 = np.load(os.path.join(ws, "precomputed",
                              f"CUSTOM_test_t999_nim2_ninv{STEPS}_pairs.npz"))["x0"][:1]
    x0 = torch.from_numpy(x0).to(dev)
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


def trained_block(ws: str, exp: str):
    from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint

    path = os.path.join(ws, "checkpoint", f"{exp}_LC_CUSTOM_t999_ninv{STEPS}_ngen{STEPS}_1.pth")
    if not os.path.exists(path):
        fail(f"training wrote no checkpoint {path}")
    return load_delta_checkpoint(path)["blocks"][0]


def train_phase(torch, card, log, ws_root):
    """Phase 7: Δ-training through the port's CLI, float32 and bfloat16,
    then the float32 run again with the plain versions."""
    import numpy as np
    from PIL import Image

    from asyrp_official_torch.cli.main import load_config, main as cli_main
    from asyrp_official_torch.losses.clip_model import CLIP, VIT_B16
    from asyrp_official_torch.models.delta import delta_block_init
    from asyrp_official_torch.utils import hostrng
    from asyrp_official_torch.models.registry import spec_from_config

    # each run has a work dir of its own (its own latents cache); they share
    # the images and the random CLIP weights
    imgs = write_images(os.path.join(ws_root, "train"))
    clip_ckpt = os.path.join(ws_root, "train", "clip_vit_b16_random.pt")
    torch.save(CLIP(VIT_B16, seed=SEED).state_dict(), clip_ckpt)
    spec = spec_from_config(load_config(CONFIG))
    init = delta_block_init(hostrng.PRNGKey(SEED), spec.bottleneck_ch, spec.temb_ch)
    n_edit = sum(1 for t in np.linspace(0, 1, STEPS) * 999 if t >= T_EDIT)
    results, blocks, launches = {}, {}, None
    for dname in DTYPES:
        ws, exp = os.path.join(ws_root, "train", dname), f"train_{dname}"
        zero_counters()
        torch.cuda.reset_peak_memory_stats()
        n_logs = len(log.iters)
        t0 = time.perf_counter()
        rc = cli_main(train_argv(ws, imgs, clip_ckpt, exp, bf16=dname == "bfloat16"))
        wall = time.perf_counter() - t0
        counts = counters()
        if rc != 0:
            fail(f"training path ({dname}) exited {rc}")
        if not all(counts.values()):
            fail(f"training path ({dname}) did not launch every kernel: {counts}")
        blocks[dname] = blk = trained_block(ws, exp)
        moved = max(float(np.abs(blk[g][k] - init[g][k]).max()) for g in init for k in init[g])
        if not moved > 0:
            fail(f"training path ({dname}): the DeltaBlock did not move from its init")
        iters = log.iters[n_logs:]
        losses = [float(re.search(r"mean loss (\S+)", m).group(1)) for m in iters]
        if len(losses) != 2 or not all(np.isfinite(losses)):
            fail(f"training path ({dname}): losses {losses} from {iters}")
        timing = [re.search(r"([\d.]+) ms/batch -> ([\d.]+) ms/edit-timestep", m) for m in iters]
        ms_batch, ms_step = (float(timing[-1].group(1)), float(timing[-1].group(2)))
        grids = [os.path.join(r, f) for r, _, fs in os.walk(os.path.join(ws, "runs"))
                 for f in fs if f.startswith("test_")]
        if len(grids) != 1:
            fail(f"training path ({dname}): expected 1 test grid, found {grids}")
        grid = np.asarray(Image.open(grids[0]), np.float32)
        if grid.shape != (IMAGE + 2, IMAGE + 2, 3) or not np.isfinite(grid).all():
            fail(f"training path ({dname}): test grid {grids[0]} has shape {grid.shape}")
        (test_pairs,) = glob.glob(os.path.join(ws, "precomputed", "CUSTOM_test_*_pairs.npz"))
        if not np.isfinite(np.load(test_pairs)["x_lat"]).all():
            fail(f"training path ({dname}): non-finite test latents")
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        results[dname] = {"rc": rc, "losses": losses, "ms_per_batch": ms_batch,
                          "ms_per_edit_timestep": ms_step, "edited_timesteps": n_edit,
                          "run_s": wall, "launches": counts, "peak_gb": peak_gb,
                          "block_max_abs_change": moved}
        if dname == "float32":
            launches = counts
        phase(f"  training path {dname} on {card}: rc 0, losses per iteration {losses}, "
              f"block moved by up to {moved:.3e} from its init, test grid {grid.shape}; "
              f"{ms_batch:.0f} ms/batch -> {ms_step:.1f} ms per edited timestep ({n_edit} per "
              f"batch, 2nd iteration, origin cache on); launches {counts}; peak device memory "
              f"{peak_gb:.2f} GiB; whole CLI run {wall:.1f} s")

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

    check = gradient_check(torch, ws_f32, imgs, clip_ckpt)
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
    results["float32_vs_plain"] = {"whole_block_rel_err": whole, "update_rel_err": update,
                                   "plain_run_s": plain_s}
    results["gradient_check"] = check
    return results, launches


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


def gradient_check(torch, ws: str, imgs: str, clip_ckpt: str):
    """The gradient with respect to a freshly initialized DeltaBlock of the
    first edited timestep's CLIP term plus a fixed random linear functional
    of x0_t, through the full-width UNet and K3's backward, with the kernels
    and with the plain versions, from the float32 run's latents, in float32
    and bfloat16. The functional stands in for the L1 term: at the first
    step eps_mod - eps is a small difference of large outputs, and the L1
    term's sign flips on the elements where it is within float noise, while
    the functional sends a fixed cotangent down the same backward path.
    cuDNN runs its deterministic algorithms for the comparison, so the
    kernels are the only difference. Two planted faults in K1-bwd (its
    weight gradient, and its input gradient, scaled by 1.01) show that the
    float32 gate sees a 1% error.

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
    from asyrp_official_torch.ops import ddim_step as k3, groupnorm as k1
    from asyrp_official_torch.runner import AsyrpRunner

    args = build_parser().parse_args(train_argv(ws, imgs, clip_ckpt, "train_float32"))
    dev = torch.device(DEVICE)
    ctx = build_contexts(args, dev)
    runner = AsyrpRunner(args, load_config(CONFIG), clip_ctx=ctx, work_dir=ws)
    runner.set_interval()
    model = runner.load_pretrained()
    pairs = runner.get_pairs(model, "train")  # the run's cache
    x = torch.from_numpy(pairs["x_lat"][:1]).to(dev)
    x0 = torch.from_numpy(pairs["x0"][:1]).to(dev)
    seq, seq_next = train_seq(STEPS, 999, T_EDIT)
    acp = torch.from_numpy(runner.schedule.alphas_cumprod_ext).to(dev)
    extra = train_clip_term(ctx, runner.src_txts[0], runner.trg_txts[0], 1.0)
    cotangent = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)

    (block,) = init_delta_blocks(SEED, 1, runner.spec.bottleneck_ch, runner.spec.temb_ch)
    block = block.to(dev).train()
    edit = EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0], device=dev))

    def coeffs(i):  # the i-th edited timestep from the top, as the generation table runs them
        t, t_next = seq[-1 - i], seq_next[-1 - i]
        return (torch.full((1,), float(t), device=dev), acp[t + 1].reshape(1),
                acp[t_next + 1].reshape(1))

    t_b, at, at_next = coeffs(0)

    def grads(dtype, clip: bool = True):  # the block's weights stay as initialized
        block.zero_grad(set_to_none=True)
        eps, eps_mod, _, _ = runner.spec.apply(model, x.to(dtype), t_b, edit=edit,
                                               decode_mode="split")
        _, x0_t = k3.ddim_step(x, eps.float(), eps_mod.float(), at, at_next, 0.0)
        loss = (x0_t * cotangent).mean()
        (loss + extra(x0, x0_t) if clip else loss).backward()
        return {k: p.grad.detach().float().cpu().numpy() for k, p in block.named_parameters()}

    def rel(a, b):
        return {k: float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)) for k in b}

    def k1_bwd_fault(d_weight: float, d_x: float):
        real = k1.group_norm_backward

        def bwd(*a, **kw):
            dx, dw, db = real(*a, **kw)
            return dx * d_x, None if dw is None else dw * d_weight, db
        return mock.patch.object(k1, "group_norm_backward", bwd)

    out = {"launches": {}, "planted_faults": {}, "profile": {}}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        zero_counters()
        kernels = grads(torch.float32)
        out["launches"]["float32"] = counters()  # one edited timestep, forward and backward
        with plain_versions():
            plain = grads(torch.float32)
        out["float32"] = rel(kernels, plain)
        for label, fault in (("K1-bwd dweight x 1.01", (1.01, 1.0)),
                             ("K1-bwd dx x 1.01", (1.0, 1.01))):
            with k1_bwd_fault(*fault):
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
                eps, eps_mod, _, _ = runner.spec.apply(model, carry.to(dtype), t_i, edit=e,
                                                       decode_mode="split")
                x_next, x0_origin = k3.ddim_step(carry, eps.float(), eps.float(), a_i, an_i, 0.0)
                _, x0_t = k3.ddim_step(carry, eps.float(), eps_mod.float(), a_i, an_i, 0.0)
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


def build_kernels() -> None:
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(REPO, "asyrp_official_torch")):
        fail(f"no asyrp_official_torch package beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, REPO)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    phase(f"phase 1: card {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    build_kernels()

    phase("phase 3: kernels against their plain versions (ms = median of 25 CUDA-event runs)")
    seen = record_path_shapes(torch, dev)
    phase(f"  one edited UNet eval at batch 1: {sum(seen['group_norm'].values())} group_norm "
          f"calls over {len(seen['group_norm'])} shapes, {sum(seen['attention'].values())} "
          f"attention calls over {len(seen['attention'])} shapes; one training-mode eval: "
          f"{seen['train_group_norm']} group_norm calls ({sum(seen['group_norm_bwd'].values())} "
          f"with a gradient, over {len(seen['group_norm_bwd'])} shapes), "
          f"{seen['train_attention']} attention calls "
          f"({sum(seen['attention_bwd'].values())} with a gradient)")
    rows = kernel_rows(torch, dev, seen)

    ws_root = os.path.join(REPO, "runs", f"chip_smoke_{os.getpid()}")
    os.makedirs(ws_root)
    log = _RunnerLog()
    logging.getLogger("asyrp_official_torch.runner").addHandler(log)
    try:
        phase("phase 4: serving path through the port's CLI (--run_test, custom.yml 256^2)")
        timings, serve_launches = main_path_phase(torch, card, log, ws_root)
        phase("phase 5: float32 serving chain, kernels vs plain versions")
        chain_err, chain_ms, per_request, served = chain_phase(torch, dev, card, ws_root)
        phase("phase 6: where the time goes in one UNet eval at batch 1 (torch.profiler)")
        profile = profile_phase(torch, dev, card, served)
        del served
        torch.cuda.empty_cache()
        phase("phase 7: training path through the port's CLI (--run_train --train_delta_block, "
              "CLIP directional loss, custom.yml 256^2)")
        training, train_launches = train_phase(torch, card, log, ws_root)
    finally:
        shutil.rmtree(ws_root, ignore_errors=True)

    meta = {
        "group_norm": ("cuda", "asyrp_official_torch/csrc/groupnorm.cu",
                       "asyrp_official_tpu/models/common.py:147 (group_norm; _gn_silu at "
                       "models/ddpmpp.py:182; former Pallas ops/groupnorm.py:80 at 4b63bc3^)",
                       serve_launches),
        "group_norm_bwd": ("cuda", "asyrp_official_torch/csrc/groupnorm.cu",
                           "asyrp_official_tpu/models/common.py:147 (group_norm's gradient; "
                           "former jax.custom_vjp ops/groupnorm.py:105-127 at 4b63bc3^)",
                           train_launches),
        "attention": ("cuda", "asyrp_official_torch/csrc/attention.cu",
                      "asyrp_official_tpu/models/common.py:238 (spatial_attention; former "
                      "Pallas ops/attention.py:82 at 4b63bc3^)", serve_launches),
        "attention_bwd": ("cuda", "asyrp_official_torch/csrc/attention.cu",
                          "asyrp_official_tpu/models/common.py:238 (spatial_attention's gradient; "
                          "former jax.custom_vjp ops/attention.py:98-125 at 4b63bc3^)",
                          train_launches),
        "ddim_step": ("triton", "asyrp_official_torch/ops/ddim_step.py",
                      "asyrp_official_tpu/core/ddim.py:33 (ddim_step; XLA on the TPU)",
                      serve_launches),
    }
    kernels = []
    for name, (route, source, replaces, launches) in meta.items():
        r = rows[name]
        f32 = r["float32"]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name],
            "launches_serving_f32": serve_launches[name],
            "launches_training_f32": train_launches[name],
            "max_abs_err": max(v["max_abs_err"] for v in r.values()),
            "max_rel_err_by_dtype": {d: v["max_rel_err"] for d, v in r.items()},
            "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "calls_per_eval": f32["calls"],
            "by_dtype": {d: {k: v[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")} for d, v in r.items()},
        })
    summary = {"card": card, "serving": timings, "invert_edit_chain_ms_best_of_2": chain_ms,
               "chain_rel_err": chain_err, "launches_per_invert_edit_chain": per_request,
               "profile": profile, "training": training,
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
