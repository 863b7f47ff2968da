#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels K1 (GroupNorm+SiLU) and K2 (attention) with
     nvcc for sm_90a; K3 (DDIM step, Triton) compiles at its first launch;
  3. each kernel against its plain PyTorch version on the card, at every
     shape the serving path gives it (recorded from one edited UNet eval of
     the full-width CelebA-HQ DDPM++ UNet), in float32 and bfloat16, with
     median CUDA-event times of kernel and plain version;
  4. the main path through the port's CLI, in-process: `--run_test` on
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
     family, kernel count, and the device's idle share.
The float32 runs use full float32 convolutions and matmuls (TF32 off), as
the port's runner sets it on CUDA.

Needs a CUDA device and this repository around the script. Prints the
`nvidia-smi` line and a JSON line of per-kernel results before the last
line, which is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import logging
import os
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
       "ddim_step": {"float32": 1e-6}}
CHAIN_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|, in float64 on the host."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


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


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def record_path_shapes(torch, dev):
    """Shapes and call counts each kernel sees in one edited UNet eval at
    batch 1 (dual decode), recorded with the plain versions standing in."""
    from unittest import mock

    from asyrp_official_torch.models.ddpmpp import CELEBA_CONFIG, DDPMpp
    from asyrp_official_torch.models.delta import DeltaBlock, EditState
    from asyrp_official_torch.ops import attention as k2, groupnorm as k1

    seen = {"group_norm": {}, "attention": {}}

    def gn(x, w, b, **kw):
        key = (tuple(x.shape), kw.get("silu", False))
        seen["group_norm"][key] = seen["group_norm"].get(key, 0) + 1
        return k1.group_norm_plain(x, w, b, **kw)

    def attn(q, k, v):
        key = tuple(q.shape)
        seen["attention"][key] = seen["attention"].get(key, 0) + 1
        return k2.attention_plain(q, k, v)

    torch.manual_seed(0)
    model = DDPMpp(CELEBA_CONFIG).to(dev).eval()
    block = DeltaBlock(CELEBA_CONFIG.bottleneck_ch, CELEBA_CONFIG.temb_ch).to(dev).eval()
    edit = EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0], device=dev))
    x = torch.randn(1, 256, 256, 3, device=dev)
    t = torch.full((1,), 500.0, device=dev)
    with torch.no_grad(), mock.patch.object(k1, "group_norm", gn), \
            mock.patch.object(k2, "attention", attn):
        model.apply(x, t, edit=edit)
    del model, block
    torch.cuda.empty_cache()
    return seen


def kernel_phase(torch, dev, results):
    from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1

    phase("phase 3: kernels against their plain versions (ms = median of 25 CUDA-event runs)")
    seen = record_path_shapes(torch, dev)
    n_gn = sum(seen["group_norm"].values())
    n_at = sum(seen["attention"].values())
    phase(f"  one edited UNet eval at batch 1: {n_gn} group_norm calls over "
          f"{len(seen['group_norm'])} shapes, {n_at} attention calls over "
          f"{len(seen['attention'])} shapes")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for name in ("group_norm", "attention"):
        res = results[name]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            tot_k = tot_p = 0.0
            for key, count in sorted(seen[name].items()):
                if name == "group_norm":
                    shape, silu = key
                    x = (randn(*shape) * 2.0 + 0.5).to(dtype)
                    w = 1.0 + 0.1 * randn(shape[1])
                    b = 0.1 * randn(shape[1])
                    run_k = lambda: k1.group_norm(x, w, b, silu=silu)
                    run_p = lambda: k1.group_norm_plain(x, w, b, silu=silu)
                    label = f"{list(shape)} silu={int(silu)}"
                else:
                    q, kk, v = (randn(*key, dtype=dtype) for _ in range(3))
                    run_k = lambda: k2.attention(q, kk, v)
                    run_p = lambda: k2.attention_plain(q, kk, v)
                    label = f"{list(key)}"
                out_k = run_k()
                torch.cuda.synchronize()
                err = rel_err(out_k.float(), run_p().float())
                if not torch.isfinite(out_k.float()).all():
                    fail(f"{name} {label} {dname}: non-finite output")
                ms_k, ms_p = time_ms(run_k), time_ms(run_p)
                tot_k += ms_k * count
                tot_p += ms_p * count
                res["max_err"][dname] = max(res["max_err"].get(dname, 0.0), err)
                ok = err <= TOL[name][dname]
                phase(f"  {name} {dname} {label} x{count}: rel err {err:.3e} "
                      f"(tol {TOL[name][dname]:g}) kernel {ms_k:.4f} ms plain {ms_p:.4f} ms"
                      f"{'' if ok else '  <-- FAIL'}")
                if not ok:
                    fail(f"{name} {label} {dname} disagrees with its plain version: {err:.3e}")
            res["ms"][dname], res["plain_ms"][dname] = tot_k, tot_p
            phase(f"  {name} {dname}: one UNet eval's calls take {tot_k:.3f} ms (kernel) vs "
                  f"{tot_p:.3f} ms (plain)")

    res = results["ddim_step"]
    shape = (1, 256, 256, 3)
    x, eps, eps_mod, noise = (randn(*shape) for _ in range(4))
    cases = [  # (label, at, at_next, eta, noise, dt_lambda, apply_dt)
        ("generation eta=0", 0.30, 0.35, 0.0, None, 1.0, None),
        ("generation eta=1", 0.80, 0.85, 1.0, noise, 1.0, None),
        ("t_next=-1 eta=1", 0.9999, 1.0, 1.0, noise, 1.0, None),
        ("inversion", 0.35, 0.30, 0.0, None, 1.0, None),
        ("dt_lambda", 0.30, 0.35, 0.0, None, 0.9, torch.ones(1, device=dev)),
    ]
    for label, a, an, eta, z, dtl, adt in cases:
        a_t = torch.tensor([a], device=dev)
        an_t = torch.tensor([an], device=dev)
        eta_t = torch.tensor([eta], device=dev)
        run_k = lambda: k3.ddim_step(x, eps, eps_mod, a_t, an_t, eta_t, z, dt_lambda=dtl, apply_dt=adt)
        run_p = lambda: k3.ddim_step_plain(x, eps, eps_mod, a_t, an_t, eta_t, z, dt_lambda=dtl,
                                           apply_dt=adt)
        xn_k, x0_k = run_k()
        xn_p, x0_p = run_p()
        err = max(rel_err(xn_k, xn_p), rel_err(x0_k, x0_p))
        ms_k, ms_p = time_ms(run_k), time_ms(run_p)
        res["max_err"]["float32"] = max(res["max_err"].get("float32", 0.0), err)
        if label == "generation eta=1":  # the step the eta window runs
            res["ms"]["float32"], res["plain_ms"]["float32"] = ms_k, ms_p
        ok = err <= TOL["ddim_step"]["float32"]
        phase(f"  ddim_step float32 {list(shape)} {label}: rel err {err:.3e} (tol 1e-06) "
              f"kernel {ms_k:.4f} ms plain {ms_p:.4f} ms{'' if ok else '  <-- FAIL'}")
        if not ok:
            fail(f"ddim_step {label} disagrees with its plain version: {err:.3e}")


class _GridLog(logging.Handler):
    """Collects the runner's per-grid serving record."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        if record.getMessage().startswith("serving on"):
            self.records.append(record.args)


def make_workspace(ws: str, torch) -> None:
    import numpy as np
    from PIL import Image

    from asyrp_official_torch.models.delta import delta_block_init
    from asyrp_official_torch.cli.main import load_config
    from asyrp_official_torch.compat import save_delta_checkpoint
    from asyrp_official_torch.models.hostinit import hostrng
    from asyrp_official_torch.models.registry import spec_from_config

    imgs = os.path.join(ws, "imgs")
    os.makedirs(imgs)
    rng = np.random.RandomState(SEED)
    for i in range(2):
        Image.fromarray((rng.rand(IMAGE, IMAGE, 3) * 255).astype(np.uint8)).save(
            os.path.join(imgs, f"{i}.png"))
    spec = spec_from_config(load_config(CONFIG))
    block = delta_block_init(hostrng.PRNGKey(7), spec.bottleneck_ch, spec.temb_ch)
    save_delta_checkpoint(os.path.join(ws, "checkpoint", "smoke_delta.pth"), blocks=[block])


def cli_argv(ws: str, bf16: bool):
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


def main_path_phase(torch, card, results, ws_root):
    import numpy as np
    from PIL import Image

    from asyrp_official_torch.cli.main import main as cli_main
    from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1

    wrappers = {"group_norm": k1.group_norm, "attention": k2.attention, "ddim_step": k3.ddim_step}
    grid_log = _GridLog()
    logging.getLogger("asyrp_official_torch.runner").addHandler(grid_log)
    timings = {}
    for bf16 in (False, True):
        dname = "bfloat16" if bf16 else "float32"
        ws = os.path.join(ws_root, dname)
        os.makedirs(os.path.join(ws, "checkpoint"))
        make_workspace(ws, torch)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        rc = cli_main(cli_argv(ws, bf16))
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        if rc != 0:
            fail(f"main path ({dname}) exited {rc}")
        if not all(launches.values()):
            fail(f"main path ({dname}) did not launch every kernel: {launches}")
        grids = sorted(os.path.join(r, f) for r, _, fs in os.walk(os.path.join(ws, "runs"))
                       for f in fs if f.endswith(".png"))
        if len(grids) != 2:
            fail(f"main path ({dname}): expected 2 grids, found {grids}")
        for g in grids:
            arr = np.asarray(Image.open(g))
            if arr.shape != (2 * IMAGE + 3, IMAGE + 2, 3):
                fail(f"grid {g} has shape {arr.shape}")
        pairs = np.load(os.path.join(ws, "precomputed",
                                     f"CUSTOM_test_t999_nim2_ninv{STEPS}_pairs.npz"))
        for k in ("x_lat", "x_rec"):
            if not np.isfinite(pairs[k]).all():
                fail(f"main path ({dname}): non-finite {k}")
        _, n_grids, first_ms, last_ms, n_chain, _ = grid_log.records[-1]
        per_step = last_ms / (2 * n_chain)
        timings[dname] = {"grid_ms_first": first_ms, "grid_ms": last_ms, "ms_per_step": per_step,
                          "run_s": wall}
        if not bf16:
            results["_launches"] = launches
        phase(f"  main path {dname} on {card}: rc 0, 2 grids, launches {launches}; "
              f"per grid ({n_chain}-step plain + {n_chain}-step edited generation, bs 1): "
              f"first {first_ms:.1f} ms, second {last_ms:.1f} ms = {per_step:.2f} ms/step; "
              f"whole CLI run incl. init and 2x{STEPS}+{STEPS} precompute steps {wall:.1f} s")
    return timings


def chain_phase(torch, dev, card, ws_root):
    """The float32 serving chain with kernels vs plain versions on the card."""
    from unittest import mock

    import numpy as np

    from asyrp_official_torch import uniform_seq
    from asyrp_official_torch.cli.main import build_parser, load_config
    from asyrp_official_torch.models.delta import EditState
    from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1
    from asyrp_official_torch.pipelines import engine
    from asyrp_official_torch.runner import AsyrpRunner

    ws = os.path.join(ws_root, "float32")
    args = build_parser().parse_args(cli_argv(ws, False))
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
    out_k = run(model, edit, x0, gen())
    counts = (k1.group_norm.launches, k2.attention.launches, k3.ddim_step.launches)
    with mock.patch.object(k1, "group_norm", k1.group_norm_plain), \
            mock.patch.object(k2, "attention", k2.attention_plain), \
            mock.patch.object(k3, "ddim_step", k3.ddim_step_plain):
        out_p = run(model, edit, x0, gen())
    if (k1.group_norm.launches, k2.attention.launches, k3.ddim_step.launches) != counts:
        fail("the plain chain launched a kernel")
    if not (torch.isfinite(out_k).all() and torch.isfinite(out_p).all()):
        fail("non-finite chain output")
    if out_k.shape != (1, IMAGE, IMAGE, 3):
        fail(f"chain output shape {tuple(out_k.shape)}")
    err = rel_err(out_k, out_p)
    phase(f"  float32 invert+edit chain ({STEPS}+{STEPS} steps, bs 1), kernels vs plain: "
          f"rel err {err:.3e} (tol {CHAIN_TOL:g}), output max |x| {float(out_p.abs().max()):.3f}")
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
    return err, chain_ms, (runner.spec, model, edit)


def _kernel_family(name: str) -> str:
    n = name.lower()
    if "gn_stats" in n or "gn_apply" in n:
        return "K1 group_norm"
    if "attn_kernel" in n:
        return "K2 attention"
    if any(s in n for s in ("gemm", "conv", "xmma", "cudnn", "cutlass", "winograd")):
        return "conv/gemm"
    return "other"


def profile_phase(torch, dev, card, served):
    """Where the time goes in one UNet eval at batch 1: wall p50 of 20
    unprofiled evals, then one eval under torch.profiler, whose device
    events give the busy time by kernel family; idle share = 1 - busy /
    that eval's wall."""
    from torch.autograd import DeviceType
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
            fam, n_dev = {}, 0
            for ev in prof.events():
                if ev.device_type != DeviceType.CUDA:
                    continue
                n_dev += 1
                f = _kernel_family(ev.name)
                fam[f] = fam.get(f, 0.0) + ev.time_range.elapsed_us() / 1e3
            busy = sum(fam.values())
            if busy <= 0.0:
                fail(f"profile {dname} {label}: torch.profiler recorded no device time")
            row = {"wall_ms_p50": statistics.median(walls), "profiled_wall_ms": prof_wall,
                   "device_busy_ms": busy, "idle_share": 1.0 - busy / prof_wall,
                   "device_events": n_dev, "ms_by_family": fam}
            rows[f"{dname}_{label}"] = row
            phase(f"  {dname} {label} decode on {card}: wall p50 {row['wall_ms_p50']:.2f} ms; "
                  f"profiled eval wall {prof_wall:.2f} ms, device busy {busy:.2f} ms, idle share "
                  f"{row['idle_share']:.3f}, {n_dev} device events; "
                  + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(fam.items())))
    return rows


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

    from asyrp_official_torch.ops import _build

    t0 = time.perf_counter()
    for name in ("groupnorm", "attention"):
        _build.load_library(name)
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        phase(f"phase 2: built csrc/{name}.cu for sm_90a; ptxas: {' | '.join(ptxas)}")
    phase(f"phase 2: nvcc builds took {time.perf_counter() - t0:.1f} s")

    results = {n: {"max_err": {}, "ms": {}, "plain_ms": {}}
               for n in ("group_norm", "attention", "ddim_step")}
    kernel_phase(torch, dev, results)

    ws_root = os.path.join(REPO, "runs", f"chip_smoke_{os.getpid()}")
    os.makedirs(ws_root)
    try:
        phase("phase 4: main path through the port's CLI (--run_test, custom.yml 256^2)")
        timings = main_path_phase(torch, card, results, ws_root)
        phase("phase 5: float32 serving chain, kernels vs plain versions")
        chain_err, chain_ms, served = chain_phase(torch, dev, card, ws_root)
        phase("phase 6: where the time goes in one UNet eval at batch 1 (torch.profiler)")
        profile = profile_phase(torch, dev, card, served)
    finally:
        shutil.rmtree(ws_root, ignore_errors=True)

    launches = results.pop("_launches")
    meta = {
        "group_norm": ("cuda", "asyrp_official_torch/csrc/groupnorm.cu",
                       "asyrp_official_tpu/models/common.py:147 (group_norm; _gn_silu at "
                       "models/ddpmpp.py:182; former Pallas ops/groupnorm.py:80 at 4b63bc3^)"),
        "attention": ("cuda", "asyrp_official_torch/csrc/attention.cu",
                      "asyrp_official_tpu/models/common.py:238 (spatial_attention; former "
                      "Pallas ops/attention.py:82 at 4b63bc3^)"),
        "ddim_step": ("triton", "asyrp_official_torch/ops/ddim_step.py",
                      "asyrp_official_tpu/core/ddim.py:33 (ddim_step; XLA on the TPU)"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        r = results[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(r["max_err"].values()),
            "max_err_by_dtype": r["max_err"], "ms": r["ms"]["float32"],
            "plain_ms": r["plain_ms"]["float32"], "ms_by_dtype": r["ms"],
            "plain_ms_by_dtype": r["plain_ms"],
        })
    serving = {"card": card, "serving": timings, "invert_edit_chain_ms_best_of_2": chain_ms,
               "chain_rel_err": chain_err, "profile": profile,
               "seconds": time.perf_counter() - t_start}
    print(json.dumps(serving))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
