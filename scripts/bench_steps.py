#!/usr/bin/env python3
"""Device time per call of the DDIM step (K3), its backward (K3-bwd) and the
DDPM step at the paths' shapes, on one NVIDIA GPU:

    python3 scripts/bench_steps.py [--repo DIR] [--out FILE.json]

Rows: [B, 256, 256, 3] with an f32 carry at batch 1 and 8; K3 on a whole
model output (DDPM++) and on the first 3 of a learn_sigma model's 6
channels (AFHQ), f32 and bf16 model output, eta = 1 with noise; the DDPM
step with the learned log-variance; K3's backward as the edited training
step runs it (x0_t's cotangent alone, d eps_mod in the model's dtype, eta
given as the Python number 0.0), timed as `torch.autograd.grad` of a kept
graph. Per row: the max error relative to scale against the plain version
(the backward: against autograd through the plain forward); the device time
per call back to back behind `torch.cuda._sleep` (`chip_smoke.device_ms`),
over sets of inputs that move 4x the L2's bytes in turn
(`chip_smoke.input_sets`, `chip_smoke.in_turn`: every call reads its inputs
from device memory, as the bound counts them), and on one set of inputs
(which the L2 keeps); one call's CUDA-event time, host included
(`chip_smoke.time_ms`), and event minus device (the launch path's host
time); the device kernels per call in torch.profiler; the bound (each input
byte read once, each output byte written once, over 3.35 TB/s). A last row
per batch times torch's own copy of x (`Tensor.copy_`), a floor for one
launch that moves x's bytes. `--repo` takes the package under test
from another checkout (e.g. a parent commit unpacked with `git archive`):
only the public functions are called, so any version of the port runs; the
timers stay this checkout's. Run two checkouts in turns in one call to
compare them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=REPO, help="take asyrp_official_torch from this checkout")
    ap.add_argument("--out", default=None, help="also write the rows as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this benchmark needs an NVIDIA GPU")
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.repo))
    from asyrp_official_torch.ops import ddim_step as k3, ddpm_step as kddpm

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(k3.__file__))))
    if pkg_root != os.path.abspath(args.repo):
        print(f"asyrp_official_torch came from {k3.__file__}, not from {args.repo}")
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    rows = []

    def rel_err(got, want):
        return max(cs.errs(g_.float(), w_.float())[1] for g_, w_ in zip(got, want))

    def row(name, label, fn, make, n_bytes, err):
        """`fn(*set)` timed on sets of inputs that `make()` builds; `err`:
        the caller's check of the kernel against its plain version."""
        sets = cs.input_sets(make, n_bytes)
        run, run_one = cs.in_turn(fn, sets), lambda: fn(*sets[0])
        # back to back; a call that waits for the device (a blocking copy) has
        # no back-to-back time: its device events in torch.profiler stand in
        dev_ms = cs.device_ms(run, required=False)
        l2_ms = cs.device_ms(run_one, required=False)
        prof_ms = cs.profiled_device_ms(run_one)
        ev_ms = cs.time_ms(run)
        kernels, names = cs.device_kernels_per_call(run_one)
        b_ms = n_bytes / cs.HBM_BYTES_PER_S * 1e3
        r = {"kernel": name, "row": label, "rel_err": err, "device_ms": dev_ms,
             "l2_device_ms": l2_ms, "input_sets": len(sets), "profiled_device_ms": prof_ms,
             "event_ms": ev_ms,
             "event_minus_device_ms": None if dev_ms is None else ev_ms - dev_ms,
             "device_kernels_per_call": kernels, "kernel_names": list(names), "bound_ms": b_ms}
        rows.append(r)
        us = lambda v: "not measured" if v is None else f"{v * 1e3:.2f} us"
        print(f"{name} {label}: "
              + ("" if err is None else f"rel err {err:.3e}; ")
              + f"device {us(dev_ms)} back to back over {len(sets)} input sets, {us(l2_ms)} on "
              f"one set (L2), {us(prof_ms)} in torch.profiler's device events on one set; event "
              f"{us(ev_ms)}, event - device {us(r['event_minus_device_ms'])}; "
              + ("device kernels per call not measured" if kernels is None else
                 f"{kernels:g} device kernels per call") + f"; bound {b_ms * 1e3:.2f} us",
              flush=True)

    for batch in (1, 8):
        shape = (batch, 256, 256, 3)
        n = batch * 256 * 256 * 3
        at, an = torch.full((1,), 0.80, device=dev), torch.full((1,), 0.85, device=dev)
        eta, bt = torch.ones(1, device=dev), torch.full((1,), 0.02, device=dev)
        t999 = torch.full((1,), 999.0, device=dev)
        co = (torch.full((1,), 0.30, device=dev), torch.full((1,), 0.35, device=dev), 0.0)
        for dtype in (torch.float32, torch.bfloat16):
            if batch > 1 and dtype != torch.float32:
                continue
            dname = str(dtype).split(".")[-1]
            es = torch.tensor([], dtype=dtype).element_size()

            def whole():
                return (randn(*shape), randn(*shape, dtype=dtype), randn(*shape, dtype=dtype),
                        at, an, eta, randn(*shape))

            def learn_sigma_output():
                raw = randn(*shape[:-1], 6)
                raw[..., 3:] = -2.0 + 0.5 * raw[..., 3:]
                return raw.to(dtype)

            def split():
                r, r_mod = learn_sigma_output(), learn_sigma_output()
                return randn(*shape), r[..., :3], r_mod[..., :3], at, an, eta, randn(*shape)

            def ddpm():
                r = learn_sigma_output()
                return randn(*shape), r[..., :3], r[..., 3:], bt, at, t999, randn(*shape)

            def graph():
                """The edited training step's backward: x0_t's cotangent to eps_mod."""
                x, eps = randn(*shape), randn(*shape, dtype=dtype)
                em = randn(*shape, dtype=dtype).requires_grad_()
                return k3.ddim_step(x, eps, em, *co)[1], em, randn(*shape), x, eps

            def grad(x0_t, em, g, *_):
                return torch.autograd.grad(x0_t, em, g, retain_graph=True)

            for label, make in (("model output", whole), ("learn_sigma output", split)):
                a = make()
                row("K3", f"{list(shape)} {dname} {label}", k3.ddim_step, make,
                    n * (4 + 2 * es + 4 + 8), rel_err(k3.ddim_step(*a), k3.ddim_step_plain(*a)))
            a = ddpm()
            row("ddpm_step", f"{list(shape)} {dname} learn_sigma output, learned logvar",
                kddpm.ddpm_step, ddpm, n * (4 + 2 * es + 4 + 4),
                rel_err((kddpm.ddpm_step(*a),), (kddpm.ddpm_step_plain(*a),)))
            x0_t, em, g, x, eps = graph()
            want = torch.autograd.grad(k3.ddim_step_plain(x, eps, em, *co)[1], em, g)
            row("K3-bwd", f"{list(shape)} {dname} eps, x0_t alone -> d eps_mod", grad, graph,
                n * (4 + es), rel_err(grad(x0_t, em, g), want))
        row("copy", f"{list(shape)} f32, Tensor.copy_", lambda o, x_: o.copy_(x_),
            lambda: (torch.empty(shape, device=dev), randn(*shape)), n * 8, None)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "repo": os.path.abspath(args.repo), "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
