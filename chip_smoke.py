#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels K1 (GroupNorm+SiLU, with K1-bwd), K2
     (attention with one head or several, with K2-bwd), and K3 (the DDIM
     step, with K3-bwd) with the DDPM step (`csrc/steps.cu`), with nvcc for
     sm_90a, one nvcc per source, all started together. Per step entry
     (K3 `ddim_fwd`, K3-bwd `ddim_bwd`, `ddpm_fwd`; per dtype pair and
     instance) its registers, shared memory and spills: a spill fails.
     Per K1 entry (forward `gn_fwd`,
     backward `gn_bwd`; f32 and bf16, 16-byte or scalar vectors, 256 or
     512 threads) its registers, shared memory and spills (the cluster
     size is chosen per call: phase 3 prints it per row). Per attention entry (forward and
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
     check that two calls agree bit for bit. K1's rows include the fused
     serving calls (the pre-add of `h + temb`, the FiLM epilogue), held to
     the plain fused version and to the unfused composition (K1, then the
     torch ops: 1e-6 of scale in f32, one bf16 ulp per element in bf16),
     whose time is the row's library time; every K1 and K1-bwd row checks
     that two calls agree bit for bit, and every K1 forward row that a call
     is at most one device kernel, `gn_fwd`, in torch.profiler (whose
     trace can drop events, never add them); K1 rows print event minus
     device time per call (the launch path's host time). K3, K3-bwd and
     `ddpm_step` rows (batch 1 at the paths' shapes, and batch 8) give the
     same times, run over sets of inputs that move 4x the L2's bytes in
     turn (every call reads from device memory, as the bound counts), the
     kernel's device time on one set (which the L2 keeps), and event minus
     device; they check that two calls agree bit for
     bit, that a call is at most one device kernel of its name in
     torch.profiler, and which instance (flat, rows, scalar) it took;
     K3-bwd's rows (x0_t's cotangent alone to d eps_mod, the training
     step's, and both cotangents to all three gradients) against
     `torch.autograd.grad` through the plain forward;
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
     random ViT-B/16 written by the port's CLIP module) and the L1 term, one
     random image (two until the IMAGENET phase came: cut for the time
     limit), 40-step grids, t_edit 513, 2 iterations at batch 1, then
     the `--do_test` grid; once in float32 and once with --bf16. The launch
     counters (forward and backward, K3-bwd included) are zeroed just
     before each run and must all be > 0 after it. The float32 run is repeated from the same
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
     loss (the random ViT-B/16 of phase 7) and the L1 term, the first of two
     random images as `afhq/train/dog/*.png` (both until phase 14 came: cut
     for the time limit; phase 12 (d) too), 10-step grids (40 until phase
     15 (e)-(f) came: cut for the time limit; phase 12 (d) too), t_edit 513,
     2 iterations at batch 1, then the `--do_test` grid; float32 and --bf16.
     The launch counters are zeroed just before each run and read just
     after: K1, K1-bwd, the multi-head K2 and K2-bwd-MH, K3 and K3-bwd must
     all have launched, the single-head K2 and K2-bwd not at all. The gate of
     K2-bwd-MH is phase 7's gradient check on the AFHQ UNet (1e-3 float32,
     2x in bfloat16), where the cotangents reaching K2-bwd-MH must have a
     norm above 0 and a planted fault (D summed over all C instead of the
     head's d) must fail it.
  10. the h-rows path and the multi-edit serving modes on `custom.yml`
     through the port's CLI, in-process, from phase 7's images and latents
     and the random weights of --seed: (a) `--run_train --train_delta_h
     --delta_injection add` (phase 7's recipe: CLIP and L1, 40-step grids,
     t_edit 513, 2 iterations), float32 and --bf16, K1, K1-bwd, K2, K2-bwd,
     K3 and K3-bwd launched; the float32 run again with the plain versions
     (rows within 1e-3, their update within 5e-2); one timestep's gradient
     w.r.t. the t = 999 row, kernels vs plain (1e-3 float32, 2x in bf16);
     one iteration of `--delta_injection slerp` must save rows bit-identical
     to the init; (b) `--run_test --train_delta_h` on (a)'s rows at 20 test
     steps (the train→test remap), add and slerp; (c) `--multiple_attr
     "smiling angry" --delta_interpolation --num_delta 2` on two seeded
     blocks: 4 coefficient pairs (9 until phase 14 came), one generation
     each, float32 and bf16,
     and the float32 sweep again with the plain versions (1e-3), with the
     wall of each;
     (d) `--num_mean_of_delta_hs 1` with two training images: finite
     harvested rows, then the rest served from them.
  11. M7 on `custom.yml` through the port's CLI, in-process, from phase
     7's images, phase 10's seeded `.pt` and phase 4's block: (a) the LPIPS
     calibration stage (`--lpips`, 2 images, a random AlexNet + lin written
     in the `--lpips_ckpt` npz format) at 25 steps (the recipe runs 1000;
     cut for the time limit: to 200 when phase 12 came, to 100 when phase
     14 came, to 50 when phase 15 came, to 25 when phase 15 (e)-(f) came)
     f32, bf16, and f32 with the plain
     versions (the four curves
     within 1e-3 of scale), f32 at `--bs_train 2` over 5 steps (10 until
     phase 14)
     (cuDNN's f32 FFT path, recorded, not gated); K1, K2 and K3 launched, K3
     exactly once per inversion step and batch; the four tsvs with the
     seq[1:] keys, finite, >= 0; `set_interval` reads the fresh x0_t tsv;
     (b) phase 7's training recipe plus `--id_loss_w 1 --ir_se50_ckpt` (a
     random IR-SE50 under the reference's key names), f32 and bf16 (every
     forward and backward counter > 0), the f32 run against a plain run
     (1e-3 block, 5e-2 update), one timestep's gradient through ID + CLIP
     (+ a fixed functional for L1) at 1e-3 f32 and 2x in bf16, the ID
     term's value and its input gradient > 0 (it reaches no parameter, as
     in the reference), IR-SE50's device ms per timestep; (c)
     `--run_fidelity` with phase 4's block: the plain versions' outputs as
     the reference of the kernels' (mean LPIPS <= 0.01), a self-comparison
     exactly 0.
  12. IMAGENET (`imagenet.yml`: ADM 256^2, 553,838,086 params, 8 heads of
     64 at 32^2 and 16 at 16^2 and 8^2, learn_sigma, class_cond) through the
     port's CLI, in-process: (a) the seeded init with its all-zero layers
     redrawn, saved as a `.pt` without `label_emb.weight` (ADM's released
     unconditional layout), two random 256^2 images per split as
     `imagenet/{val,train}/<wnid>/<wnid>/*.{JPEG,jpeg}` of one class, a Δ
     checkpoint at 1024 channels; (b) `--run_test --target_class_num`, 10 +
     10 steps (40 + 40 until phase 14 came, 20 + 20 until phase 15 came: cut
     for the time limit) at batch 1, float32 and --bf16: K1, the multi-head
     K2 and K3 launched, the one-head K2 never, the latent cache named by
     the class; (c) the float32 invert+edit chain, 10 + 10 steps (40 + 40
     until phase 15 came, 20 + 20 until phase 15 (e)-(f) came), against the
     plain versions (1e-3, eps std > 0.1)
     and where the time goes in one eval (as in 6); (d)
     `--run_train --train_delta_block --target_class_num` on phase 9's
     recipe, float32 and --bf16 (K1-bwd, K2-bwd-MH and K3-bwd launched, peak
     device memory), the float32 run again with the plain versions (block
     1e-3, update 5e-2) and phase 9's gradient gate; (e) the ADM 256^2
     classifier (EncoderUNet with guided-diffusion's classifier flags, pool
     attention) at batch 1 and 8 against the plain versions (1e-3), the
     attention pool's K2-MH launch at T = 65 among the recorded launches.
     Phase 3 also holds K1, K2-MH, K1-bwd and K2-bwd-MH at every shape of
     one IMAGENET eval and training-mode eval (f32 [1, 512, 256, 256]
     streams part of its group), and K2-MH at the pool's [1|8, 65, 512].
  13. DiffStyle and the library surfaces no other CLI path reaches, on
     `custom.yml` with the random weights of --seed: (a) `--diff_style`
     through the port's CLI, in-process, one random 256^2 content image
     (two until phase 14 came: cut for the time limit) and one distinct
     style image, 20 + 20 steps (40 + 40 until phase 15 (e)-(f) came: cut
     for the time limit), t_edit 513, hs_coeff 0.9,
     content_replace_step 50, float32 and --bf16: K1, K2 and K3 launched,
     K3 exactly as often as the step tables say (2 inversions, 1
     generation), K2-MH never, the output written, 256^2, finite; (b)
     the float32 sweep with the plain versions (1e-3 of scale), and the
     stylized output apart from the un-edited reconstruction; (c)
     `--use_mask`, kernels and plain (1e-3); (d) `make_image_noise_generate`
     over 4 steps, the gradient w.r.t. `noise_param` kernels vs plain
     (1e-3; K1-bwd, K2-bwd and K3-bwd launched); (e) a `global`-mode dual
     eval (a seeded DeltaBlockGlobal, K1 at [3, 512, 8, 8]) and an
     `interp_batch` eval at batch 3, kernels vs plain (1e-3); (f) the
     random RN50 tower and the global, angle, texture and patch CLIP terms
     with their input gradients, on the card against the CPU (1e-4 of
     scale, TF32 off). Each run prints its wall with the card.
  14. Base training of the UNets themselves (`pipelines/base_train.py`:
     q_sample -> UNet -> loss -> backward -> Adam 1e-4 -> EMA 0.9999), at full
     width: (a) `custom.yml` (the seeded init; eps, fixedsmall, mse, a
     UniformSampler) 3 steps f32 at bs 1; `afhq.yml` (phase 8's perturbed
     `.pt`; the P2 recipe learned_range, rescaled_mse, p2_gamma 1, a
     LossSecondMomentResampler) 3 steps bf16 at bs 8, 3 f32 at bs 1 and one
     f32 step at bs 2 (cuDNN's FFT path; recorded, not gated): K1, K1-bwd and
     the family's K2 / K2-bwd launched, the other family's K2 and the step
     kernels never; ms per step, images/s, peak memory and one profiled
     step. Gates: one step's gradient w.r.t. every parameter, kernels vs
     plain, per leaf 1e-3 in f32 (bs 1; a leaf counts at least at 1e-3 of
     the largest leaf's scale), and in bf16 (bs 2, two timesteps) no farther
     from the f32 plain gradient than 2x the plain bf16 one; the 3-step f32
     run with the plain versions (deterministic cuDNN): the loss per step
     within 1e-3, the update and the EMA's update within 5e-2 in the L2 norm
     (Adam moves an element of zero exact gradient by +-lr of noise), each
     EMA bit for bit its rate expression; (b) the train-state sidecar saved after step
     2, restored into a fresh model, EMA and Adam: step 3 bit-identical; (c)
     `ddim_sample_loop` and `p_sample_loop` over 25 respaced steps of the
     AFHQ UNet, kernels vs plain (1e-3); (d) `export_invert_edit` of
     custom.yml's 40 + 40-step f32 invert -> edit, saved, loaded and run:
     every exported graph names the registered ops, K1, K2 and K3 launch,
     the output within 1e-3 of the live engine's; (e) ResNet-18 card vs CPU
     at bs 1 and 8 (1e-4) and the shape report of custom.yml, afhq.yml and
     imagenet.yml. Phase 3 also holds, at every norm and attention of one
     base-training step (batch 2, t = 750 and 250), K1-bwd with dweight and
     dbias and the per-sample pre-add or FiLM operand's gradient, and
     K2-bwd(-MH), against autograd through the plain forward, bit for bit
     across two calls.
  15. Multi-device (`parallel/`), rank processes on the one card, each
     through the port's CLI with its launch counters zeroed just before its
     runs and read just after; every rank on cuda:0 over gloo (NCCL refuses
     two ranks on one card), except (a): (a) one NCCL rank, `--dp -1`
     serving on `custom.yml` (4 + 4 steps, f32), bit for bit the run without
     a process group; (b) two ranks, `--dp 2` Δ-training (CLIP + L1, bs 2, 4
     steps) then serving its block, against one process (Δ leaves 5e-5,
     grids 2 levels: the JAX package's tests/test_runner_dp.py bounds); (c)
     four ranks, `--dp 4 --tp_spatial` serving `custom.yml` and `--dp 2 --sp
     2` serving `afhq.yml` (bs 2), against one process (x_lat and x_rec
     1e-3 of scale, grids 2 levels): K1 across ranks (`gn_part`,
     `gn_apply`) and K2 with Tq != Tk launched, the one-rank K1 and K2
     never; rank 0's collectives (count, bytes, time synchronized around
     each) per UNet eval: gloo through the host with four ranks on one
     card, what the exchanges cost here, not multi-GPU scaling; (d) both new
     entries against their plain versions at every shape (c) gave rank 0,
     f32 and bf16: CUDA-event and device times, SDPA at the same Tq / Tk,
     the bound, calls per run. Phase 3's repetitions per row went 15 / 12
     -> 10 / 8, phase 11's `--lpips` 100 -> 50 steps and phase 12's grids
     20 -> 10 and chain 40 -> 20 steps for its room. (e) Four gloo ranks,
     Δ-training under spatial sharding against one process: `custom.yml
     --dp 4 --tp_spatial` (a DeltaBlock, CLIP + L1, bs 1, 4 + 4 steps, then
     serving its block; and the Δh rows, `--train_delta_h`) and `afhq.yml
     --dp 2 --sp 2` (bs 2): Δ leaves 5e-5, grids 2 levels; K1-bwd across
     ranks (`gn_bwd_part`, `gn_bwd_apply`) and K2-bwd with Tq != Tk
     (`asyrp_attention_bwd_kv`) launched, no one-rank K1, K2, K1-bwd or
     K2-bwd; rank 0's collectives per training timestep (count, bytes,
     time). (f) Two gloo ranks, `--lpips` (4 steps), `--run_fidelity` and
     `--diff_style` under `--dp 2 --tp_spatial` against one process
     (images 2 levels, LPIPS curves 5e-3: the JAX package's bound). Then
     (d) for the two backward entries at every shape (e) gave rank 0:
     against their plain versions (1e-4 of scale f32, K2-bwd also through
     autograd and, K2-bwd, against SDPA's backward at the same Tq / Tk;
     bf16 no farther from the f32 plain versions than 2x the plain versions
     in bf16), two calls bit for bit, CUDA-event and device times, SDPA's
     backward's, the bound. For phase 15 (e)-(f)'s room phase 3's
     repetitions went 10 / 8 -> 4 / 3, the OpenAI training grids of phases
     9 and 12 (d) 40 -> 10 steps, phase 12 (c)'s chain 20 -> 10, phase 13's
     DiffStyle 40 + 40 -> 20 + 20 and phase 11's `--lpips` 50 -> 25 steps;
     (c) runs beside (a) and (b).
Every run of a path (phases 4, 7-13) fails if a K3, K3-bwd or DDPM-step
call took the scalar instance: the paths' tensors are aligned, whole 16-byte
vectors. The float32 runs use full float32 convolutions and matmuls (TF32
off), as the port's runner sets it on CUDA.

Needs a CUDA device and this repository around the script. Prints the
`nvidia-smi` line and a JSON line of per-kernel results before the last
line, which is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import glob
import itertools
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from typing import Optional

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 40
CONFIG, IMAGE, DEVICE = "custom.yml", 256, "cuda"
AFHQ_CONFIG, DDPM_STEPS = "afhq.yml", 10
IMAGENET_CONFIG = "imagenet.yml"
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
       "group_norm_imagenet": {"float32": 1e-5, "bfloat16": 2e-2},
       "attention_mh_imagenet": {"float32": 1e-5, "bfloat16": 2e-2},
       "group_norm_bwd_imagenet": {"float32": 1e-4, "bfloat16": 5e-2},
       "attention_bwd_mh_imagenet": {"float32": 1e-4, "bfloat16": 5e-2},
       "ddim_step": {"float32": 1e-6, "bfloat16": 1e-6}, "ddim_step_learn_sigma": 1e-6,
       "ddpm_step": 1e-6,
       # keyed by the gradient's dtype (eps's): a bf16 output rounds once more
       "ddim_step_bwd": {"float32": 1e-6, "bfloat16": 1e-2}}
# the OpenAI UNet's eps on perturbed weights must be far from zero, or its
# comparisons would hold zeros against zeros
MIN_EPS_STD = 0.1
# the multi-head K2 against the one-head plain version: a control that the
# row's comparison sees a wrong head split
CONTROL_MIN = 1e-2
# a fused K1 call against K1 and the separate torch ops, in f32 (bf16: one step)
FUSED_TOL = 1e-6
TRAIN_KERNELS = ("group_norm", "group_norm_bwd", "attention", "attention_bwd", "ddim_step",
                 "ddim_step_bwd")
OPENAI_TRAIN_KERNELS = ("group_norm", "group_norm_bwd", "attention_mh", "attention_mh_bwd",
                        "ddim_step", "ddim_step_bwd")
# the step kernels' device kernel names (`csrc/steps.cu`)
STEP_KERNEL = {"ddim_step": "ddim_fwd", "ddim_step_learn_sigma": "ddim_fwd",
               "ddim_step_bwd": "ddim_bwd", "ddpm_step": "ddpm_fwd"}
AFHQ_ATTR = "dog_smiling"  # an AFHQ attribute of assets/src_trg_prompts.json
# the OpenAI-family training grids of phases 9 and 12 (d) (40 until phase 15
# (e)-(f) came: cut for the time limit) and DiffStyle's inversion and
# generation grids of phase 13 (40 until then)
OPENAI_TRAIN_STEPS, STYLE_STEPS = 10, 20
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
L2_BYTES = 50 * 2**20  # the H100 SXM's L2 cache
# phase 3's repetitions per row: CUDA-event runs (the median) and calls back to
# back behind the sleep (25 and 20 until phase 14 came, 15 and 12 until phase 15
# came, 10 and 8 until phase 15 (e)-(f) came: cut for the time limit)
ROW_RUNS, ROW_DEVICE_RUNS = 4, 3
DTYPES = ("float32", "bfloat16")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def phase(msg: str) -> None:
    """Print a line; a phase's first line with the script's elapsed seconds."""
    if msg.startswith("phase "):
        msg = f"{msg} [{time.perf_counter() - _T0:.1f} s]"
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


def device_ms(fn, runs: int = 20, required: bool = True):
    """Device time per call, back to back: `torch.cuda._sleep` holds the
    stream while the host queues `runs` calls behind it, so the CUDA events
    around them time the device alone, without the host's time between
    launches (which `time_ms` includes). The sleep is lengthened until the
    host has queued every call before it ends; a call that waits for the
    device (a blocking copy) never lets it, and then this fails, or returns
    None (not measured) unless `required`."""
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
    if required:
        fail("the host could not queue the timed calls within the device's sleep")
    return None


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


def input_sets(make, n_bytes: float) -> list:
    """Enough sets of a call's inputs (`make()` builds one; a call moves
    `n_bytes`) that one pass through them moves 4x the L2's bytes: timed in
    turn (`in_turn`), each call reads its inputs from device memory, as
    `bound` counts them."""
    return [make() for _ in range(max(1, -(-4 * L2_BYTES // int(n_bytes))))]


def in_turn(fn, sets):
    """A callable that calls `fn(*set)` on each of `sets` in turn and keeps
    each set's last outputs until its next turn, so that the outputs rotate
    through memory too. Every set is called once here, and one more call,
    so that the allocator holds every output block before any timing."""
    ring, turn = [None] * len(sets), itertools.count()

    def call():
        j = next(turn) % len(sets)
        ring[j] = fn(*sets[j])

    for _ in range(len(sets) + 1):
        call()
    return call


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
            "ddim_step_bwd": k3.ddim_step.bwd_launches, "ddpm_step": kddpm.ddpm_step.launches,
            "ddim_step_scalar": k3.ddim_step.scalar_launches,
            "ddpm_step_scalar": kddpm.ddpm_step.scalar_launches,
            "group_norm_nhwc": k1.group_norm.nhwc_launches,
            "group_norm_part": k1.group_norm.part_launches,
            "group_norm_apply": k1.group_norm.apply_launches,
            "attention_kv": k2.attention.kv_launches,
            "group_norm_bwd_part": k1.group_norm.bwd_part_launches,
            "group_norm_bwd_apply": k1.group_norm.bwd_apply_launches,
            "attention_kv_bwd": k2.attention.kv_bwd_launches}


def zero_counters() -> None:
    from asyrp_official_torch.ops import attention as k2, ddim_step as k3, groupnorm as k1
    from asyrp_official_torch.ops import ddpm_step as kddpm

    k1.group_norm.launches = k1.group_norm.bwd_launches = k1.group_norm.nhwc_launches = 0
    k1.group_norm.part_launches = k1.group_norm.apply_launches = 0
    k1.group_norm.bwd_part_launches = k1.group_norm.bwd_apply_launches = 0
    k2.attention.kv_bwd_launches = 0
    k2.attention.launches = k2.attention.mh_launches = k2.attention.bwd_launches = 0
    k2.attention.mh_bwd_launches = k2.attention.kv_launches = 0
    k3.ddim_step.launches = k3.ddim_step.bwd_launches = k3.ddim_step.scalar_launches = 0
    kddpm.ddpm_step.launches = kddpm.ddpm_step.scalar_launches = 0


def require_launches(counts, names, what: str) -> None:
    """Every kernel of the path launched; no step kernel took its scalar
    instance (the paths' tensors are aligned, whole vectors)."""
    if not all(counts[n] for n in names):
        fail(f"{what} did not launch every kernel of its path {list(names)}: {counts}")
    if counts["ddim_step_scalar"] or counts["ddpm_step_scalar"]:
        fail(f"{what}: a step kernel took the scalar instance where a vector one applies: "
             f"{counts}")


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


def gn_fwd_key(x, kw):
    """A K1 forward call's row: (shape, silu, eps, fused op or None)."""
    fused = ("pre_add" if kw.get("pre_add") is not None
             else "scale_shift" if kw.get("scale_shift") is not None else None)
    return tuple(x.shape), kw.get("silu", False), kw.get("eps", 1e-6), fused


def gn_bwd_key(torch, x, w, kw):
    """The K1-bwd call a K1 call under autograd makes, as (shape, silu,
    weight_grad, eps), or None: the unfused composition runs K1 on
    x + pre_add, and with the FiLM epilogue without its SiLU."""
    pre = kw.get("pre_add")
    needs_x = x.requires_grad or (pre is not None and pre.requires_grad)
    if not torch.is_grad_enabled() or not (needs_x or w.requires_grad):
        return None
    silu = kw.get("silu", False) and kw.get("scale_shift") is None
    return tuple(x.shape), silu, w.requires_grad, kw.get("eps", 1e-6)


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
            key = gn_bwd_key(torch, x, w, kw)
            if key:
                bump("group_norm_bwd", key)
        else:
            bump("group_norm", gn_fwd_key(x, kw))
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
    from asyrp_official_torch.models.openai_unet import AFHQ_CONFIG

    names = ("group_norm_afhq", "attention_mh", "group_norm_bwd_afhq", "attention_bwd_mh")
    seen = record_openai_shapes(torch, dev, AFHQ_CONFIG, names)
    # shapes off the eval (count 0): IMAGENET's 32^2 level, ragged T, batch 8
    for shape in ((1, 1024, 512), (2, 100, 512), (8, 256, 512)):
        seen["attention_mh"][(shape, 8, True)] = 0
    for shape in ((1, 64, 512), (1, 1024, 512), (2, 100, 512), (1, 200, 512), (8, 256, 512),
                  (1, 4096, 512)):
        seen["attention_bwd_mh"].setdefault((shape, 8, True), 0)
    return seen


def record_imagenet_shapes(torch, dev):
    """As `record_afhq_shapes`, for the full-width IMAGENET UNet
    (`imagenet.yml`, ADM 256^2, 553.8M params: 8 heads of 64 at 32^2, 16 at
    16^2 and 8^2, the 512-channel 256^2 GroupNorms of the decoder); and,
    off the eval (count 0), the ADM classifier's attention pool (T = 65, 8
    heads) at batch 1 and 8, which phase 12 (e) runs."""
    from asyrp_official_torch.cli.main import load_config
    from asyrp_official_torch.models.registry import spec_from_config

    names = ("group_norm_imagenet", "attention_mh_imagenet", "group_norm_bwd_imagenet",
             "attention_bwd_mh_imagenet")
    seen = record_openai_shapes(torch, dev, spec_from_config(load_config(IMAGENET_CONFIG)).config,
                                names)
    for batch in (1, 8):
        seen["attention_mh_imagenet"][((batch, 65, 512), 8, True)] = 0
    return seen


def record_openai_shapes(torch, dev, cfg, names):
    """The recording of `record_afhq_shapes` for the OpenAI UNet of `cfg`,
    into `names` (K1, K2-MH, K1-bwd, K2-bwd-MH rows), with the total calls
    of the training-mode eval under `train_<K1 name>` and `train_<K2 name>`."""
    from unittest import mock

    from asyrp_official_torch.models.delta import EditState, OpenAIDeltaBlock
    from asyrp_official_torch.models.openai_unet import OpenAIUNet
    from asyrp_official_torch.ops import attention as k2, groupnorm as k1

    gn_name, attn_name, gn_bwd_name, attn_bwd_name = names
    seen = {**{n: {} for n in names}, f"train_{gn_name}": 0, f"train_{attn_name}": 0}
    training = [False]

    def bump(key, k):
        seen[key][k] = seen[key].get(k, 0) + 1

    def gn(x, w, b, **kw):
        if not training[0]:
            bump(gn_name, gn_fwd_key(x, kw))
        else:
            seen[f"train_{gn_name}"] += 1
            key = gn_bwd_key(torch, x, w, kw)
            if key:
                bump(gn_bwd_name, key)
        return k1.group_norm_plain(x, w, b, **kw)

    def attn(q, k, v, num_heads=1, legacy_scale=False):
        if not training[0]:
            bump(attn_name, (tuple(q.shape), num_heads, legacy_scale))
        else:
            seen[f"train_{attn_name}"] += 1
            if torch.is_grad_enabled() and q.requires_grad:
                bump(attn_bwd_name, (tuple(q.shape), num_heads, legacy_scale))
        return k2.attention_plain(q, k, v, num_heads=num_heads, legacy_scale=legacy_scale)

    torch.manual_seed(0)
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
    del model, block
    torch.cuda.empty_cache()
    return seen


def record_nhwc_shapes(torch, dev, batch: int = 16):
    """Shapes and calls K1 sees in one edited eval of the full-width AFHQ
    UNet at `batch` on its bf16 channels-last route (as the bf16 cell
    serves it: the encoder at `batch`, the dual decode stacked at twice
    it), by (shape, silu, eps, fused op); fails if a call there is not
    channels-last. The plain versions stand in while recording."""
    from unittest import mock

    from asyrp_official_torch.models.delta import EditState, OpenAIDeltaBlock
    from asyrp_official_torch.models.openai_unet import AFHQ_CONFIG, OpenAIUNet
    from asyrp_official_torch.ops import channels_last, groupnorm as k1

    seen, nchw = {}, []

    def gn(x, w, b, **kw):
        if channels_last(x):
            key = gn_fwd_key(x, kw)
            seen[key] = seen.get(key, 0) + 1
        else:
            nchw.append(tuple(x.shape))
        return k1.group_norm_plain(x, w, b, **kw)

    torch.manual_seed(0)
    cfg = AFHQ_CONFIG
    model = OpenAIUNet(cfg).to(dev).eval().requires_grad_(False)
    block = OpenAIDeltaBlock(cfg.bottleneck_ch, cfg.temb_ch).to(dev).eval().requires_grad_(False)
    edit = EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0], device=dev),
                     flavor="openai")
    x = torch.randn(batch, IMAGE, IMAGE, 3, device=dev).to(torch.bfloat16)
    t = torch.full((batch,), 500.0, device=dev)
    with mock.patch.object(k1, "group_norm", gn), torch.no_grad():
        model.apply(x, t, edit=edit)
    if nchw:
        fail(f"the bf16 AFHQ eval at batch {batch} handed K1 NCHW tensors: {nchw}")
    del model, block
    torch.cuda.empty_cache()
    return seen


def record_base_train_shapes(torch):
    """Shapes K1-bwd and K2-bwd see in one base-training step of the
    full-width custom.yml and afhq.yml UNets (every parameter trained, batch
    2, two timesteps): each norm as (shape, silu, eps, fused op) under
    `group_norm_bwd_base[_afhq]` (K1-bwd computes dweight and dbias there,
    and the step's per-sample temb pre-add or FiLM operand takes a gradient
    too), each attention as (shape, heads, legacy scale) under
    `attention_bwd_base[_mh]`. Recorded on fake tensors (shapes only)."""
    from unittest import mock

    from torch._subclasses.fake_tensor import FakeTensorMode

    from asyrp_official_torch.cli.main import load_config
    from asyrp_official_torch.models.registry import spec_from_config
    from asyrp_official_torch.ops import attention as k2, groupnorm as k1
    from asyrp_official_torch.pipelines.base_train import unet_eps_fn

    seen = {}
    for config, gn_name, attn_name in ((CONFIG, "group_norm_bwd_base", "attention_bwd_base"),
                                       (AFHQ_CONFIG, "group_norm_bwd_base_afhq",
                                        "attention_bwd_mh_base")):
        gns, attns = seen.setdefault(gn_name, {}), seen.setdefault(attn_name, {})

        def gn(x, w, b, **kw):
            fused = ("pre_add" if kw.get("pre_add") is not None
                     else "scale_shift" if kw.get("scale_shift") is not None else None)
            key = (tuple(x.shape), kw.get("silu", False), kw.get("eps", 1e-6), fused)
            gns[key] = gns.get(key, 0) + 1
            return k1.group_norm_plain(x, w, b, **kw)

        def attn(q, k, v, num_heads=1, legacy_scale=False):
            key = (tuple(q.shape), num_heads, legacy_scale)
            attns[key] = attns.get(key, 0) + 1
            return k2.attention_plain(q, k, v, num_heads=num_heads, legacy_scale=legacy_scale)

        spec = spec_from_config(load_config(config))
        with FakeTensorMode(), mock.patch.object(k1, "group_norm", gn), \
                mock.patch.object(k2, "attention", attn):
            model = spec.build()
            unet_eps_fn(model, torch.empty(2, 3, IMAGE, IMAGE), torch.tensor([750, 250]))
    return seen


def base_train_rows(torch, dev, seen):
    """Phase 3's base-training rows (`record_base_train_shapes`): at every
    norm, the gradient of the fused K1 entry (K1 and K1-bwd with dweight and
    dbias, plus the torch ops of its pre-add or FiLM operand, which takes a
    gradient too) w.r.t. x, weight, bias and that operand; at every
    attention, K2-bwd(-MH)'s dq, dk, dv: each by `torch.autograd.grad`
    against the same through the plain forward, f32 and bf16, at TOL's
    group_norm_bwd / attention_bwd bounds; two calls agree bit for bit, and
    each call launches its backward kernel once. Returns {row name:
    {dtype: worst error}}."""
    from asyrp_official_torch.ops import attention as k2, groupnorm as k1

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    out = {}
    for name in ("group_norm_bwd_base", "group_norm_bwd_base_afhq", "attention_bwd_base",
                 "attention_bwd_mh_base"):
        out[name] = {}
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            worst_err = 0.0
            for key, count in sorted(seen[name].items(), key=lambda kv: str(kv[0])):
                if name.startswith("group_norm"):
                    shape, silu, eps, fused = key
                    b_, c_ = shape[:2]
                    x = (randn(*shape) * 2.0 + 0.5).to(dtype).requires_grad_()
                    w = (1.0 + 0.1 * randn(c_)).requires_grad_()
                    b = (0.1 * randn(c_)).requires_grad_()
                    kw = dict(eps=eps, silu=silu)
                    ins = [x, w, b]
                    if fused == "pre_add":
                        kw["pre_add"] = randn(b_, c_, dtype=dtype).requires_grad_()
                    elif fused == "scale_shift":
                        kw["scale_shift"] = (0.1 * randn(b_, 2 * c_)).to(dtype).requires_grad_()
                    if fused:
                        ins.append(kw[fused])
                    dy = randn(*shape, dtype=dtype)
                    run = lambda f: torch.autograd.grad(f(x, w, b, **kw), ins, dy)
                    tol, counter = TOL["group_norm_bwd"][dname], "group_norm_bwd"
                    parts = ("dx", "dweight", "dbias", f"d{fused}") if fused else (
                        "dx", "dweight", "dbias")
                    label = f"{list(shape)} silu={int(silu)} eps={eps:g} fused={fused}"
                    fns = (k1.group_norm, k1.group_norm_plain)
                else:
                    shape, heads, legacy = key
                    ins = [randn(*shape, dtype=dtype).requires_grad_() for _ in range(3)]
                    d_o = randn(*shape, dtype=dtype)
                    kw = dict(num_heads=heads, legacy_scale=legacy)
                    run = lambda f: torch.autograd.grad(f(*ins, **kw), ins, d_o)
                    tol = TOL["attention_bwd"][dname]
                    counter = "attention_bwd" if heads == 1 else "attention_mh_bwd"
                    parts = ("dq", "dk", "dv")
                    label = f"{list(shape)} heads={heads} legacy_scale={int(legacy)}"
                    fns = (k2.attention, k2.attention_plain)
                want = run(fns[1])
                before = counters()[counter]
                got, again = run(fns[0]), run(fns[0])
                torch.cuda.synchronize()
                launched = counters()[counter] - before
                rel = [errs(g.float(), w_.float())[1] for g, w_ in zip(got, want)]
                finite = all(torch.isfinite(g.float()).all() for g in got)
                bitwise = same_bits(tuple(got), tuple(again))
                ok = finite and max(rel) <= tol and bitwise and launched == 2
                phase(f"  {name} {dname} {label} x{count}: rel err " + ", ".join(
                    f"{p_} {e_:.3e}" for p_, e_ in zip(parts, rel)) + f" (tol {tol:g}); two "
                      f"calls bit for bit: {bitwise}; {launched} {counter} launches in 2 calls"
                      f"{'' if ok else '  <-- FAIL'}")
                if not ok:
                    fail(f"{name} {label} {dname}: the kernels' gradient disagrees with the plain "
                         f"one ({max(rel):.3e}), or two calls differ, or the kernel did not run")
                worst_err = max(worst_err, max(rel))
            out[name][dname] = worst_err
    return out


def gn_stats(x, groups: int = 32, eps: float = 1e-6):
    """Per-(sample, group) mean and rstd, the statistics K1-bwd reads."""
    import torch

    var, mean = torch.var_mean(x.float().reshape(x.shape[0], groups, -1), dim=2, unbiased=False)
    return mean, (var + eps).rsqrt()


def same_bits(a, b) -> bool:
    """Two results (a tensor, or tuples of tensors and None) equal bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def device_kernels_per_call(fn, runs: int = 10):
    """(device kernels per call, their names) from torch.profiler's device
    events over `runs` calls. The trace can drop events (a profile may
    record none, or miss one of ten), so a count reads low, never high; a
    profile with no device event is repeated, at most twice; then (None, ())
    (not measured), as in `profiled_device_ms`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if names:
            return len(names) / runs, sorted(set(names))
    return None, ()


def bf16_ulps(a, b) -> int:
    """The largest distance in bf16 steps between two bf16 tensors."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((ordered(a) - ordered(b)).abs().max())


def fused_vs_unfused(fused, unfused, dname: str) -> str:
    """The fused K1 call against K1 and the separate torch ops: within 1e-6
    of scale in f32, one bf16 step per element in bf16; fails otherwise."""
    if dname == "float32":
        rel = errs(fused, unfused)[1]
        if rel > FUSED_TOL:
            fail(f"fused K1 call {rel:.3e} of scale from the unfused composition "
                 f"(tol {FUSED_TOL:g})")
        return f"{rel:.3e} of scale (tol {FUSED_TOL:g})"
    ulps = bf16_ulps(fused, unfused)
    if ulps > 1:
        fail(f"fused K1 call {ulps} bf16 steps from the unfused composition (tol 1)")
    return f"at most {ulps} bf16 step(s) per element (tol 1)"


def gn_plan_note(k1, shape, dtype, weight_grad=None) -> str:
    """K1's launch plan for a row: the cluster and what streams."""
    bwd = weight_grad is not None
    pl = k1.group_norm_plan(shape, dtype, backward=bwd, weight_grad=bool(weight_grad))
    slice_v = pl["slice_vectors"]
    streams = pl["resident_x"] < slice_v or (bwd and pl["resident_dy"] < slice_v)
    what = "x" if pl["resident_x"] < slice_v else "dy"
    return (f" [cluster {pl['cluster']}, {pl['threads']} threads and "
            f"{pl['smem_bytes'] // 1024} KB shared per block"
            f"{f', streams part of {what}' if streams else ''}]")


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
                         "attention_bwd_mh", "group_norm_imagenet", "attention_mh_imagenet",
                         "group_norm_bwd_imagenet", "attention_bwd_mh_imagenet") if n in seen]
    out = {n: {} for n in names + ["ddim_step", "ddim_step_learn_sigma", "ddpm_step"]}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.tensor([], dtype=dtype).element_size()
        for name in names:
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0, "max_rel_err": 0.0, "calls": 0}
            bound_ms_by = {"bytes": 0.0, "operations": 0.0}
            for key, count in sorted(seen[name].items(), key=lambda kv: str(kv[0])):
                gn_fwd = name.startswith("group_norm") and not name.startswith("group_norm_bwd")
                if gn_fwd:
                    shape, silu, gn_eps, fused = key
                    x = (randn(*shape) * 2.0 + 0.5).to(dtype)
                    w, b = 1.0 + 0.1 * randn(shape[1]), 0.1 * randn(shape[1])
                    wl, bl = w.to(dtype), b.to(dtype)
                    kw = dict(eps=gn_eps, silu=silu)
                    extra = 0  # the fused op's per-channel input
                    if fused == "pre_add":
                        kw["pre_add"] = randn(shape[0], shape[1], dtype=dtype)
                        extra = shape[0] * shape[1] * es
                    elif fused == "scale_shift":
                        kw["scale_shift"] = (0.1 * randn(shape[0], 2 * shape[1])).to(dtype)
                        extra = 2 * shape[0] * shape[1] * es
                    run_k = lambda: k1.group_norm(x, w, b, **kw)
                    run_p = lambda: k1.group_norm_plain(x, w, b, **kw)
                    if fused:  # the unfused composition: K1, then the torch ops
                        lib = lambda: k1.group_norm_unfused(x, w, b, **kw)
                    else:
                        lib = lambda: (F.silu(F.group_norm(x, 32, wl, bl, gn_eps)) if silu
                                       else F.group_norm(x, 32, wl, bl, gn_eps))
                    got, want = [run_k()], [run_p()]
                    n = x.numel()
                    b_ms, b_by = bound(2 * n * es + 2 * shape[1] * 4 + extra,
                                       n * (8 + 4 * silu), PEAK_FLOPS["float32"])
                    label = (f"{list(shape)} silu={int(silu)} eps={gn_eps:g}"
                             f"{f' fused={fused}' if fused else ''}"
                             f"{gn_plan_note(k1, shape, dtype)}")
                elif name.startswith("group_norm_bwd"):
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
                    label = (f"{list(shape)} silu={int(silu)} dweight={int(wgrad)} eps={gn_eps:g}"
                             f"{gn_plan_note(k1, shape, dtype, wgrad)}")
                elif not name.startswith("attention_bwd"):  # attention, attention_mh*
                    shape, heads, legacy = key if name != "attention" else (key, 1, False)
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
                else:  # attention_bwd, attention_bwd_mh*
                    shape, heads, legacy = key if name != "attention_bwd" else (key, 1, False)
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
                ms_k, ms_p, ms_l = (time_ms(f, runs=ROW_RUNS) for f in (run_k, run_p, lib))
                dev_t = tuple(device_ms(f, runs=ROW_DEVICE_RUNS) for f in (run_k, run_p, lib))
                if name.startswith("attention_bwd"):
                    # the library's backward and the kernels, profiled alike (the sum of
                    # their device events, without the gaps between launches)
                    dev_t += (profiled_device_ms(lib), profiled_device_ms(run_k))
                extra_note = ""
                if name.startswith(("attention_bwd", "group_norm")):
                    # no atomics: two calls on the same inputs agree bit for bit
                    if not same_bits(run_k(), run_k()):
                        fail(f"{name} {label} {dname}: two calls on the same inputs differ")
                    extra_note = "; bitwise equal across two calls"
                if gn_fwd:
                    # one device kernel per call, fused ops included
                    events, kernels = device_kernels_per_call(run_k)
                    extra_note += ("; device kernels per call in torch.profiler not measured"
                                   if events is None else
                                   f"; {events:g} device kernel(s) per call in torch.profiler")
                    if events is not None and (events > 1 or any("gn_fwd" not in k_
                                                                 for k_ in kernels)):
                        fail(f"{name} {label} {dname}: {events} device kernels per call "
                             f"({kernels}), not one gn_fwd")
                    if fused:  # against the unfused composition on the card
                        extra_note += "; vs unfused " + fused_vs_unfused(got[0], lib(), dname)
                tol = TOL[name][dname]
                ok = rel_err <= tol
                control = ""
                if name.startswith("attention_mh"):
                    # the check must tell head splits apart: against the
                    # one-head plain version the kernel's output is far off
                    ctrl = errs(got[0].float(), k2.attention_plain(q, kk, v).float())[1]
                    control = f", vs one head {ctrl:.3e} (must exceed {CONTROL_MIN:g})"
                    ok = ok and ctrl > CONTROL_MIN
                elif name.startswith("attention_bwd_mh"):
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
                          f"{ms_p:.4f} ms, library {ms_l:.4f} ms{extra_note}")
                timing += (f"; device time per call, back to back: kernel {dev_t[0]:.4f} "
                           f"ms ({dev_t[0] * count:.4f} per eval), plain {dev_t[1]:.4f} ms, "
                           f"library {dev_t[2]:.4f} ms")
                if name.startswith("group_norm"):  # the launch path's host time
                    timing += f"; event - device {ms_k - dev_t[0]:.4f} ms per call"
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

    out.update(step_rows(torch, dev, randn))
    return out


def nhwc_rows(torch, dev, seen):
    """Phase 3's channels-last K1 rows (`gn_fwd_nhwc_slab`, or
    `gn_fwd_nhwc_stats` + `gn_fwd_nhwc_apply`) at the shapes of `seen` (`record_nhwc_shapes`: the
    bf16 cell's eval at batch 16), f32 and bf16: against the plain version
    on the same channels-last input (K1's tolerances), the statistics out,
    two calls bit for bit, one `gn_fwd_nhwc` device kernel per call on a
    slab plan, two otherwise; per call
    and per eval the device time of the kernels, of the NCHW K1 on the same
    values laid out NCHW (the route before), of the plain version and of
    `F.group_norm` (+ the torch ops of the fused epilogue) on the
    channels-last input, and the bound (2n bytes). Returns ({dtype: per-eval
    sums}, [rows])."""
    import torch.nn.functional as F

    from asyrp_official_torch.ops import groupnorm as k1

    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def library(x, w, b, eps, silu, pre_add=None, scale_shift=None):
        if pre_add is not None:
            x = x + pre_add[:, :, None, None]
        y = F.group_norm(x, 32, w.to(x.dtype), b.to(x.dtype), eps)
        if scale_shift is not None:
            scale, shift = (t[:, :, None, None] for t in scale_shift.chunk(2, dim=1))
            y = y * (1.0 + scale) + shift
        return F.silu(y) if silu else y

    sums, rows = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.tensor([], dtype=dtype).element_size()
        tot = {"calls": 0, "device_ms": 0.0, "nchw_device_ms": 0.0, "plain_device_ms": 0.0,
               "library_device_ms": 0.0, "bound_ms": 0.0, "max_rel_err": 0.0}
        for key, count in sorted(seen.items(), key=lambda kv: str(kv[0])):
            shape, silu, eps, fused = key
            bsz, c = shape[:2]
            x = (randn(*shape) * 2.0 + 0.5).to(dtype).contiguous(memory_format=torch.channels_last)
            x_nchw = x.contiguous()
            w, b = 1.0 + 0.1 * randn(c), 0.1 * randn(c)
            kw = dict(eps=eps, silu=silu)
            extra = 0
            if fused == "pre_add":
                kw["pre_add"] = randn(bsz, c).to(dtype)
                extra = bsz * c * es
            elif fused == "scale_shift":
                kw["scale_shift"] = (0.1 * randn(bsz, 2 * c)).to(dtype)
                extra = 2 * bsz * c * es
            run_k = lambda: k1.group_norm(x, w, b, **kw)
            run_n = lambda: k1.group_norm(x_nchw, w, b, **kw)
            run_p = lambda: k1.group_norm_plain(x, w, b, **kw)
            run_l = lambda: library(x, w, b, **kw)
            label = (f"{list(shape)} silu={int(silu)} eps={eps:g}"
                     f"{f' fused={fused}' if fused else ''}")
            got, want = run_k(), run_p()
            if not got.is_contiguous(memory_format=torch.channels_last):
                fail(f"group_norm_nhwc {label} {dname}: the result is not channels-last")
            rel = errs(got.float(), want.float())[1]
            y, mean, rstd = k1._group_norm_cuda(x, w, b, 32, eps, silu, stats=True)
            _, mean_p, rstd_p = k1._plain_with_stats(x, w, b, 32, eps, silu)
            rel_stats = max(errs(mean, mean_p)[1], errs(rstd, rstd_p)[1])
            if not (same_bits(run_k(), got) and same_bits(
                    k1._group_norm_cuda(x, w, b, 32, eps, silu, stats=True), (y, mean, rstd))):
                fail(f"group_norm_nhwc {label} {dname}: two calls on the same inputs differ")
            pl = k1.group_norm_nhwc_plan(shape, dtype)
            events, kernels = device_kernels_per_call(run_k)
            if events is not None and (events > (1 if pl["slab"] else 2) or any(
                    "gn_fwd_nhwc" not in k_ for k_ in kernels)):
                fail(f"group_norm_nhwc {label} {dname}: {events} device kernels per call "
                     f"({kernels}), not its gn_fwd_nhwc kernel(s)")
            dev_t = [device_ms(f, runs=ROW_DEVICE_RUNS) for f in (run_k, run_n, run_p, run_l)]
            n = x.numel()
            b_ms, _ = bound(2 * n * es + 2 * c * 4 + extra, n * (8 + 4 * silu),
                            PEAK_FLOPS["float32"])
            tol = TOL["group_norm_afhq"][dname]
            ok = rel <= tol and rel_stats <= 1e-5
            plan = (f"one launch, slabs of {pl['slab']} channels" if pl["slab"] else
                    f"{pl['slices']} slices per sample, {pl['apply_blocks']} apply blocks of "
                    f"{pl['apply_vectors']} vectors per thread")
            phase(f"  group_norm_nhwc {dname} {label} x{count} [{plan}]: rel err {rel:.3e} (tol "
                  f"{tol:g}), mean/rstd {rel_stats:.3e} (tol "
                  f"1e-05); bitwise equal across two calls; "
                  + ("device kernels per call not measured" if events is None
                     else f"{events:g} device kernel(s) per call")
                  + f"; device time per call, back to back: kernel {dev_t[0]:.4f} ms "
                  f"({dev_t[0] * count:.4f} per eval), NCHW K1 {dev_t[1]:.4f} ms, plain "
                  f"{dev_t[2]:.4f} ms, F.group_norm {dev_t[3]:.4f} ms; bound {b_ms:.4f} ms "
                  f"(bytes, {100.0 * b_ms / dev_t[0]:.1f}% of it)"
                  f"{'' if ok else '  <-- FAIL'}")
            if not ok:
                fail(f"group_norm_nhwc {label} {dname} disagrees with its plain version: "
                     f"{rel:.3e}, statistics {rel_stats:.3e}")
            rows.append({"dtype": dname, "shape": list(shape), "silu": bool(silu), "eps": eps,
                         "fused": fused, "calls_per_eval": count, "rel_err": rel,
                         "device_ms": dev_t[0], "nchw_device_ms": dev_t[1],
                         "plain_device_ms": dev_t[2], "library_device_ms": dev_t[3],
                         "bound_ms": b_ms, "plan": pl})
            for k_, v_ in zip(("device_ms", "nchw_device_ms", "plain_device_ms",
                               "library_device_ms", "bound_ms"), (*dev_t, b_ms)):
                tot[k_] += v_ * count
            tot["calls"] += count
            tot["max_rel_err"] = max(tot["max_rel_err"], rel)
            del x, x_nchw, got, want, y
        sums[dname] = tot
        phase(f"  group_norm_nhwc {dname}: {tot['calls']} calls per eval at batch 16 take device "
              f"{tot['device_ms']:.3f} ms (kernel), {tot['nchw_device_ms']:.3f} ms (NCHW K1), "
              f"{tot['plain_device_ms']:.3f} ms (plain), {tot['library_device_ms']:.3f} ms "
              f"(F.group_norm), bound {tot['bound_ms']:.3f} ms "
              f"({100.0 * tot['bound_ms'] / tot['device_ms']:.1f}% of it)")
        torch.cuda.empty_cache()
    return sums, rows


INSTANCES = ("scalar", "flat", "rows")


def step_row(torch, row: str, dname: str, label: str, fn_k, fn_p, sets, n_bytes: float,
             n_flops: float, instance: int, checks=()):
    """One row of K3, K3-bwd or the DDPM step: the kernel `fn_k` against its
    plain version `fn_p` on the first of `sets` (and each of `checks`,
    (got, want) pairs); CUDA-event and back-to-back device times of both,
    run on the sets in turn (`in_turn`: every call reads its inputs from
    device memory, as the bound counts them), and the kernel's device time
    on the first set alone (back to back on the same inputs, which the L2
    keeps); event minus device; two calls bit for bit; at most one device
    kernel of the row's name per call in torch.profiler; the bound. Fails
    where one does not hold."""
    def parts(r):
        return [t for t in (r if isinstance(r, (tuple, list)) else (r,)) if t is not None]

    first = sets[0]
    pairs = list(zip(parts(fn_k(*first)), parts(fn_p(*first)))) + list(checks)
    abs_err = rel_err = 0.0
    for g_, w_ in pairs:
        if not torch.isfinite(g_.float()).all():
            fail(f"{row} {label} {dname}: non-finite output")
        a_, r_ = errs(g_.float(), w_.float())
        abs_err, rel_err = max(abs_err, a_), max(rel_err, r_)
    exact = all(torch.equal(g_, w_) for g_, w_ in pairs)
    run_k, run_p = in_turn(fn_k, sets), in_turn(fn_p, sets)
    ms_k, ms_p = time_ms(run_k), time_ms(run_p)
    dev_k, dev_p = device_ms(run_k), device_ms(run_p)
    dev_l2 = device_ms(lambda: fn_k(*first))
    if not same_bits(fn_k(*first), fn_k(*first)):
        fail(f"{row} {label} {dname}: two calls on the same inputs differ")
    events, kernels = device_kernels_per_call(lambda: fn_k(*first))
    if events is not None and (events > 1 or any(STEP_KERNEL[row] not in k_ for k_ in kernels)):
        fail(f"{row} {label} {dname}: {events} device kernels per call ({kernels}), not one "
             f"{STEP_KERNEL[row]}")
    b_ms, b_by = bound(n_bytes, n_flops, PEAK_FLOPS["float32"])
    tol = TOL[row][dname] if isinstance(TOL[row], dict) else TOL[row]
    ok = rel_err <= tol
    phase(f"  {row} {label}, {INSTANCES[instance]} instance: rel err {rel_err:.3e} (tol {tol:g})"
          f"{', bit for bit equal to plain' if exact else ''}; kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms, library n/a; device time per call, back to back over {len(sets)} "
          f"input sets: kernel {dev_k:.4f} ms, plain {dev_p:.4f} ms; on one set (L2): kernel "
          f"{dev_l2:.4f} ms; event - device {ms_k - dev_k:.4f} ms; bitwise equal across two "
          "calls; "
          + ("device kernels per call in torch.profiler not measured" if events is None else
             f"{events:g} device kernel(s) per call in torch.profiler")
          + f"; bound {b_ms:.4f} ms ({b_by}){'' if ok else '  <-- FAIL'}")
    if not ok:
        fail(f"{row} {label} {dname} disagrees with its plain version: {rel_err:.3e}")
    return {"row": row, "dtype": dname, "label": label, "instance": INSTANCES[instance],
            "max_abs_err": abs_err, "max_rel_err": rel_err, "bit_equal_to_plain": exact,
            "ms": ms_k, "plain_ms": ms_p, "device_ms": dev_k, "plain_device_ms": dev_p,
            "l2_device_ms": dev_l2, "input_sets": len(sets),
            "event_minus_device_ms": ms_k - dev_k, "bound_ms": b_ms, "bound_by": b_by,
            "device_kernels_per_call": events}


def step_rows(torch, dev, randn):
    """Phase 3's K3, K3-bwd and DDPM-step rows: the paths' shapes at batch 1
    ([1, 256, 256, 3], an f32 carry; the model output f32 or bf16, whole or
    the first 3 of a learn_sigma model's 6 channels) and batch 8. Returns
    {row: {model dtype: sums}, "step_rows": [each row]}; a row's times are
    its first case's (the one its path runs most) at batch 1."""
    from asyrp_official_torch.ops import ddim_step as k3, ddpm_step as kddpm

    out = {"ddim_step": {}, "ddim_step_learn_sigma": {}, "ddpm_step": {}, "ddim_step_bwd": {},
           "step_rows": []}

    def keep(res, primary: bool):
        d = out[res["row"]].setdefault(res["dtype"], {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                                      "library_ms": None})
        d["max_abs_err"] = max(d["max_abs_err"], res["max_abs_err"])
        d["max_rel_err"] = max(d["max_rel_err"], res["max_rel_err"])
        if primary:
            d.update({k: res[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                                          "plain_device_ms", "l2_device_ms",
                                          "event_minus_device_ms")})
        out["step_rows"].append(res)

    def dname_of(dtype):
        return str(dtype).split(".")[-1]

    def coef(v, b):
        return torch.full((b,), v, device=dev)

    # K3 on a whole model output (DDPM++): the cases of the serving chain
    cases = [  # (label, at, at_next, eta, with noise, dt_lambda, apply_dt)
        ("generation eta=1", 0.80, 0.85, 1.0, True, 1.0, None),
        ("generation eta=0", 0.30, 0.35, 0.0, False, 1.0, None),
        ("t_next=-1 eta=1", 0.9999, 1.0, 1.0, True, 1.0, None),
        ("inversion", 0.35, 0.30, 0.0, False, 1.0, None),
        ("dt_lambda", 0.30, 0.35, 0.0, False, 0.9, 1.0),
    ]
    for model_dtype in (torch.float32, torch.bfloat16):
        dname = dname_of(model_dtype)
        es = torch.tensor([], dtype=model_dtype).element_size()
        for batch in (1, 8):
            shape = (batch, 256, 256, 3)
            n = batch * 256 * 256 * 3
            for i, (label, a, an, eta, with_z, dtl, adt) in enumerate(cases):
                if (batch > 1 or model_dtype != torch.float32) and i:
                    continue  # batch 8 and a bf16 model output: the eta=1 step
                co = (coef(a, batch), coef(an, batch), coef(eta, batch))
                kw = dict(dt_lambda=dtl, apply_dt=None if adt is None else coef(adt, batch))
                n_bytes = n * (4 + 2 * es + 4 * with_z + 8)
                sets = input_sets(lambda: (randn(*shape), randn(*shape, dtype=model_dtype),
                                           randn(*shape, dtype=model_dtype), *co,
                                           randn(*shape) if with_z else None), n_bytes)
                res = step_row(torch, "ddim_step", dname,
                               f"{list(shape)} f32 carry, {dname} model output, {label}",
                               lambda *a_: k3.ddim_step(*a_, **kw),
                               lambda *a_: k3.ddim_step_plain(*a_, **kw), sets, n_bytes, 25 * n,
                               k3.ddim_launch_args(*sets[0], **kw).mode)
                keep(res, batch == 1 and i == 0)

    # the OpenAI path's steps: eps (eps_mod, the learned log-variance) are
    # strided views of a learn_sigma model's [B, 256, 256, 6] output
    for model_dtype in (torch.float32, torch.bfloat16):
        dname = dname_of(model_dtype)
        es = torch.tensor([], dtype=model_dtype).element_size()
        for batch in (1, 8):
            shape = (batch, 256, 256, 3)
            n = batch * 256 * 256 * 3

            def learn_sigma_output():
                raw = randn(*shape[:-1], 6)
                raw[..., 3:] = -2.0 + 0.5 * raw[..., 3:]  # a log-variance's range
                return raw.to(model_dtype)

            a_t, an_t, one, bt = coef(0.80, batch), coef(0.85, batch), coef(1.0, batch), \
                coef(0.02, batch)
            n_bytes = n * (4 + 2 * es + 4 + 8)

            def k3_set():
                r, r_mod = learn_sigma_output(), learn_sigma_output()
                return randn(*shape), r[..., :3], r_mod[..., :3], a_t, an_t, one, randn(*shape)

            sets = input_sets(k3_set, n_bytes)
            res = step_row(torch, "ddim_step_learn_sigma", dname,
                           f"{list(shape)} f32 carry, {dname} model output, eta=1",
                           k3.ddim_step, k3.ddim_step_plain, sets, n_bytes, 25 * n,
                           k3.ddim_launch_args(*sets[0]).mode)
            keep(res, batch == 1)
            ddpm_cases = (("learned logvar", None, 999.0),
                          ("table logvar", coef(-3.9, batch), 999.0),
                          ("learned logvar, t=0", None, 0.0))
            for i, (label, table, t_) in enumerate(ddpm_cases):
                if batch > 1 and i:
                    continue
                t_dev = coef(t_, batch)

                def ddpm_set():
                    r = learn_sigma_output()
                    lv = r[..., 3:] if table is None else table
                    return randn(*shape), r[..., :3], lv, bt, a_t, t_dev, randn(*shape)

                n_bytes = n * (4 + es + es * (table is None) + 4 + 4)
                sets = input_sets(ddpm_set, n_bytes)
                res = step_row(torch, "ddpm_step", dname,
                               f"{list(shape)} f32 carry, {dname} model output, {label}",
                               kddpm.ddpm_step, kddpm.ddpm_step_plain, sets, n_bytes, 12 * n,
                               kddpm.ddpm_launch_args(*sets[0]).mode)
                keep(res, batch == 1 and i == 0)

    # K3-bwd at the training path's shapes (an f32 carry, eps in the model's
    # dtype, eta 0): x0_t's cotangent alone to d eps_mod (the edited training
    # step's), and both cotangents to all three gradients
    for model_dtype in (torch.float32, torch.bfloat16):
        dname = dname_of(model_dtype)
        es = torch.tensor([], dtype=model_dtype).element_size()
        for label, batch, needs, both in (("x0_t alone -> d eps_mod", 1, (False, False, True), False),
                                          ("both cotangents -> dx, d eps, d eps_mod", 1,
                                           (True, True, True), True),
                                          ("x0_t alone -> d eps_mod", 8, (False, False, True),
                                           False)):
            shape = (batch, 256, 256, 3)
            n = batch * 256 * 256 * 3
            x = randn(*shape).requires_grad_(needs[0])
            eps = randn(*shape, dtype=model_dtype).requires_grad_(needs[1])
            eps_mod = randn(*shape, dtype=model_dtype).requires_grad_(needs[2])
            # eta as a device tensor: as a Python number the plain version would
            # copy it to the card, and wait for it, at every call
            coeffs = (coef(0.30, batch), coef(0.35, batch), coef(0.0, batch), 1.0, None)
            wanted = [t for t in (x, eps, eps_mod) if t.requires_grad]
            n_bytes = n * (4 * (1 + both) + 4 * needs[0] + es * (needs[1] + needs[2]))
            sets = input_sets(lambda: (randn(*shape) if both else None, randn(*shape)), n_bytes)
            g_xn, g_x0 = sets[0]

            def autograd(fn):
                x_next, x0_t = fn(x, eps, eps_mod, *coeffs[:3])
                outs, cots = ((x_next, x0_t), (g_xn, g_x0)) if both else ((x0_t,), (g_x0,))
                return torch.autograd.grad(outs, wanted, cots)

            dtypes = (torch.float32, model_dtype, model_dtype)
            checks = list(zip(autograd(k3.ddim_step), autograd(k3.ddim_step_plain)))

            def kernel(g_xn_, g_x0_):
                return k3._ddim_step_bwd_cuda(g_xn_, g_x0_, coeffs, dtypes, needs)

            def plain(g_xn_, g_x0_):
                grads = k3.ddim_step_backward(g_xn_, g_x0_, *coeffs[:3], needs=needs)
                return [None if g_ is None else g_.to(d_) for g_, d_ in zip(grads, dtypes)]

            mode = k3.ddim_bwd_launch_args(g_xn, g_x0, *coeffs[:3], model_dtype).mode
            res = step_row(torch, "ddim_step_bwd", dname,
                           f"{list(shape)} f32 carry, {dname} eps, {label}", kernel, plain, sets,
                           n_bytes, 6 * n, mode, checks)
            keep(res, batch == 1 and not both)
    return out


class _RunnerLog(logging.Handler):
    """Collects the runner's per-grid serving records and per-iteration
    training records, and the LPIPS stage's per-batch records."""

    def __init__(self):
        super().__init__()
        self.grids, self.iters, self.lpips = [], [], []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("serving on"):
            self.grids.append(record.args)
        elif msg.startswith("iter "):
            self.iters.append(msg)
        elif msg.startswith("lpips chain batch"):
            self.lpips.append(record.args)


def write_images(ws: str, n: int = 2, sub: str = "imgs", ext: str = "png") -> str:
    import numpy as np
    from PIL import Image

    imgs = os.path.join(ws, sub)
    os.makedirs(imgs, exist_ok=True)
    rng = np.random.RandomState(SEED)
    for i in range(n):
        Image.fromarray((rng.rand(IMAGE, IMAGE, 3) * 255).astype(np.uint8)).save(
            os.path.join(imgs, f"{i}.{ext}"))
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
        _, n_grids, first_ms, last_ms, _, _, n_chain, _ = log.grids[-1]  # last: the p50 of the rest
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


def chain_phase(torch, dev, card, ws, argv, config, ckpt, pairs, eps_check=False,
                steps: int = STEPS):
    """The float32 serving chain (invert + edit, `steps` + `steps`) with
    kernels vs plain versions on the card, from the CLI run's first test
    image and the same noise; then its time per dtype. With `eps_check`, one
    edited eval at t = 999 must give eps far from zero and eps_mod apart
    from eps."""
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
    seq = uniform_seq(steps, 999)
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
    phase(f"  float32 invert+edit chain ({steps}+{steps} steps, bs 1), kernels vs plain: "
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
        # the first run warms up (one more timed run until phase 14 came: cut for
        # the time limit)
        for _ in range(2):
            t0 = time.perf_counter()
            out = timed(model, edit, x0, gen())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(out).all():
            fail(f"non-finite {dname} chain output")
        chain_ms[dname] = times[1]
        phase(f"  {dname} invert+edit chain ({steps}+{steps} steps, bs 1) on {card}: "
              f"runs {', '.join(f'{t:.1f}' for t in times)} ms (first warms up)")
    return err, chain_ms, per_request, (runner.spec, model, edit)


def _kernel_family(name: str) -> str:
    n = name.lower()
    if "gn_" in n:
        return "K1 group_norm"
    if "attn_" in n:
        return "K2 attention"
    if any(s in n for s in STEP_KERNEL.values()):
        return "K3/ddpm steps"
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
            "--n_train_img", "1", "--bs_train", "1", "--lr_training", "0.5",
            "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
            "--do_test", "1", "--n_test_img", "1",
            "--custom_train_dataset_dir", imgs, "--custom_test_dataset_dir", imgs,
            "--work_dir", ws, "--seed", str(SEED), "--ni"]
    return argv + (["--bf16"] if bf16 else []) + list(extra)


def trained_block(ws: str, exp: str, category: str = "CUSTOM"):
    from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint

    paths = glob.glob(os.path.join(ws, "checkpoint", f"{exp}_LC_{category}_t999_ninv*_1.pth"))
    if len(paths) != 1:
        fail(f"training wrote no single checkpoint of {exp} in {ws}: {paths}")
    return load_delta_checkpoint(paths[0])["blocks"][0]


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

    steps = int(argv[len(argv) - 1 - argv[::-1].index("--n_train_step") + 1])
    n_edit = sum(1 for t in np.linspace(0, 1, steps) * 999 if t >= T_EDIT)
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
    # the category, and for IMAGENET the class name, name the cache
    (test_pairs,) = glob.glob(os.path.join(ws, "precomputed", f"{category}_*test_*_pairs.npz"))
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
    from asyrp_official_torch.cli.main import load_config
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

    ws_f32 = os.path.join(ws_root, "train", "float32")
    ws = os.path.join(ws_root, "train", "plain")
    results["float32_vs_plain"] = plain_training_run(
        ws_f32, ws, train_argv(ws, imgs, clip_ckpt, "plain",
                               extra=["--do_test", "0", "--save_train_image", "0"]),
        "plain", init, blocks["float32"])
    check = gradient_check(torch, train_argv(ws_f32, imgs, clip_ckpt, "train_float32"), CONFIG,
                           {"K1-bwd dweight x 1.01": lambda: k1_bwd_fault(1.01, 1.0),
                            "K1-bwd dx x 1.01": lambda: k1_bwd_fault(1.0, 1.01)})
    gate(check, card)
    results["gradient_check"] = check
    imgs4 = write_images(os.path.join(ws_root, "train"), n=max(REMAT_BATCHES), sub="imgs4")
    # the --allow_random_weights init of --seed, saved once: --model_path
    # then spares each run of the reading the host's seeded init
    seeded = os.path.join(ws_root, "train", "seeded.pt")
    torch.save(spec.state_dict_from_jax(spec.init(hostrng.PRNGKey(SEED))), seeded)
    results["remat"] = remat_reading(
        torch, card, log, "training path", os.path.join(ws_root, "train"),
        lambda ws, exp, bf16, extra: train_argv(
            ws, imgs, clip_ckpt, exp, bf16=bf16, extra=["--model_path", seeded, *(
                ["--custom_train_dataset_dir", imgs4] if "--bs_train" in extra else []), *extra]),
        ws_f32)
    return results, launches


def plain_training_run(ws_f32: str, ws: str, argv, exp: str, init, trained,
                       category: str = "CUSTOM"):
    """The float32 training run of `ws_f32` again, from the same latents
    (its pairs cache), with the plain versions: the block `trained` with the
    kernels within TRAIN_TOL of it, its update from `init` within
    UPDATE_TOL. 76 SGD steps through the L1 term's sign amplify any rounding
    difference (two runs of the kernels, whose cuDNN backward sums in no
    fixed order, drift apart about as far as kernels and plain), so the
    trained update is a coarse end-to-end check; the one-timestep gradient
    is the kernels' gate."""
    from asyrp_official_torch.cli.main import main as cli_main

    shutil.copytree(os.path.join(ws_f32, "precomputed"), os.path.join(ws, "precomputed"))
    before = counters()
    t0 = time.perf_counter()
    with plain_versions():
        rc = cli_main(argv)
    plain_s = time.perf_counter() - t0
    if counters() != before:
        fail("the plain training run launched a kernel")
    if rc != 0:
        fail(f"training path (plain versions) exited {rc}")
    plain = trained_block(ws, exp, category)
    whole = tree_err(trained, plain)
    update = tree_err(tree_minus(trained, init), tree_minus(plain, init))
    phase(f"  float32 training from the same latents, kernels vs plain versions, max |a - b| / "
          f"max |b| over the whole block: trained block {whole:.3e} (tol {TRAIN_TOL:g}), its "
          f"update from the init {update:.3e} (tol {UPDATE_TOL:g}); plain run {plain_s:.1f} s")
    if whole > TRAIN_TOL or update > UPDATE_TOL:
        fail(f"the block trained with the kernels disagrees with the plain run: block {whole:.3e}, "
             f"update {update:.3e}")
    return {"whole_block_rel_err": whole, "update_rel_err": update, "plain_run_s": plain_s}


# the --remat reading of phases 7 and 12 (d): float32 at bs 1 with and
# without --remat from the same latents, deterministic cuDNN (the Δ leaves
# within REMAT_TOL of each other, absolute), and bfloat16 peak memory at
# these batch sizes with and without it (REMAT_STEPS-step grids, one
# iteration: the peak is one edited timestep's backward)
REMAT_TOL = 1e-5
REMAT_BATCHES = (1, 4)
REMAT_STEPS = 4


def remat_run(torch, log, argv, ws: str, exp: str, category: str, latents_from=None,
              block: bool = True):
    """One `--run_train` through the CLI with the counters zeroed just
    before and read just after: (results, the trained block of its second
    iteration, or None without `block`)."""
    from asyrp_official_torch.cli.main import main as cli_main

    if latents_from is not None:
        shutil.copytree(os.path.join(latents_from, "precomputed"), os.path.join(ws, "precomputed"))
    zero_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_logs = len(log.iters)
    t0 = time.perf_counter()
    with deterministic_cudnn(torch):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{exp} exited {rc}")
    timing = [re.search(r"([\d.]+) ms/edit-timestep", m) for m in log.iters[n_logs:]]
    return ({"peak_gb": torch.cuda.max_memory_allocated() / 2**30, "run_s": wall,
             "ms_per_edit_timestep": float(timing[-1].group(1)), "launches": counters()},
            trained_block(ws, exp, category) if block else None)


def remat_reading(torch, card, log, what: str, root: str, argv_of, latents_from: str,
                  category: str = "CUSTOM"):
    """`--remat` on a full-width training path: float32 at bs 1 with and
    without it from the latents of `latents_from` (the phase's float32
    run): peak memory, ms per edited timestep, the Δ leaves within
    REMAT_TOL, K1 launched more often (the recompute); then bfloat16 peak
    memory at REMAT_BATCHES with and without it. `argv_of(ws, exp, bf16,
    extra)` is the path's training argv."""
    import numpy as np

    t0 = time.perf_counter()
    out, blocks = {"float32": {}}, {}
    once = ["--do_test", "0", "--save_train_image", "0"]
    for remat in (False, True):
        tag = "remat" if remat else "plain"
        ws, exp = os.path.join(root, f"remat_f32_{tag}"), f"remat_f32_{tag}"
        out["float32"][tag], blocks[tag] = remat_run(
            torch, log, argv_of(ws, exp, False, once + (["--remat"] if remat else [])), ws, exp,
            category, latents_from=latents_from)
    a, b = out["float32"]["plain"], out["float32"]["remat"]
    d_err = max(float(np.abs(blocks["remat"][g][k] - blocks["plain"][g][k]).max())
                for g in blocks["plain"] for k in blocks["plain"][g])
    out["float32"]["delta_max_abs_diff"] = d_err
    phase(f"  {what} --remat on {card}, float32 bs 1 from the same latents (deterministic "
          f"cuDNN): peak {a['peak_gb']:.2f} -> {b['peak_gb']:.2f} GiB, "
          f"{a['ms_per_edit_timestep']:.1f} -> {b['ms_per_edit_timestep']:.1f} ms per edited "
          f"timestep, K1 launches {a['launches']['group_norm']} -> "
          f"{b['launches']['group_norm']} (K1-bwd {a['launches']['group_norm_bwd']} -> "
          f"{b['launches']['group_norm_bwd']}); Δ leaves max |a - b| {d_err:.3e} (tol "
          f"{REMAT_TOL:g})")
    if d_err > REMAT_TOL:
        fail(f"{what}: --remat moved the trained Δ by {d_err:.3e}")
    if not b["launches"]["group_norm"] > a["launches"]["group_norm"]:
        fail(f"{what}: --remat launched K1 no more often: {a['launches']} vs {b['launches']}")
    if not b["peak_gb"] < a["peak_gb"]:
        fail(f"{what}: --remat did not lower the peak: {a['peak_gb']:.2f} vs {b['peak_gb']:.2f}")
    out["bfloat16_peak_gb"] = {}
    for bs in REMAT_BATCHES:
        for remat in (False, True):
            tag = f"bs{bs}_{'remat' if remat else 'plain'}"
            ws, exp = os.path.join(root, f"remat_bf16_{tag}"), f"remat_bf16_{tag}"
            extra = once + ["--n_train_img", str(bs), "--bs_train", str(bs), "--n_iter", "1",
                            "--n_inv_step", str(REMAT_STEPS), "--n_train_step", str(REMAT_STEPS)]
            res, _ = remat_run(torch, log, argv_of(ws, exp, True, extra + (
                ["--remat"] if remat else [])), ws, exp, category, block=False)
            out["bfloat16_peak_gb"][tag] = res["peak_gb"]
    pk = out["bfloat16_peak_gb"]
    out["seconds"] = time.perf_counter() - t0
    phase(f"  {what} --remat, bfloat16 peak device memory ({REMAT_STEPS}-step grid, one "
          f"iteration): " + ", ".join(f"bs {bs} {pk[f'bs{bs}_plain']:.2f} -> "
                                      f"{pk[f'bs{bs}_remat']:.2f} GiB" for bs in REMAT_BATCHES)
          + f" of {torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}; the reading "
          f"took {out['seconds']:.1f} s")
    return out


def openai_family(fam: str):
    """(config, category, the category of its latent caches, extra flags)
    of an OpenAI-family configuration the smoke run serves and trains:
    `afhq` (iDDPM AFHQ-dog, `afhq.yml`) or `imagenet` (ADM 256^2,
    `imagenet.yml`, one class by --target_class_num, whose name the
    caches carry)."""
    if fam == "afhq":
        return AFHQ_CONFIG, "AFHQ", "AFHQ", ()
    from asyrp_official_torch.data.datasets import imagenet_classes

    name = imagenet_classes()[str(IMAGENET_CLASS)][1]
    return (IMAGENET_CONFIG, "IMAGENET", f"IMAGENET_{name}",
            ("--target_class_num", str(IMAGENET_CLASS)))


def openai_train_argv(fam: str, ws: str, model_path: str, clip_ckpt: str, exp: str,
                      bf16: bool = False, extra=()):
    config, _, _, flags = openai_family(fam)
    argv = ["--config", config, "--exp", os.path.join(ws, "runs", exp),
            "--run_train", "--train_delta_block", "--edit_attr", AFHQ_ATTR,
            "--model_path", model_path, "--device", DEVICE, "--clip_ckpt", clip_ckpt,
            "--clip_loss_w", "1", "--l1_loss_w", "3", "--get_h_num", "1",
            "--n_inv_step", str(OPENAI_TRAIN_STEPS), "--n_train_step", str(OPENAI_TRAIN_STEPS),
            "--n_iter", "2",
            # one training image (two until phase 14 came: cut for the time limit)
            "--n_train_img", "1", "--bs_train", "1", "--lr_training", "0.5",
            "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
            "--do_test", "1", "--n_test_img", "1", "--work_dir", ws, "--seed", str(SEED), "--ni",
            *flags]
    return argv + (["--bf16"] if bf16 else []) + list(extra)


def openai_train_phase(torch, card, log, fam: str, root: str, model_path: str, clip_ckpt: str,
                       plain_run: bool = False):
    """Phase 9 (`afhq`) and phase 12 (d) (`imagenet`): Δ-training of an
    OpenAI DeltaBlock on the full-width UNet of `model_path` through the
    port's CLI, float32 and bfloat16, each run in a work dir of its own
    (the training images are in place); with `plain_run`, the float32 run
    again with the plain versions; then the gate of the multi-head
    attention backward (K2-bwd-MH)."""
    from asyrp_official_torch.cli.main import load_config
    from asyrp_official_torch.models.delta import delta_block_init
    from asyrp_official_torch.models.registry import spec_from_config
    from asyrp_official_torch.utils import hostrng

    config, category, _, _ = openai_family(fam)
    spec = spec_from_config(load_config(config))
    init = delta_block_init(hostrng.PRNGKey(SEED), spec.bottleneck_ch, spec.temb_ch,
                            flavor="openai")
    results, blocks = {}, {}
    for dname in DTYPES:
        ws, exp = os.path.join(root, f"train_{dname}"), f"{fam}_{dname}"
        results[dname], blocks[dname] = cli_train_run(
            torch, card, log,
            openai_train_argv(fam, ws, model_path, clip_ckpt, exp, bf16=dname == "bfloat16"), ws,
            exp, f"{category} training path {dname}", OPENAI_TRAIN_KERNELS, init,
            category=category)
        counts = results[dname]["launches"]
        if counts["attention"] or counts["attention_bwd"]:
            fail(f"{category} training path {dname} launched the single-head attention: {counts}")
    ws_f32 = os.path.join(root, "train_float32")
    if plain_run:
        ws = os.path.join(root, "train_plain")
        results["float32_vs_plain"] = plain_training_run(
            ws_f32, ws, openai_train_argv(fam, ws, model_path, clip_ckpt, f"{fam}_plain",
                                          extra=["--do_test", "0", "--save_train_image", "0"]),
            f"{fam}_plain", init, blocks["float32"], category)
    check = gradient_check(
        torch, openai_train_argv(fam, ws_f32, model_path, clip_ckpt, f"{fam}_float32"), config,
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


def leaves(tree, prefix: str = ""):
    """{path: array} of a nested dict of arrays (a JAX-layout block, or rows by timestep)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_err(a, b) -> float:
    """max |a - b| / max |b| over the leaves of two trees of one layout."""
    import numpy as np

    la, lb = leaves(a), leaves(b)
    diff = max(float(np.abs(la[k] - lb[k]).max()) for k in lb)
    return diff / max(float(np.abs(v).max()) for v in lb.values())


def tree_minus(a, b):
    """a - b, leaf by leaf."""
    la = leaves(a)
    return {k: la[k] - v for k, v in leaves(b).items()}


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
    ctx, _, _ = build_contexts(args, dev)
    runner = AsyrpRunner(args, load_config(config), clip_ctx=ctx, work_dir=args.work_dir)
    runner.set_interval()
    spec = runner.spec
    model = runner.load_pretrained()
    pairs = runner.get_pairs(model, "train")  # the run's cache
    x = torch.from_numpy(pairs["x_lat"][:1]).to(dev)
    x0 = torch.from_numpy(pairs["x0"][:1]).to(dev)
    seq, seq_next = train_seq(args.n_train_step, 999, T_EDIT)
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


def openai_argv(fam: str, ws: str, model_path: str, bf16: bool = False, steps: int = STEPS,
                sample_type: str = "ddim"):
    config, _, _, flags = openai_family(fam)
    argv = ["--config", config, "--exp", os.path.join(ws, "runs", fam),
            "--run_test", "--train_delta_block", "--model_path", model_path, "--device", DEVICE,
            "--work_dir", ws, "--manual_checkpoint_name", f"{fam}_delta.pth",
            "--n_inv_step", str(steps), "--n_test_step", str(steps),
            "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
            "--bs_train", "1", "--n_test_img", "2", "--do_train", "0", "--save_x_origin",
            "--sample_type", sample_type, "--seed", str(SEED), "--ni", *flags]
    return argv + (["--bf16"] if bf16 else [])


AFHQ_RUNS = (  # (label, --bf16, steps, --sample_type)
    ("float32", False, STEPS, "ddim"), ("bfloat16", True, STEPS, "ddim"),
    ("ddpm float32", False, DDPM_STEPS, "ddpm"))
# phase 12 (b)'s serving grids (40 until phase 14 came, 20 until phase 15 came:
# cut for the time limit) and (c)'s chain (40 + 40 until phase 15 came, 20 + 20
# until phase 15 (e)-(f) came)
IMAGENET_SERVE_STEPS = 10
IMAGENET_CHAIN_STEPS = 10
IMAGENET_RUNS = (("float32", False, IMAGENET_SERVE_STEPS, "ddim"),
                 ("bfloat16", True, IMAGENET_SERVE_STEPS, "ddim"))


def openai_phase(torch, card, log, fam: str, root: str, model_path: str, runs):
    """Phase 8 (`afhq`) and phase 12 (b) (`imagenet`): OpenAI-family serving
    through the port's CLI, one run per entry of `runs`, each in a work dir
    of its own; the counters are zeroed just before each run and read just
    after it. The test latents' cache must carry the family's cache
    category (for IMAGENET, the class name)."""
    import numpy as np
    from PIL import Image

    from asyrp_official_torch.cli.main import main as cli_main

    _, category, cache_category, _ = openai_family(fam)
    timings, launches = {}, {}
    for label, bf16, steps, sample_type in runs:
        what = f"{category} serving path ({label})"
        ws = os.path.join(root, label.replace(" ", "_"))
        os.makedirs(os.path.join(ws, "checkpoint"))
        shutil.copy(os.path.join(root, f"{fam}_delta.pth"), os.path.join(ws, "checkpoint"))
        zero_counters()
        t0 = time.perf_counter()
        rc = cli_main(openai_argv(fam, ws, model_path, bf16, steps, sample_type))
        wall = time.perf_counter() - t0
        counts = counters()
        if rc != 0:
            fail(f"{what} exited {rc}")
        require_launches(counts, ("group_norm", "attention_mh", "ddim_step")
                         + (("ddpm_step",) if sample_type == "ddpm" else ()), what)
        if counts["attention"]:
            fail(f"{what} launched the single-head attention: {counts}")
        grids = sorted(os.path.join(r, f) for r, _, fs in os.walk(os.path.join(ws, "runs"))
                       for f in fs if f.endswith(".png"))
        if len(grids) != 2:
            fail(f"{what}: expected 2 grids, found {grids}")
        for g in grids:
            arr = np.asarray(Image.open(g))
            if arr.shape != (2 * IMAGE + 3, IMAGE + 2, 3):
                fail(f"grid {g} has shape {arr.shape}")
        cache = f"{cache_category}_test_t999_nim2_ninv{steps}_pairs.npz"
        caches = sorted(os.listdir(os.path.join(ws, "precomputed")))
        if caches != [cache]:
            fail(f"{what}: expected the latent cache {cache}, found {caches}")
        pairs = np.load(os.path.join(ws, "precomputed", cache))
        for k in ("x_lat", "x_rec"):
            if not np.isfinite(pairs[k]).all():
                fail(f"{what}: non-finite {k}")
        _, n_grids, first_ms, last_ms, _, _, n_chain, _ = log.grids[-1]  # last: the p50 of the rest
        per_step = last_ms / (2 * n_chain)
        timings[label] = {"grid_ms_first": first_ms, "grid_ms": last_ms, "ms_per_step": per_step,
                          "run_s": wall}
        launches[label] = counts
        phase(f"  {category} serving path {label} ({sample_type}) on {card}: rc 0, 2 grids, "
              f"cache {cache}, launches {counts}; per grid ({n_chain}-step plain + "
              f"{n_chain}-step edited generation, bs 1): first {first_ms:.1f} ms, second "
              f"{last_ms:.1f} ms = {per_step:.2f} ms/step; whole CLI run incl. loading and "
              f"2x{steps}+{steps} precompute steps {wall:.1f} s")
    return timings, launches

# ---------------------------------------------------------------------------
# phase 10: the h-rows path and the multi-edit serving modes
# ---------------------------------------------------------------------------

ROWS_TEST_STEPS = 20  # phase 10's serving grid: not the training grid, so rows are remapped
SWEEP_ATTRS = ("smiling", "angry")
# --num_delta of the sweep: its coefficient pairs are SWEEP_NUM_DELTA ** 2 (3, 9
# pairs, until phase 14 came: cut for the time limit)
SWEEP_NUM_DELTA = 2
SWEEP_PAIRS = SWEEP_NUM_DELTA ** 2


def rows_argv(ws: str, imgs: str, clip_ckpt: str, exp: str, model_path: str, bf16: bool = False,
              extra=()):
    """Phase 7's training recipe with the per-timestep Δh rows
    (`--train_delta_h --delta_injection add`) as the trainable, from the
    random weights of --seed written once to `model_path`."""
    argv = train_argv(ws, imgs, clip_ckpt, exp, bf16,
                      ["--delta_injection", "add", "--model_path", model_path, *extra])
    argv[argv.index("--train_delta_block")] = "--train_delta_h"
    argv.remove("--allow_random_weights")
    return argv


def trained_rows(ws: str, exp: str, it: int = 1):
    from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint

    path = os.path.join(ws, "checkpoint", f"{exp}_LC_CUSTOM_t999_ninv{STEPS}_ngen{STEPS}_{it}.pth")
    if not os.path.exists(path):
        fail(f"rows training wrote no checkpoint {path}")
    return load_delta_checkpoint(path)["delta_rows"]


def rows_run(torch, card, log, argv, ws: str, exp: str, what: str, init, it: int = 1):
    """One `--run_train --train_delta_h` run through the port's CLI,
    in-process, with the launch counters zeroed just before it and read just
    after: rc 0, every training kernel launched, finite losses, finite rows
    moved from `init`. Returns (results, trained rows)."""
    import numpy as np

    from asyrp_official_torch.cli.main import main as cli_main

    zero_counters()
    n_logs = len(log.iters)
    t0 = time.perf_counter()
    rc = cli_main(argv)
    wall = time.perf_counter() - t0
    counts = counters()
    if rc != 0:
        fail(f"{what} exited {rc}")
    require_launches(counts, TRAIN_KERNELS, what)
    rows = trained_rows(ws, exp, it)
    if sorted(rows) != sorted(init) or not all(np.isfinite(v).all() for v in rows.values()):
        fail(f"{what}: rows {sorted(rows)} (want {sorted(init)}) or non-finite values")
    moved = max(float(np.abs(rows[t] - init[t]).max()) for t in init)
    losses = [float(re.search(r"mean loss (\S+)", m).group(1)) for m in log.iters[n_logs:]]
    if not losses or not all(np.isfinite(losses)):
        fail(f"{what}: losses {losses}")
    timing = re.search(r"([\d.]+) ms/batch -> ([\d.]+) ms/edit-timestep", log.iters[-1])
    res = {"rc": rc, "losses": losses, "run_s": wall, "launches": counts,
           "rows_max_abs_change": moved, "ms_per_batch": float(timing.group(1)),
           "ms_per_edit_timestep": float(timing.group(2))}
    phase(f"  {what} on {card}: rc 0, losses per iteration {losses}, {len(rows)} rows moved by "
          f"up to {moved:.3e}; {timing.group(1)} ms/batch -> {timing.group(2)} ms per edited "
          f"timestep; launches {counts}; whole CLI run {wall:.1f} s")
    return res, rows


def rows_gradient_check(torch, argv, init):
    """One edited timestep's (t = 999) gradient with respect to the Δh rows
    (the CLIP term plus a fixed random linear functional of x0_t, as
    `gradient_check`), kernels vs plain versions, float32 and bfloat16, from
    the float32 run's latents; every row but 999's must get exactly 0."""
    import numpy as np

    from asyrp_official_torch.cli.main import build_contexts, build_parser, load_config
    from asyrp_official_torch.core.schedule import train_seq
    from asyrp_official_torch.losses.clip_loss import train_clip_term
    from asyrp_official_torch.models.delta import EditState, rows_to_nchw
    from asyrp_official_torch.ops import ddim_step as k3
    from asyrp_official_torch.runner import AsyrpRunner

    args = build_parser().parse_args(argv)
    dev = torch.device(DEVICE)
    ctx, _, _ = build_contexts(args, dev)
    runner = AsyrpRunner(args, load_config(CONFIG), clip_ctx=ctx, work_dir=args.work_dir)
    runner.set_interval()
    spec, model = runner.spec, runner.load_pretrained()
    pairs = runner.get_pairs(model, "train")
    x = torch.from_numpy(pairs["x_lat"][:1]).to(dev)
    x0 = torch.from_numpy(pairs["x0"][:1]).to(dev)
    seq, seq_next = train_seq(STEPS, 999, T_EDIT)
    acp = torch.from_numpy(runner.schedule.alphas_cumprod_ext).to(dev)
    t_b = torch.full((1,), 999.0, device=dev)
    at, at_next = acp[1000].reshape(1), acp[seq_next[-1] + 1].reshape(1)
    extra = train_clip_term(ctx, runner.src_txts[0], runner.trg_txts[0], 1.0)
    cotangent = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    leaf = rows_to_nchw(np.stack([init[t] for t in seq])).to(dev).requires_grad_(True)
    edit = EditState(mode="input", delta_rows=leaf, hs_coeff=torch.tensor([1.0, 1.0], device=dev),
                     input_style="add", times=tuple(seq))
    e = edit.at_step({"use_delta": 1.0, "delta_idx": len(seq) - 1})  # t = 999's row

    def grad(dtype):
        leaf.grad = None
        eps, eps_mod, _, _ = spec.apply(model, x.to(dtype), t_b, edit=e, decode_mode="split")
        _, x0_t = k3.ddim_step(x, eps, eps_mod, at, at_next, 0.0)
        ((x0_t * cotangent).mean() + extra(x0, x0_t)).backward()
        g = leaf.grad.float()
        if g[:-1].abs().max() != 0:
            fail("the rows gradient of t = 999 reached another timestep's row")
        return g[-1].cpu().numpy()

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        zero_counters()
        kernels = grad(torch.float32)
        launches = counters()
        kernels_bf = grad(torch.bfloat16)
        with plain_versions():
            plain, plain_bf = grad(torch.float32), grad(torch.bfloat16)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"float32": rel(kernels, plain), "bfloat16": {"kernels": rel(kernels_bf, plain),
                                                         "plain": rel(plain_bf, plain)},
            "grad_norm": float(np.linalg.norm(plain)), "launches": launches}


def rows_serve_argv(ws: str, imgs: str, model_path: str, exp: str, extra=()):
    return ["--config", CONFIG, "--exp", os.path.join(ws, "runs", exp), "--run_test",
            "--edit_attr", "smiling", "--model_path", model_path, "--device", DEVICE,
            "--custom_train_dataset_dir", imgs, "--custom_test_dataset_dir", imgs,
            "--work_dir", ws, "--n_inv_step", str(STEPS), "--n_train_step", str(STEPS),
            "--n_test_step", str(ROWS_TEST_STEPS), "--n_iter", "2", "--bs_train", "1",
            "--n_train_img", "2", "--n_test_img", "1", "--user_defined_t_edit", str(T_EDIT),
            "--user_defined_t_addnoise", str(T_ADDNOISE), "--seed", str(SEED), "--ni", *extra]


def serve_run(torch, card, log, argv, what: str, kernels=("group_norm", "attention", "ddim_step"),
              grids=None, plain=False):
    """One `--run_test` through the port's CLI, in-process, counters zeroed
    just before and read just after; every grid it writes must be finite.
    With a list `grids`, each grid's float rows are appended to it as the
    runner writes them. With `plain`, it runs the plain versions and must
    launch no kernel. Returns its results."""
    from unittest import mock

    from asyrp_official_torch import runner
    from asyrp_official_torch.cli.main import main as cli_main

    def keep(rows, *a, **kw):
        grids.append(rows)
        return save_image(rows, *a, **kw)

    save_image = runner.save_image
    zero_counters()
    n_logs = len(log.grids)
    t0 = time.perf_counter()
    patch = (mock.patch.object(runner, "save_image", keep) if grids is not None
             else contextlib.nullcontext())
    with patch, plain_versions() if plain else contextlib.nullcontext():
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    counts = counters()
    if rc != 0:
        fail(f"{what} exited {rc}")
    require_launches(counts, kernels, what)
    if plain and any(counts.values()):
        fail(f"{what} launched a kernel: {counts}")
    if len(log.grids) != n_logs + 1:
        fail(f"{what}: no serving record")
    _, n_grids, first_ms, p50_ms, _, _, n_chain, _ = log.grids[-1]
    res = {"rc": rc, "grids": n_grids, "grid_ms_first": first_ms, "grid_ms_p50": p50_ms,
           "chain_steps": n_chain, "run_s": wall, "launches": counts}
    phase(f"  {what} on {card}: rc 0, {n_grids} grid(s), first {first_ms:.1f} ms, p50 "
          f"{p50_ms:.1f} ms per grid ({n_chain}-step chain); launches {counts}; whole CLI run "
          f"{wall:.1f} s")
    return res


def grid_files(ws: str, exp: str):
    from PIL import Image
    import numpy as np

    root = os.path.join(ws, "runs", f"{exp}_LC_CUSTOM_t999_ninv{STEPS}_ngen{STEPS}")
    out = {}
    for r, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".png"):
                out[f] = np.asarray(Image.open(os.path.join(r, f)))
    return out


def rows_phase(torch, card, log, ws_root, clip_ckpt: str):
    """Phase 10: (a) Δh-rows training, float32 and bf16, the float32 run
    again with the plain versions, one timestep's rows gradient, and the dead
    slerp injection; (b) rows serving on a 20-step grid (the train→test
    remap), add and slerp; (c) the 4-pair multi-attribute sweep, float32
    and bf16, and the float32 sweep with the plain versions; (d) the
    mean-of-Δh harvest. Every run reuses phase 7's images and latents."""
    import numpy as np

    from asyrp_official_torch.cli.main import load_config, main as cli_main
    from asyrp_official_torch.compat import save_delta_checkpoint
    from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint
    from asyrp_official_torch.core.schedule import train_seq
    from asyrp_official_torch.models.delta import delta_block_init
    from asyrp_official_torch.models.registry import spec_from_config
    from asyrp_official_torch.utils import hostrng

    t_phase = time.perf_counter()
    imgs = os.path.join(ws_root, "train", "imgs")
    cache = os.path.join(ws_root, "train", "float32", "precomputed")
    root = os.path.join(ws_root, "rows")
    spec = spec_from_config(load_config(CONFIG))
    model_path = os.path.join(root, "unet_random.pt")
    os.makedirs(root)
    torch.save(spec.state_dict_from_jax(spec.init(hostrng.PRNGKey(SEED))), model_path)
    seq = train_seq(STEPS, 999, T_EDIT)[0]
    hw = spec.bottleneck_hw
    draw = np.float32(0.2) * hostrng.normal(hostrng.PRNGKey(SEED),
                                            (len(seq), hw, hw, spec.bottleneck_ch))
    init = {t: draw[i] for i, t in enumerate(seq)}

    def workspace(name):
        ws = os.path.join(root, name)
        shutil.copytree(cache, os.path.join(ws, "precomputed"))
        return ws

    out = {"launches": {}}
    phase(f"  (a) --run_train --train_delta_h --delta_injection add: {len(seq)} rows of "
          f"[{hw}, {hw}, {spec.bottleneck_ch}], 1 image, 2 iterations")
    rows = {}
    for dname in DTYPES:
        ws = workspace(f"train_{dname}")
        extra = () if dname == "float32" else ("--do_test", "0")
        out[dname], rows[dname] = rows_run(
            torch, card, log, rows_argv(ws, imgs, clip_ckpt, f"rows_{dname}", model_path,
                                        dname == "bfloat16", extra),
            ws, f"rows_{dname}", f"rows training {dname}", init)
    out["launches"]["rows training float32"] = out["float32"]["launches"]
    ws = workspace("train_plain")
    t0 = time.perf_counter()
    before = counters()
    with plain_versions():
        rc = cli_main(rows_argv(ws, imgs, clip_ckpt, "plain", model_path,
                                extra=("--do_test", "0", "--save_train_image", "0")))
    if rc != 0 or counters() != before:
        fail(f"rows training with the plain versions: rc {rc}, or it launched a kernel")
    plain = trained_rows(ws, "plain")
    whole = tree_err(rows["float32"], plain)
    update = tree_err(tree_minus(rows["float32"], init), tree_minus(plain, init))
    phase(f"  float32 rows training, kernels vs plain versions, max |a - b| / max |b| over all "
          f"rows: trained rows {whole:.3e} (tol {TRAIN_TOL:g}), their update {update:.3e} (tol "
          f"{UPDATE_TOL:g}); plain run {time.perf_counter() - t0:.1f} s")
    if whole > TRAIN_TOL or update > UPDATE_TOL:
        fail(f"rows trained with the kernels disagree with the plain run: {whole:.3e}, "
             f"{update:.3e}")
    check = rows_gradient_check(torch, rows_argv(os.path.join(root, "train_float32"), imgs,
                                                 clip_ckpt, "rows_float32", model_path), init)
    bf = check["bfloat16"]
    phase(f"  one edited timestep's gradient w.r.t. the t = 999 row (norm "
          f"{check['grad_norm']:.3e}), max |a - b| / max |b|: float32 kernels vs plain "
          f"{check['float32']:.3e} (tol {GRAD_TOL:g}); bfloat16 against the float32 plain: "
          f"kernels {bf['kernels']:.3e}, plain {bf['plain']:.3e} (tol {BF16_GRAD_FACTOR:g}x); "
          f"launches {check['launches']}")
    if check["float32"] > GRAD_TOL or bf["kernels"] > BF16_GRAD_FACTOR * bf["plain"]:
        fail(f"the rows gradient with the kernels disagrees with the plain one: {check}")
    out["float32_vs_plain"] = {"rows_rel_err": whole, "update_rel_err": update}
    out["gradient_check"] = check
    ws = workspace("train_slerp")
    rc = cli_main(rows_argv(ws, imgs, clip_ckpt, "slerp", model_path, extra=(
        "--delta_injection", "slerp", "--n_iter", "1", "--do_test", "0", "--save_train_image",
        "0")))
    dead = trained_rows(ws, "slerp", it=0) if rc == 0 else {}
    same = sorted(dead) == sorted(init) and all(
        np.isfinite(dead[t]).all() and np.array_equal(dead[t], init[t]) for t in init)
    phase(f"  --delta_injection slerp, 1 iteration (hs_coeff [1, 1]: t = 0, a dead mode): rc {rc}, "
          f"saved rows bit-identical to the init and finite: {same}")
    if not same:
        fail("the slerp rows training moved its rows or made them non-finite")

    phase(f"  (b) --run_test --train_delta_h on (a)'s float32 rows, {ROWS_TEST_STEPS}-step grid "
          f"(remapped from the {STEPS}-step training grid)")
    ws = os.path.join(root, "train_float32")
    for inj in ("add", "slerp"):
        res = serve_run(torch, card, log, rows_serve_argv(
            ws, imgs, model_path, f"serve_{inj}", (
                "--train_delta_h", "--delta_injection", inj, "--do_train", "0",
                "--manual_checkpoint_name",
                f"rows_float32_LC_CUSTOM_t999_ninv{STEPS}_ngen{STEPS}_1.pth")),
            f"rows serving ({inj}) float32")
        grids = grid_files(ws, f"serve_{inj}")
        if len(grids) != 1 or not all(np.isfinite(g).all() for g in grids.values()):
            fail(f"rows serving ({inj}): grids {sorted(grids)}")
        out[f"serve_{inj}"] = res
        out["launches"][f"rows serving {inj} float32"] = res["launches"]

    phase(f"  (c) --run_test --train_delta_block --multiple_attr \"{' '.join(SWEEP_ATTRS)}\" "
          f"--delta_interpolation --num_delta {SWEEP_NUM_DELTA}: {SWEEP_PAIRS} coefficient pairs, "
          "one generation each")
    ws = workspace("sweep")
    for i, attr in enumerate(SWEEP_ATTRS):
        save_delta_checkpoint(os.path.join(ws, "checkpoint", f"{attr}_sweep.pth"), blocks=[
            delta_block_init(hostrng.PRNGKey(SEED + 10 + i), spec.bottleneck_ch, spec.temb_ch)])

    def sweep(exp, dtype_flags=()):
        return rows_serve_argv(ws, imgs, model_path, exp, (
            "--train_delta_block", "--manual_checkpoint_name", "attribute_sweep.pth",
            "--multiple_attr", " ".join(SWEEP_ATTRS), "--delta_interpolation",
            "--num_delta", str(SWEEP_NUM_DELTA),
            "--do_train", "0", *dtype_flags))

    rows = {}
    for dname in DTYPES:
        rows[dname] = []
        res = serve_run(torch, card, log,
                        sweep(f"sweep_{dname}", ["--bf16"] * (dname != "float32")),
                        f"{SWEEP_PAIRS}-pair sweep {dname}", grids=rows[dname])
        (grid,) = grid_files(ws, f"sweep_{dname}").values()
        if grid.shape != (SWEEP_PAIRS * (IMAGE + 1) + 1, IMAGE + 2, 3) or len(rows[dname]) != 1:
            fail(f"{SWEEP_PAIRS}-pair sweep {dname}: grid {grid.shape}, {len(rows[dname])} grids")
        out[f"sweep_{dname}"] = res
        out["launches"][f"{SWEEP_PAIRS}-pair sweep {dname}"] = res["launches"]
    # the float32 sweep with the plain versions, same inputs
    plain = []
    res = serve_run(torch, card, log, sweep("sweep_plain"),
                    f"{SWEEP_PAIRS}-pair sweep float32, plain versions",
                    kernels=(), grids=plain, plain=True)
    (kern,), (ref,) = rows["float32"], plain
    err = float(np.abs(kern - ref).max() / np.abs(ref).max())
    walls = {k: out[f"sweep_{k}"]["grid_ms_p50"] for k in DTYPES}
    walls["float32 plain"] = res["grid_ms_p50"]
    phase(f"  {SWEEP_PAIRS}-pair sweep float32, kernels vs plain versions: max |a - b| / max |b| "
          f"{err:.3e} "
          f"(tol {CHAIN_TOL:g}); ms per grid of 9 edited {ROWS_TEST_STEPS}-step generations "
          f"(bs 1): {walls} on {card}")
    if err > CHAIN_TOL:
        fail(f"the sweep with the kernels disagrees with the plain versions: {err:.3e}")
    out["sweep_vs_plain"] = {"rel_err": err, "grid_ms": walls}

    phase("  (d) --num_mean_of_delta_hs 1 on a DeltaBlock, 2 training images, then the test split")
    ws = workspace("harvest")
    save_delta_checkpoint(os.path.join(ws, "checkpoint", "harvest.pth"), blocks=[
        delta_block_init(hostrng.PRNGKey(SEED + 20), spec.bottleneck_ch, spec.temb_ch)])
    res = serve_run(torch, card, log, rows_serve_argv(
        ws, imgs, model_path, "harvest", ("--train_delta_block", "--manual_checkpoint_name",
                                          "harvest.pth", "--num_mean_of_delta_hs", "1",
                                          "--do_train", "1", "--do_test", "1")),
        "mean-of-Δh harvest float32")
    latent = os.path.join(ws, "checkpoint_latent",
                          f"harvest_LC_CUSTOM_t999_ninv{STEPS}_ngen{STEPS}_{ROWS_TEST_STEPS}_1.pth")
    if not os.path.exists(latent):
        fail(f"the harvest wrote no {latent}")
    mean_rows = load_delta_checkpoint(latent)["delta_rows"]
    finite = all(np.isfinite(v).all() for v in mean_rows.values())
    grids = grid_files(ws, "harvest")
    phase(f"  harvest: {len(mean_rows)} rows saved (t = {sorted(mean_rows)}), finite {finite}, "
          f"largest |row| {max(float(np.abs(v).max()) for v in mean_rows.values()):.3e}; "
          f"{len(grids)} grids (the second training image and the test image from the rows)")
    if not finite or 0 not in mean_rows or len(grids) != 3:
        fail(f"the harvest: rows {sorted(mean_rows)}, finite {finite}, grids {sorted(grids)}")
    out["harvest"] = {**res, "rows": len(mean_rows)}
    out["seconds"] = time.perf_counter() - t_phase
    phase(f"  phase 10 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: the LPIPS calibration stage, ID-loss training, the fidelity runbook
# ---------------------------------------------------------------------------

# the calibration recipe runs 1000 steps; cut for the script's time limit (to 200
# when phase 12 came, to 100 when phase 14 came, to 50 when phase 15 came, to 25
# when phase 15 (e)-(f) came: the f32, bf16 and plain runs share it)
LPIPS_STEPS = 25
# --bs_train 2: cuDNN's f32 FFT convolutions (ROADMAP Queue 3); 10 until phase 14
LPIPS_BS2_STEPS = 5
LPIPS_TOL = 1e-3  # the f32 curves, kernels vs plain, of each curve's scale
FIDELITY_GATE = 0.01  # mean LPIPS, the runbook's gate
LPIPS_KINDS = ("x", "x_std", "x0_t", "x0_t_std")


def write_lpips_npz(path: str) -> str:
    """A random AlexNet + lin (lin = |N(0, 1)| * 0.1, as the JAX init) of
    --seed, in the `--lpips_ckpt` npz format through the port's
    `params_from_torch`."""
    import numpy as np

    from asyrp_official_torch.losses.lpips import ALEX_CONVS, params_from_torch

    rng = np.random.RandomState(SEED)
    alex, lin, cin = {}, {}, 3
    for i, (j, (cout, k, _, _)) in enumerate(zip((0, 3, 6, 8, 10), ALEX_CONVS)):
        alex[f"features.{j}.weight"] = (rng.randn(cout, cin, k, k)
                                        * (cin * k * k) ** -0.5).astype(np.float32)
        alex[f"features.{j}.bias"] = np.zeros(cout, np.float32)
        lin[f"lin{i}.model.1.weight"] = (np.abs(rng.randn(1, cout, 1, 1)) * 0.1).astype(np.float32)
        cin = cout
    np.savez(path, params=np.array(params_from_torch(alex, lin), dtype=object))
    return path


def lpips_argv(ws: str, imgs: str, model_path: str, npz: str, steps: int, bf16: bool = False,
               bs: int = 1, extra=()):
    """`--lpips` on `custom.yml` at full width: --n_train_img 1 (the
    reference's n + 1: 2 images), the seeded random UNet."""
    return ["--config", CONFIG, "--exp", os.path.join(ws, "runs", "calib"), "--lpips",
            "--lpips_ckpt", npz, "--model_path", model_path, "--device", DEVICE,
            "--custom_train_dataset_dir", imgs, "--custom_test_dataset_dir", imgs,
            "--work_dir", ws, "--n_inv_step", str(steps), "--n_train_img", "1",
            "--bs_train", str(bs), "--seed", str(SEED), "--ni", *(["--bf16"] if bf16 else []),
            *extra]


def lpips_run(torch, card, log, argv, ws: str, steps: int, what: str, bs: int = 1,
              plain: bool = False):
    """One `--lpips` stage through the port's CLI, in-process, the counters
    zeroed just before and read just after: K1, K2 and K3 launched (K3 once
    per inversion step and batch), or none with `plain`; the four tsvs with
    the seq[1:] keys, finite and >= 0. Returns (results, curves)."""
    import numpy as np

    from asyrp_official_torch.cli.main import main as cli_main
    from asyrp_official_torch.core.schedule import uniform_seq
    from asyrp_official_torch.utils.assets import load_lpips_tsv

    n_batches = -(-2 // bs)
    zero_counters()
    n_logs = len(log.lpips)
    t0 = time.perf_counter()
    with plain_versions() if plain else contextlib.nullcontext():
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    counts = counters()
    if rc != 0:
        fail(f"{what} exited {rc}")
    if plain:
        if any(counts.values()):
            fail(f"{what} launched a kernel: {counts}")
    else:
        require_launches(counts, ("group_norm", "attention", "ddim_step"), what)
        if counts["ddim_step"] != (steps - 1) * n_batches:
            fail(f"{what}: K3 launched {counts['ddim_step']} times, not the inversion table's "
                 f"{steps - 1} steps x {n_batches} batches")
    curves = {}
    keys = uniform_seq(steps, 999)[1:]
    for kind in LPIPS_KINDS:
        tsv = os.path.join(ws, "utils", f"celeba_LPIPS_distance_{kind}.tsv")
        if not os.path.exists(tsv):
            fail(f"{what} wrote no {tsv}")
        curves[kind] = load_lpips_tsv(tsv)
        vals = np.asarray(list(curves[kind].values()))
        if list(curves[kind]) != keys or not np.isfinite(vals).all() or vals.min() < 0:
            fail(f"{what}: {kind} tsv has keys {list(curves[kind])[:3]}... or values "
                 f"outside [0, inf)")
    batches = log.lpips[n_logs:]
    if len(batches) != n_batches:
        fail(f"{what}: {len(batches)} batch records, not {n_batches}")
    # the last batch's time per step: the first batch carries the warm-up
    n_img, batch_ms, _, ms_step = batches[-1]
    res = {"rc": rc, "steps": steps, "bs": bs, "run_s": wall, "launches": counts,
           "batch_ms": [b[1] for b in batches], "ms_per_step": ms_step,
           "ms_per_step_per_image": ms_step / n_img,
           "x0_t_at_999": curves["x0_t"][999], "x_at_999": curves["x"][999]}
    phase(f"  {what} on {card}: rc 0, {len(batches)} batch(es) of {n_img}: "
          f"{', '.join(f'{b[1]:.0f}' for b in batches)} ms; last batch {ms_step:.2f} ms per "
          f"inversion step ({ms_step / n_img:.2f} per image); launches {counts}; LPIPS(x0_t, x0) at "
          f"t=999 {curves['x0_t'][999]:.4f}, LPIPS(x_t, x0) {curves['x'][999]:.4f}; whole CLI run "
          f"{wall:.1f} s")
    return res, curves


def id_gradient_check(torch, argv, tree):
    """One edited timestep (t = 999) with the block `tree`, through the
    training loss of the runner with the ID term: id_loss_w x
    id_loss(x0_t, x0_t_origin) + the CLIP term + a fixed random linear
    functional of x0_t in place of the L1 term (as `gradient_check`: at the
    first step x0_t - x0_t_origin is within float noise on many elements,
    and the L1 term's sign flips there; with it, kernels vs plain read
    1.03e-2 on the H100). Its gradient w.r.t. the DeltaBlock, kernels vs
    plain versions, f32 and bf16; the ID term's value, and its gradient
    w.r.t. the image it differentiates (x0_t_origin: x0_t's features are
    detached, so no gradient reaches the block through it, as in the JAX
    package and the reference); the IR-SE50 device time per timestep (its
    two forwards) and one profiled timestep with the L1 term."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from asyrp_official_torch.cli.main import build_contexts, build_parser, load_config
    from asyrp_official_torch.core.schedule import train_seq
    from asyrp_official_torch.losses.clip_loss import train_clip_term
    from asyrp_official_torch.models.delta import EditState, delta_block_from_tree
    from asyrp_official_torch.ops import ddim_step as k3
    from asyrp_official_torch.pipelines import train as tr
    from asyrp_official_torch.runner import AsyrpRunner

    args = build_parser().parse_args(argv)
    dev = torch.device(DEVICE)
    ctx, id_net, _ = build_contexts(args, dev)
    runner = AsyrpRunner(args, load_config(CONFIG), clip_ctx=ctx, id_net=id_net,
                         work_dir=args.work_dir)
    runner.set_interval()
    spec = runner.spec
    model = runner.load_pretrained()
    pairs = runner.get_pairs(model, "train")  # the run's cache
    x = torch.from_numpy(pairs["x_lat"][:1]).to(dev)
    x0 = torch.from_numpy(pairs["x0"][:1]).to(dev)
    seq, seq_next = train_seq(STEPS, 999, T_EDIT)
    acp = torch.from_numpy(runner.schedule.alphas_cumprod_ext).to(dev)
    t, t_next = seq[-1], seq_next[-1]
    t_b = torch.full((1,), float(t), device=dev)
    at, at_next = acp[t + 1].reshape(1), acp[t_next + 1].reshape(1)
    clip = train_clip_term(ctx, runner.src_txts[0], runner.trg_txts[0], 1.0)
    cotangent = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    block = delta_block_from_tree(tree, spec.bottleneck_ch, spec.temb_ch,
                                  flavor=spec.delta_flavor).to(dev).train()
    edit = EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0], device=dev),
                     flavor=spec.delta_flavor).at_step({"use_delta": 1.0})

    def id_term(x0_t, x0_t_origin):
        return args.id_loss_w * id_net.id_loss(x0_t.permute(0, 3, 1, 2),
                                               x0_t_origin.permute(0, 3, 1, 2)).mean()

    def forward(dtype):
        with torch.no_grad():
            eps = spec.apply(model, x.to(dtype), t_b)[0]
            _, x0_origin = k3.ddim_step(x, eps, eps, at, at_next, 0.0)
        eps, eps_mod, _, _ = spec.apply(model, x.to(dtype), t_b, edit=edit, decode_mode="split")
        _, x0_t = k3.ddim_step(x, eps, eps_mod, at, at_next, 0.0)
        return x0_t, x0_origin

    def grads(dtype, l1: bool = False):
        block.zero_grad(set_to_none=True)
        x0_t, x0_origin = forward(dtype)
        loss = id_term(x0_t, x0_origin) + clip(x0, x0_t)
        if l1:
            loss = loss + tr.default_loss(x0_t, x0_origin, x0, l1_w=3.0)
        else:
            loss = loss + (x0_t * cotangent).mean()
        loss.backward()
        return {k: p.grad.detach().float().cpu().numpy() for k, p in block.named_parameters()}

    def rel(a, b):
        return {k: float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)) for k in b}

    out = {"launches": {}}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        zero_counters()
        kernels = grads(torch.float32)
        out["launches"]["float32"] = counters()
        with plain_versions():
            plain = grads(torch.float32)
        out["float32"] = rel(kernels, plain)
        zero_counters()
        kernels_bf = grads(torch.bfloat16)
        out["launches"]["bfloat16"] = counters()
        with plain_versions():
            plain_bf = grads(torch.bfloat16)
        out["bfloat16"] = {"kernels": rel(kernels_bf, plain), "plain": rel(plain_bf, plain),
                           "kernels_vs_plain": rel(kernels_bf, plain_bf)}
    finally:
        torch.backends.cudnn.deterministic = deterministic

    with torch.no_grad():
        x0_t, x0_origin = forward(torch.float32)
    x_hat = x0_origin.clone().requires_grad_(True)
    value = id_term(x0_t, x_hat)
    (g_hat,) = torch.autograd.grad(value, x_hat)
    out["id_term"] = float(value.detach())
    out["id_term_grad_norm_x0_t_origin"] = float(g_hat.norm())
    out["id_term_reaches_block"] = id_term(*forward(torch.float32)).requires_grad
    # IR-SE50's share of a timestep: the ID term's two forwards at bs 1
    out["irse50_device_ms"] = profiled_device_ms(lambda: id_term(x0_t, x0_origin))
    for _ in range(2):
        grads(torch.float32, l1=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grads(torch.float32, l1=True)
        wall = (time.perf_counter() - t0) * 1e3
    out["profile"] = device_time(prof, wall, "ID-loss training timestep float32")
    return out


def fidelity_argv(ws: str, imgs: str, model_path: str, extra=()):
    return ["--config", CONFIG, "--exp", os.path.join(ws, "runs", "fid"), "--run_fidelity",
            "--train_delta_block", "--model_path", model_path, "--device", DEVICE,
            "--custom_train_dataset_dir", imgs, "--custom_test_dataset_dir", imgs,
            "--work_dir", ws, "--manual_checkpoint_name", "smoke_delta.pth",
            "--n_inv_step", str(STEPS), "--n_test_step", str(STEPS), "--n_train_step", str(STEPS),
            "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
            "--bs_train", "1", "--n_test_img", "2", "--seed", str(SEED), "--ni", *extra]


def m7_phase(torch, card, log, ws_root, clip_ckpt: str):
    """Phase 11 on full-width `custom.yml` at bs 1 through the port's CLI,
    in-process, from phase 4/7's images and phase 10's seeded random UNet:
    (a) `--lpips` at LPIPS_STEPS steps f32, bf16, and f32 with the
    kernels and with the plain versions (curves within LPIPS_TOL), f32 at
    --bs_train 2 over 10 steps (recorded, not gated), then `set_interval`
    on the fresh tsvs; (b) phase 7's training with `--id_loss_w 1
    --ir_se50_ckpt` (a random IR-SE50 written under the reference's key
    names), f32 and bf16, the f32 run again with the plain versions, and
    one timestep's gradient; (c) `--run_fidelity` with phase 4's seeded
    block: the plain versions' outputs as the reference of the kernels'."""
    import numpy as np

    from asyrp_official_torch.cli.main import build_parser, load_config, main as cli_main
    from asyrp_official_torch.compat.from_jax import lpips_state_dict_from_jax
    from asyrp_official_torch.losses.id_loss import IRSE50
    from asyrp_official_torch.losses.lpips import LPIPS
    from asyrp_official_torch.models.delta import delta_block_init
    from asyrp_official_torch.models.registry import spec_from_config
    from asyrp_official_torch.pipelines.fidelity import compare_output_dirs
    from asyrp_official_torch.pipelines.interval import select_interval
    from asyrp_official_torch.runner import AsyrpRunner
    from asyrp_official_torch.utils import hostrng
    from asyrp_official_torch.utils.assets import lpips_curve

    t_phase = time.perf_counter()
    root = os.path.join(ws_root, "m7")
    os.makedirs(root)
    imgs = os.path.join(ws_root, "train", "imgs")  # phase 7's two images
    model_path = os.path.join(ws_root, "rows", "unet_random.pt")  # phase 10's seeded UNet
    npz = write_lpips_npz(os.path.join(root, "lpips_random.npz"))
    out = {"launches": {}}

    # (a) the LPIPS calibration stage
    phase(f"  (a) --lpips: 2 images (--n_train_img 1), bs 1; random AlexNet + lin of --seed")
    lp, curves = {}, {}
    for label, steps, bf16, bs, plain in (
            ("float32", LPIPS_STEPS, False, 1, False),
            ("bfloat16", LPIPS_STEPS, True, 1, False),
            ("float32 plain", LPIPS_STEPS, False, 1, True),
            ("float32 bs 2", LPIPS_BS2_STEPS, False, 2, False)):
        ws = os.path.join(root, "lpips_" + label.replace(" ", "_"))
        lp[label], curves[label] = lpips_run(
            torch, card, log, lpips_argv(ws, imgs, model_path, npz, steps, bf16, bs), ws, steps,
            f"--lpips {label} ({steps} steps{', plain versions' if plain else ''})", bs, plain)
        if not plain:
            out["launches"][f"lpips {label}"] = lp[label]["launches"]
    errs_by_kind = {}
    for kind in LPIPS_KINDS:
        k = np.asarray(list(curves["float32"][kind].values()))
        p = np.asarray(list(curves["float32 plain"][kind].values()))
        errs_by_kind[kind] = float(np.abs(k - p).max() / max(np.abs(p).max(), 1e-30))
    phase(f"  f32 {LPIPS_STEPS}-step curves, kernels vs plain versions, max |a - b| / max |b|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs_by_kind.items()) + f" (tol {LPIPS_TOL:g})")
    if max(errs_by_kind.values()) > LPIPS_TOL:
        fail(f"the LPIPS curves with the kernels disagree with the plain versions: {errs_by_kind}")
    bs1, bs2 = lp["float32"]["ms_per_step_per_image"], lp["float32 bs 2"]["ms_per_step_per_image"]
    phase(f"  f32 ms per inversion step per image: bs 1 {bs1:.2f} ({LPIPS_STEPS} steps); bs 2 "
          f"{bs2:.2f} "
          f"({lp['float32 bs 2']['ms_per_step']:.2f} per step of 2 images, {LPIPS_BS2_STEPS} "
          f"steps): {bs2 / bs1:.1f}x bs 1's (cuDNN's f32 FFT convolutions, ROADMAP Queue 3; "
          "recorded, not gated)")
    # interval selection reads the fresh tsv (thresholds at a fraction of its
    # range: random weights give no calibrated scale)
    ws = os.path.join(root, "lpips_float32")
    x0_t_curve = curves["float32"]["x0_t"]
    edit_th, addnoise_th = 0.5 * max(x0_t_curve.values()), 0.25 * max(x0_t_curve.values())
    args = build_parser().parse_args(
        ["--config", CONFIG, "--exp", os.path.join(ws, "runs", "interval"), "--work_dir", ws,
         "--device", DEVICE, "--lpips_edit_th", repr(edit_th), "--lpips_addnoise_th",
         repr(addnoise_th), "--ni"])
    r = AsyrpRunner(args, load_config(CONFIG), work_dir=ws)
    r.set_interval()
    want = select_interval("celeba", 1.0, lpips_edit_th=edit_th, lpips_addnoise_th=addnoise_th,
                           curve_x0_t=x0_t_curve)
    bundled = select_interval("celeba", 1.0, lpips_edit_th=edit_th,
                              lpips_addnoise_th=addnoise_th, curve_x0_t=lpips_curve("celeba"))
    phase(f"  set_interval on the fresh {LPIPS_STEPS}-step x0_t tsv (thresholds {edit_th:.4f} / "
          f"{addnoise_th:.4f}: 1/2 and 1/4 of its largest value): t_edit {r.t_edit}, t_addnoise "
          f"{r.t_addnoise} (the bundled celeba table would give {bundled[0]} / {bundled[1]})")
    if (r.t_edit, r.t_addnoise) != want:
        fail(f"set_interval picked {(r.t_edit, r.t_addnoise)}, not the fresh tsv's {want}")
    out["lpips"] = {"runs": lp, "f32_kernels_vs_plain": errs_by_kind,
                    "bs2_over_bs1_per_image": bs2 / bs1,
                    "interval": {"t_edit": r.t_edit, "t_addnoise": r.t_addnoise,
                                 "edit_th": edit_th, "addnoise_th": addnoise_th}}

    # (b) Δ-training with the ID term
    phase("  (b) phase 7's training recipe + --id_loss_w 1 --ir_se50_ckpt (a random IR-SE50 "
          "of --seed under the reference's key names)")
    torch.manual_seed(SEED)
    ir_pth = os.path.join(root, "ir_se50_random.pth")
    torch.save(IRSE50().state_dict(), ir_pth)
    spec = spec_from_config(load_config(CONFIG))
    init = delta_block_init(hostrng.PRNGKey(SEED), spec.bottleneck_ch, spec.temb_ch)

    def id_argv(ws, exp, bf16=False, extra=()):
        argv = train_argv(ws, imgs, clip_ckpt, exp, bf16, [
            "--id_loss_w", "1", "--ir_se50_ckpt", ir_pth, "--model_path", model_path, *extra])
        argv.remove("--allow_random_weights")
        return argv

    idres, blocks = {}, {}
    for dname in DTYPES:
        ws, exp = os.path.join(root, f"id_{dname}"), f"id_{dname}"
        shutil.copytree(os.path.join(ws_root, "train", dname, "precomputed"),
                        os.path.join(ws, "precomputed"))
        idres[dname], blocks[dname] = cli_train_run(
            torch, card, log, id_argv(ws, exp, dname == "bfloat16"), ws, exp,
            f"ID-loss training {dname}", TRAIN_KERNELS, init)
        out["launches"][f"id-loss training {dname}"] = idres[dname]["launches"]
    ws_f32 = os.path.join(root, "id_float32")
    ws = os.path.join(root, "id_plain")
    shutil.copytree(os.path.join(ws_f32, "precomputed"), os.path.join(ws, "precomputed"))
    before = counters()
    t0 = time.perf_counter()
    with plain_versions():
        rc = cli_main(id_argv(ws, "id_plain", extra=["--do_test", "0",
                                                           "--save_train_image", "0"]))
    plain_s = time.perf_counter() - t0
    if rc != 0 or counters() != before:
        fail(f"ID-loss training (plain versions): rc {rc}, or it launched a kernel")
    plain_blk = trained_block(ws, "id_plain")
    whole = tree_err(blocks["float32"], plain_blk)
    update = tree_err(tree_minus(blocks["float32"], init), tree_minus(plain_blk, init))
    phase(f"  f32 ID-loss training, kernels vs plain versions, max |a - b| / max |b| over the "
          f"block: trained block {whole:.3e} (tol {TRAIN_TOL:g}), its update {update:.3e} (tol "
          f"{UPDATE_TOL:g}); plain run {plain_s:.1f} s")
    if whole > TRAIN_TOL or update > UPDATE_TOL:
        fail(f"the ID-loss block trained with the kernels disagrees with the plain run: block "
             f"{whole:.3e}, update {update:.3e}")
    check = id_gradient_check(torch, id_argv(ws_f32, "id_float32"), blocks["float32"])
    f32, bf = check["float32"], check["bfloat16"]
    phase(f"  one edited timestep (t=999, the f32-trained block) through ID + CLIP + a fixed "
          f"linear functional of x0_t (for L1), gradient w.r.t. the DeltaBlock per leaf, f32 "
          f"kernels vs plain: {fmt(f32)}; worst "
          f"{max(f32.values()):.3e} (tol {GRAD_TOL:g}); bf16 against the f32 plain versions: "
          f"kernels {max(bf['kernels'].values()):.3e}, plain {max(bf['plain'].values()):.3e} "
          f"(tol {BF16_GRAD_FACTOR:g}x); launches {check['launches']}")
    phase(f"  the ID term: {check['id_term']:.6e}; its gradient w.r.t. x0_t_origin (the side it "
          f"differentiates) has norm {check['id_term_grad_norm_x0_t_origin']:.3e}; it reaches "
          f"the block: {check['id_term_reaches_block']} (x0_t's features are detached, as in "
          f"the JAX package); IR-SE50 device time per timestep (2 forwards, bs 1) "
          f"{check['irse50_device_ms']}; "
          f"ms per edited timestep f32 {idres['float32']['ms_per_edit_timestep']:.1f} / bf16 "
          f"{idres['bfloat16']['ms_per_edit_timestep']:.1f}")
    phase(f"  one ID-loss training timestep (f32, kernels) on {card}: "
          + fmt_device_time(check["profile"]))
    if max(f32.values()) > GRAD_TOL:
        fail(f"the f32 gradient through the ID-loss path disagrees with the plain one: {f32}")
    if max(bf["kernels"].values()) > BF16_GRAD_FACTOR * max(bf["plain"].values()):
        fail("the bf16 gradient through the ID-loss path with the kernels is farther from the "
             f"f32 one than {BF16_GRAD_FACTOR:g}x the plain versions' bf16 gradient")
    if not (check["id_term"] > 0 and check["id_term_grad_norm_x0_t_origin"] > 0):
        fail(f"the ID term or its gradient is 0: {check['id_term']}, "
             f"{check['id_term_grad_norm_x0_t_origin']}")
    if check["id_term_reaches_block"]:
        fail("the ID term has a gradient path to the block; the reference detaches x0_t's side")
    out["id_training"] = {"runs": idres, "float32_vs_plain": {"whole_block_rel_err": whole,
                                                              "update_rel_err": update},
                          "gradient_check": check}

    # (c) the fidelity runbook
    phase("  (c) --run_fidelity with phase 4's seeded block, 2 test images, 40 + 40 steps, bs 1")
    test_imgs = os.path.join(ws_root, "float32", "imgs")  # phase 4's images
    fid = {}
    for label, plain in (("plain", True), ("kernels", False)):
        ws = os.path.join(root, f"fid_{label}")
        os.makedirs(os.path.join(ws, "checkpoint"))
        shutil.copy(os.path.join(ws_root, "float32", "checkpoint", "smoke_delta.pth"),
                    os.path.join(ws, "checkpoint"))
        extra = [] if plain else ["--fidelity_ref_dir", fid["plain"]["out_dir"],
                                  "--lpips_ckpt", npz]
        zero_counters()
        t0 = time.perf_counter()
        with plain_versions() if plain else contextlib.nullcontext():
            rc = cli_main(fidelity_argv(ws, test_imgs, model_path, extra))
        wall = time.perf_counter() - t0
        counts = counters()
        if rc != 0:
            fail(f"--run_fidelity ({label}) exited {rc}")
        if plain and any(counts.values()):
            fail(f"--run_fidelity (plain) launched a kernel: {counts}")
        if not plain:
            require_launches(counts, ("group_norm", "attention", "ddim_step"), "--run_fidelity")
            out["launches"]["fidelity float32"] = counts
        out_dir = os.path.join(ws, "runs", f"fid_LC_CUSTOM_t999_ninv{STEPS}_ngen{STEPS}",
                               "fidelity")
        names = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        if names != ["test_0.png", "test_1.png"]:
            fail(f"--run_fidelity ({label}) wrote {names}")
        fid[label] = {"out_dir": out_dir, "run_s": wall, "launches": counts}
        phase(f"  --run_fidelity {label} on {card}: rc 0, {names}; launches {counts}; whole CLI "
              f"run {wall:.1f} s")
    report = json.load(open(os.path.join(fid["kernels"]["out_dir"], "lpips_report.json")))
    net = LPIPS()
    net.load_state_dict(lpips_state_dict_from_jax(np.load(npz, allow_pickle=True)["params"].item()))
    net = net.to(DEVICE).eval()
    self_report = compare_output_dirs(fid["kernels"]["out_dir"], fid["kernels"]["out_dir"], net)
    phase(f"  fidelity report, kernels' outputs vs the plain versions': mean {report['mean']:.3e}, "
          f"max {report['max']:.3e}, n {report['n']} (gate: mean <= {FIDELITY_GATE:g}); "
          f"self-comparison mean {self_report['mean']:g}, max {self_report['max']:g}")
    if report["n"] != 2 or not report["mean"] <= FIDELITY_GATE:
        fail(f"the fidelity report misses its gate: {report}")
    if self_report["mean"] != 0.0 or self_report["max"] != 0.0:
        fail(f"the fidelity self-comparison is not exactly 0: {self_report}")
    out["fidelity"] = {"runs": {k: {kk: vv for kk, vv in v.items() if kk != "out_dir"}
                                for k, v in fid.items()},
                       "report": {k: report[k] for k in ("mean", "max", "n")},
                       "self_report": {k: self_report[k] for k in ("mean", "max", "n")}}
    out["seconds"] = time.perf_counter() - t_phase
    phase(f"  phase 11 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: IMAGENET (imagenet.yml, ADM 256^2) and the ADM 256^2 classifier
# ---------------------------------------------------------------------------

IMAGENET_CLASS = 207  # n02099601 golden_retriever: a dog, for the dog_* prompts
IMAGENET_PARAMS = 553_838_086  # ADM 256^2 with its class embedding (1000 x 1024)
# guided-diffusion's published 256^2 classifier flags (classifier_width 128,
# depth 2, attention at 32,16,8, pool attention, scale-shift, resblock up/down)
CLASSIFIER = dict(image_size=256, in_channels=3, model_channels=128, out_channels=1000,
                  num_res_blocks=2, attention_ds=(8, 16, 32), channel_mult=(1, 1, 2, 2, 4, 4),
                  num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
                  pool="attention")


def make_imagenet_workspace(torch, root: str, data: str):
    """The full-width IMAGENET UNet from the seeded init with its all-zero
    output layers redrawn (`perturbed`), saved as a `.pt` WITHOUT
    `label_emb.weight` (the layout of ADM's released unconditional
    checkpoint, which `imagenet.yml` reads under class_cond); random 256^2
    images (two val, four train) as `{data}/imagenet/{val,train}/<wnid>/<wnid>/`
    `*.JPEG` / `*.jpeg` of IMAGENET_CLASS; an OpenAI-flavor Δ checkpoint at
    1024 channels. Returns (the `.pt` path, seconds of the host init)."""
    from asyrp_official_torch.cli.main import load_config
    from asyrp_official_torch.compat import save_delta_checkpoint
    from asyrp_official_torch.data.datasets import imagenet_classes
    from asyrp_official_torch.models.delta import delta_block_init
    from asyrp_official_torch.models.registry import spec_from_config
    from asyrp_official_torch.utils import hostrng

    os.makedirs(root)
    spec = spec_from_config(load_config(IMAGENET_CONFIG))
    t0 = time.perf_counter()
    sd = spec.state_dict_from_jax(perturbed(spec.init(hostrng.PRNGKey(SEED)), SEED))
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in sd.values())
    if n_params != IMAGENET_PARAMS:
        fail(f"the imagenet.yml UNet has {n_params} parameters, not {IMAGENET_PARAMS:,}")
    del sd["label_emb.weight"]
    model_path = os.path.join(root, "imagenet_uncond_perturbed.pt")
    torch.save(sd, model_path)
    del sd
    wnid = imagenet_classes()[str(IMAGENET_CLASS)][0]
    for mode, ext in (("val", "JPEG"), ("train", "jpeg")):
        # four training images: the --remat reading's batch of 4
        write_images(os.path.join(data, "imagenet", mode, wnid), sub=wnid, ext=ext,
                     n=max(REMAT_BATCHES) if mode == "train" else 2)
    block = delta_block_init(hostrng.PRNGKey(7), spec.bottleneck_ch, spec.temb_ch, flavor="openai")
    save_delta_checkpoint(os.path.join(root, "imagenet_delta.pth"), blocks=[block], flavor="openai")
    phase(f"  (a) {n_params:,} parameters from the seeded init (host: {init_s:.1f} s), saved "
          f"without label_emb.weight ({os.path.getsize(model_path) / 2**30:.2f} GiB); class "
          f"{IMAGENET_CLASS} ({wnid}): 2 val .JPEG and {max(REMAT_BATCHES)} train .jpeg images; a "
          f"Δ checkpoint of "
          f"{spec.bottleneck_ch} channels")
    return model_path, init_s


def classifier_phase(torch, dev, card):
    """Phase 12 (e): the ADM 256^2 classifier (EncoderUNet, CLASSIFIER) from
    its seeded init with the all-zero layers redrawn: one forward at batch
    1 and 8 with the kernels against the plain versions (CHAIN_TOL of
    scale); K1 and the multi-head K2 launched, K2 once per attention call,
    the attention pool's among them (T = 65, 8 heads of 64), the one-head
    K2 never."""
    from unittest import mock

    from asyrp_official_torch.compat.from_jax import encoder_state_dict_from_jax
    from asyrp_official_torch.models.encoder_unet import (EncoderUNet, EncoderUNetConfig,
                                                          encoder_init)
    from asyrp_official_torch.ops import attention as k2
    from asyrp_official_torch.utils import hostrng

    cfg = EncoderUNetConfig(**CLASSIFIER)
    model = EncoderUNet(cfg)
    model.load_state_dict(encoder_state_dict_from_jax(
        perturbed(encoder_init(hostrng.PRNGKey(SEED), cfg), SEED), cfg))
    model = model.to(dev).eval().requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"params": n_params}
    real = k2._attention_cuda
    for batch in (1, 8):
        x = torch.randn(batch, IMAGE, IMAGE, 3, generator=gen, device=dev)
        t = torch.full((batch,), 500.0, device=dev)
        calls = []

        def launch(q, k, v, with_lse, num_heads=1, legacy_scale=False):
            calls.append((tuple(q.shape), num_heads))  # each K2 launch's shape
            return real(q, k, v, with_lse, num_heads, legacy_scale)

        zero_counters()
        with torch.no_grad(), mock.patch.object(k2, "_attention_cuda", launch):
            got = model.apply(x, t)
        counts = counters()
        with torch.no_grad(), plain_versions():
            want = model.apply(x, t)
        if counters() != counts:
            fail("the plain classifier forward launched a kernel")
        if got.shape != (batch, cfg.out_channels) or not torch.isfinite(got).all():
            fail(f"classifier logits {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        err = errs(got, want)[1]
        side = cfg.image_size // 2 ** (len(cfg.channel_mult) - 1)  # the pool's map: 8^2
        pool = ((batch, side * side + 1, cfg.bottleneck_ch),
                cfg.bottleneck_ch // cfg.num_head_channels)
        if (counts["attention_mh"] != len(calls) or pool not in calls or counts["attention"]
                or not counts["group_norm"]):
            fail(f"classifier batch {batch}: launches {counts}, attention calls {calls}")
        with torch.no_grad():
            ms = time_ms(lambda: model.apply(x, t), runs=10)
        std = float(want.std())
        out[batch] = {"rel_err": err, "logit_std": std, "launches": counts, "ms": ms}
        phase(f"  (e) classifier forward, batch {batch}, kernels vs plain: rel err {err:.3e} (tol "
              f"{CHAIN_TOL:g}), logit std {std:.3f}; launches {counts} (the attention pool "
              f"{list(pool[0])} with {pool[1]} heads among {len(calls)} K2-MH calls); "
              f"{ms:.2f} ms per forward on {card}")
        if err > CHAIN_TOL or not std > 0.0:
            fail(f"the classifier's logits with the kernels disagree with the plain ones: "
                 f"{err:.3e} (logit std {std:.3e})")
    phase(f"  (e) the classifier has {n_params:,} parameters")
    return out


def imagenet_phase(torch, dev, card, log, ws_root: str, clip_ckpt: str):
    """Phase 12: IMAGENET through the port's CLI, in-process — (a) the
    weights and inputs, (b) serving f32 and bf16, (c) the f32 invert+edit
    chain against the plain versions and one eval's profile, (d) Δ-training
    f32 and bf16 with a plain run and the gradient gate, (e) the ADM
    classifier."""
    t_phase = time.perf_counter()
    root = os.path.join(ws_root, "imagenet")
    model_path, init_s = make_imagenet_workspace(torch, root, os.environ["ASYRP_TPU_DATA"])
    _, _, cache_category, _ = openai_family("imagenet")
    phase(f"  (b) --run_test --target_class_num {IMAGENET_CLASS}, {IMAGENET_SERVE_STEPS} + "
          f"{IMAGENET_SERVE_STEPS} steps, bs 1")
    serving, launches = openai_phase(torch, card, log, "imagenet", root, model_path,
                                     IMAGENET_RUNS)
    phase("  (c) the float32 IMAGENET serving chain, kernels vs plain versions:")
    ws = os.path.join(root, "float32")
    chain_err, chain_ms, per_request, served = chain_phase(
        torch, dev, card, ws, openai_argv("imagenet", ws, model_path), IMAGENET_CONFIG,
        "imagenet_delta.pth",
        f"{cache_category}_test_t999_nim2_ninv{IMAGENET_SERVE_STEPS}_pairs.npz",
        eps_check=True, steps=IMAGENET_CHAIN_STEPS)
    phase("  where the time goes in one IMAGENET UNet eval at batch 1 (torch.profiler):")
    profile = profile_phase(torch, dev, card, served)
    del served
    torch.cuda.empty_cache()
    phase(f"  (d) --run_train --train_delta_block --target_class_num {IMAGENET_CLASS} "
          f"--edit_attr {AFHQ_ATTR}, 1 image, 2 iterations, {OPENAI_TRAIN_STEPS}-step grids")
    training, train_launches = openai_train_phase(torch, card, log, "imagenet", root, model_path,
                                                  clip_ckpt, plain_run=True)
    torch.cuda.empty_cache()
    training["remat"] = remat_reading(
        torch, card, log, "IMAGENET training path", root,
        lambda ws, exp, bf16, extra: openai_train_argv("imagenet", ws, model_path, clip_ckpt, exp,
                                                       bf16=bf16, extra=extra),
        os.path.join(root, "train_float32"), category=openai_family("imagenet")[1])
    torch.cuda.empty_cache()
    classifier = classifier_phase(torch, dev, card)
    seconds = time.perf_counter() - t_phase
    phase(f"  phase 12 took {seconds:.1f} s")
    return {"init_s": init_s, "serving": serving, "launches": launches,
            "train_launches": train_launches, "invert_edit_chain_ms": chain_ms,
            "chain_rel_err": chain_err, "launches_per_invert_edit_chain": per_request,
            "profile": profile, "training": training, "classifier": classifier,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 13: DiffStyle (--diff_style), the image-noise engine, the global and
# interp_batch edit modes, the RN50 tower and the CLIP terms
# ---------------------------------------------------------------------------

STYLE_SAVE = "styled"
STYLE_CONTENTS = 1  # content images of a sweep (2 until phase 14 came: cut for the time limit)
CONTENT_REPLACE = 50  # --content_replace_step's default: with t_edit, it gates the injection
# the four CLIP terms on the card against the same code on the CPU
CLIP_TERM_TOL = 1e-4


def style_argv(ws: str, weights, save: str = STYLE_SAVE, bf16: bool = False, extra=()):
    """`--diff_style` on `custom.yml`: the two content images of `ws/contents`
    each stylized by the style image of `ws/styles`, STYLE_STEPS + STYLE_STEPS steps, t_edit
    513, the flags' default hs_coeff 0.9 and content_replace_step 50.
    `weights`: a `.pt` path, or None for --allow_random_weights (the same
    weights: the seeded init of --seed)."""
    argv = ["--config", CONFIG, "--exp", os.path.join(ws, "runs", "style"), "--diff_style",
            "--device", DEVICE, "--work_dir", ws, "--content_dir", os.path.join(ws, "contents"),
            "--style_dir", os.path.join(ws, "styles"), "--save_dir", os.path.join(ws, save),
            "--n_inv_step", str(STYLE_STEPS), "--n_gen_step", str(STYLE_STEPS),
            "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
            "--seed", str(SEED), "--ni", *extra]
    argv += ["--model_path", weights] if weights else ["--allow_random_weights"]
    return argv + (["--bf16"] if bf16 else [])


def style_run(torch, card, argv, what: str, expect_k3: int, plain: bool = False):
    """One `--diff_style` run through the port's CLI, in-process, counters
    zeroed just before and read just after: K1, K2 and K3 launched (K3
    exactly `expect_k3` times), the multi-head K2 never; with `plain`, the
    plain versions and no launch. Every output written, 256^2 and finite.
    Returns ({file name: float image}, result)."""
    import numpy as np
    from PIL import Image
    from unittest import mock

    from asyrp_official_torch import runner
    from asyrp_official_torch.cli.main import main as cli_main

    outs = {}
    save_image = runner.save_image

    def keep(img, path, **kw):
        outs[os.path.basename(path)] = np.asarray(img, np.float32)
        return save_image(img, path, **kw)

    zero_counters()
    t0 = time.perf_counter()
    with mock.patch.object(runner, "save_image", keep), \
            plain_versions() if plain else contextlib.nullcontext():
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    counts = counters()
    if rc != 0:
        fail(f"{what} exited {rc}")
    if plain:
        if any(counts.values()):
            fail(f"{what} launched a kernel: {counts}")
    else:
        require_launches(counts, ("group_norm", "attention", "ddim_step"), what)
        if counts["attention_mh"] or counts["ddim_step"] != expect_k3:
            fail(f"{what}: K3 launched {counts['ddim_step']} times (derived {expect_k3}), "
                 f"K2-MH {counts['attention_mh']} (must be 0)")
    save = argv[argv.index("--save_dir") + 1]
    names = sorted(os.listdir(save))
    if names != [f"content{i}_style0.png" for i in range(STYLE_CONTENTS)] or sorted(outs) != names:
        fail(f"{what}: wrote {names}, kept {sorted(outs)}")
    for n in names:
        png = np.asarray(Image.open(os.path.join(save, n)))
        if png.shape != (IMAGE, IMAGE, 3) or outs[n].shape != (IMAGE, IMAGE, 3) \
                or not np.isfinite(outs[n]).all():
            fail(f"{what}: {n} is {png.shape} / {outs[n].shape}, finite "
                 f"{np.isfinite(outs[n]).all()}")
    phase(f"  {what} on {card}: rc 0, {names}; launches {counts}; whole CLI run {wall:.1f} s")
    return outs, {"run_s": wall, "launches": counts}


def outputs_err(torch, outs, ref):
    """max |a - b| / max |b| over every output file."""
    return max(errs(torch.from_numpy(outs[n]), torch.from_numpy(ref[n]))[1] for n in ref)


def noise_gradient_check(torch, dev, card, spec, model, schedule, x_lat):
    """(d) `make_image_noise_generate` at full width, a 4-step chain (t_edit
    513 gates the first two): the output and the gradient of a fixed
    projection w.r.t. `noise_param`, kernels vs plain versions; K1-bwd,
    K2-bwd and K3-bwd must launch."""
    from asyrp_official_torch import uniform_seq
    from asyrp_official_torch.pipelines import engine

    gen = torch.Generator(device=dev).manual_seed(SEED)
    noise = 0.1 * torch.randn(IMAGE, IMAGE, 3, generator=gen, device=dev)
    w = torch.randn(1, IMAGE, IMAGE, 3, generator=gen, device=dev)
    run = engine.make_image_noise_generate(spec, schedule, uniform_seq(4, 999), t_edit=T_EDIT,
                                           coeff=1.0)

    def grad():
        n = noise.clone().requires_grad_(True)
        out, _ = run(model, n, x_lat)
        return out.detach(), torch.autograd.grad((out * w).sum(), n)[0]

    zero_counters()
    t0 = time.perf_counter()
    out_k, g_k = grad()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters()
    require_launches(counts, ("group_norm", "group_norm_bwd", "attention", "attention_bwd",
                              "ddim_step", "ddim_step_bwd"), "the image-noise gradient")
    with plain_versions():
        out_p, g_p = grad()
    err_x, err_g = errs(out_k, out_p)[1], errs(g_k, g_p)[1]
    finite = bool(torch.isfinite(g_k).all()) and float(g_k.abs().max()) > 0
    phase(f"  (d) make_image_noise_generate, 4 steps at 256^2, f32: output kernels vs plain "
          f"{err_x:.3e}, d/d noise_param {err_g:.3e} (tol {CHAIN_TOL:g}; gradient max "
          f"{float(g_p.abs().max()):.3e}); launches {counts}; forward + backward {wall:.2f} s "
          f"on {card}")
    if not finite or max(err_x, err_g) > CHAIN_TOL:
        fail(f"image-noise gradient: output {err_x:.3e}, gradient {err_g:.3e}, finite and "
             f"nonzero {finite}")
    return {"output_rel_err": err_x, "grad_rel_err": err_g, "launches": counts, "s": wall}


def edit_modes_check(torch, dev, card, spec, model):
    """(e) one `global`-mode dual eval (a seeded DeltaBlockGlobal, a random
    CLIP direction) and one `interp_batch` eval, batch 3, kernels vs plain
    versions; the edit must move eps_mod."""
    from asyrp_official_torch.models.delta import (EditState, delta_block_global_from_tree,
                                                   delta_block_global_init)
    from asyrp_official_torch.utils import hostrng

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    ch, hw = spec.bottleneck_ch, spec.bottleneck_hw
    block = delta_block_global_from_tree(
        delta_block_global_init(hostrng.PRNGKey(SEED), ch, spec.temb_ch, 512, hw)).to(dev)
    d = torch.randn(1, 512, generator=gen, device=dev)
    edits = {"global": EditState(mode="global", blocks=(block.eval(),),
                                 clip_direction=d / d.norm()),
             "interp_batch": EditState(mode="interp_batch",
                                       alpha=torch.tensor([0.0, 0.5, 1.0], device=dev))}
    x = torch.randn(3, IMAGE, IMAGE, 3, generator=gen, device=dev)
    t = torch.tensor([999.0, 700.0, 513.0], device=dev)
    out = {}
    for mode, edit in edits.items():
        zero_counters()
        with torch.no_grad():
            eps_k, mod_k, _, _ = spec.apply(model, x, t, edit=edit)
            counts = counters()
            with plain_versions():
                eps_p, mod_p, _, _ = spec.apply(model, x, t, edit=edit)
        require_launches(counts, ("group_norm", "attention"), f"the {mode} eval")
        err = max(errs(eps_k, eps_p)[1], errs(mod_k, mod_p)[1])
        moved = errs(mod_p, eps_p)[1]
        phase(f"  (e) {mode} dual eval, batch 3, f32: eps and eps_mod kernels vs plain {err:.3e} "
              f"(tol {CHAIN_TOL:g}); the edit moves eps_mod by {moved:.3e} of scale; launches "
              f"{counts} on {card}")
        if err > CHAIN_TOL or not moved > 1e-3:
            fail(f"{mode} eval: kernels vs plain {err:.3e}, edit moved {moved:.3e}")
        out[mode] = {"rel_err": err, "moved": moved, "launches": counts}
    return out


def clip_terms_check(torch, dev, card):
    """(f) the random RN50 tower (OpenAI's RN50 config, 38.3M params) and the
    four CLIP terms (global, angle and patch on the random ViT-B/16 of phase
    7, texture on the RN50) with their gradients w.r.t. both images, float32
    on the card against the same code on the CPU, TF32 off: 1e-4 of scale.
    Where the CPU's own float32 gradient is farther than that from its
    float64 one (a ReLU network's input gradient jumps where a
    pre-activation crosses 0 under rounding), the card's float32 gradient
    must be no farther from the float64 one than 2x the CPU's."""
    from asyrp_official_torch.losses import clip_loss as cl
    from asyrp_official_torch.losses.clip_model import CLIP, VIT_B16
    from asyrp_official_torch.losses.clip_resnet import RN50, ModifiedResNet
    from asyrp_official_torch.losses.tokenizer import HashTokenizer

    vit, rn = CLIP(VIT_B16, seed=SEED).eval(), ModifiedResNet(RN50, seed=SEED)
    gen = torch.Generator().manual_seed(SEED)
    noise = torch.rand(2, 2, IMAGE, IMAGE, 3, generator=gen) * 2 - 1
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, IMAGE), torch.linspace(-1, 1, IMAGE),
                            indexing="ij")
    smooth = torch.stack([torch.sin(3 * xx + 1), torch.cos(2 * yy), torch.sin(2 * (xx + yy))], -1)
    imgs = torch.stack([noise[0], 0.5 * noise[1] + 0.5 * smooth])  # src: noise; trg: apart
    q = IMAGE // 8  # patches of half the side, two per image, inside it
    centers = ([2 * q, 6 * q, 4 * q, 3 * q], [4 * q, 2 * q, 5 * q, 4 * q + q // 2])
    res, out = {}, {}
    for where, on, dtype in (("host", "cpu", torch.float32), ("host64", "cpu", torch.float64),
                             ("card", dev, torch.float32)):
        vctx = cl.CLIPContext(vit.to(on, dtype).requires_grad_(False), VIT_B16, HashTokenizer())
        rctx = cl.CLIPContext(rn.to(on, dtype).requires_grad_(False), RN50)
        words = vctx.encode_text(["a smiling face", "a face", "an angry face"])
        dirs = torch.nn.functional.normalize(words[:2] - words[2:], dim=-1)
        terms = {"global": lambda s, t: cl.global_loss(vctx, t, words[:1]),
                 "angle": lambda s, t: cl.angle_loss(vctx, s, t, words[1:2], words[:1]),
                 "texture": lambda s, t: cl.texture_loss(rctx, s, t),
                 "patch": lambda s, t: cl.patch_directional_loss(
                     vctx, s, t, dirs, patch_size=IMAGE // 2, num_patches=2, centers=centers)}
        for name, fn in terms.items():
            s, t = (imgs[i].to(on, dtype).requires_grad_(True) for i in (0, 1))
            t0 = time.perf_counter()
            value = fn(s, t)
            grads = torch.autograd.grad(value, (s, t), allow_unused=True)
            if where == "card":
                torch.cuda.synchronize()
            out[(where, name)] = [value.detach().reshape(1)] + [
                torch.zeros_like(s) if g is None else g for g in grads]
            res.setdefault(name, {})[f"{where}_s"] = time.perf_counter() - t0

    def err(a, b, parts=slice(None)):
        return max((errs(x, y)[1] for x, y in zip(out[a][parts], out[b][parts])
                    if float(y.abs().max()) > 0), default=0.0)

    for name in res:
        on_card, on_host = ("card", name), ("host", name)
        value_err = err(on_card, on_host, slice(0, 1))
        grad_err = err(on_card, on_host, slice(1, None))
        card64 = err(on_card, ("host64", name), slice(1, None))
        host64 = err(on_host, ("host64", name), slice(1, None))
        ok = all(bool(torch.isfinite(a).all()) for a in out[on_card])
        grad_ok = grad_err <= CLIP_TERM_TOL or (host64 > CLIP_TERM_TOL
                                                  and card64 <= BF16_GRAD_FACTOR * host64)
        res[name].update(value=float(out[on_host][0]), value_rel_err=value_err,
                         grad_rel_err=grad_err, card_vs_f64=card64, host_vs_f64=host64)
        phase(f"  (f) {name} term {res[name]['value']:.6e}: card vs CPU, value {value_err:.3e}, "
              f"input gradients {grad_err:.3e} (tol {CLIP_TERM_TOL:g}); against the CPU's float64 "
              f"gradients: card {card64:.3e}, CPU float32 {host64:.3e}; forward + backward "
              f"{res[name]['card_s']:.3f} s on {card}, {res[name]['host_s']:.3f} s on the host")
        if value_err > CLIP_TERM_TOL or not grad_ok or not ok:
            fail(f"CLIP {name} term: card vs CPU value {value_err:.3e}, gradients {grad_err:.3e} "
                 f"(vs float64: card {card64:.3e}, CPU {host64:.3e}), finite {ok}")
    rn.to("cpu", torch.float32)
    vit.to("cpu", torch.float32)
    return res


def style_phase(torch, dev, card, ws_root: str):
    """Phase 13: (a) `--diff_style` f32 and bf16 with K3 counted exactly; (b)
    the f32 sweep with the plain versions, and the edit against the
    un-edited reconstruction; (c) `--use_mask`, kernels and plain; (d) the
    image-noise gradient; (e) the global and interp_batch evals; (f) the
    RN50 tower and the CLIP terms."""
    import numpy as np
    from PIL import Image

    from asyrp_official_torch import uniform_seq
    from asyrp_official_torch.cli.main import build_parser, load_config
    from asyrp_official_torch.data.datasets import ImageFolderDataset
    from asyrp_official_torch.core.steptable import generation_table, inversion_table
    from asyrp_official_torch.pipelines import engine
    from asyrp_official_torch.pipelines.style_transfer import StyleTransfer
    from asyrp_official_torch.runner import AsyrpRunner

    t_phase = time.perf_counter()
    root = os.path.join(ws_root, "style")
    write_images(root, n=STYLE_CONTENTS, sub="contents")
    rng = np.random.RandomState(SEED + 1)  # a style image distinct from the contents
    os.makedirs(os.path.join(root, "styles"))
    Image.fromarray((rng.rand(IMAGE, IMAGE, 3) * 255).astype(np.uint8)).save(
        os.path.join(root, "styles", "0.png"))
    model_path = os.path.join(ws_root, "rows", "unet_random.pt")  # phase 10's seeded init
    seq = uniform_seq(STYLE_STEPS, 999)
    # the K3 launches of one sweep, from the tables: the contents' and the
    # style's inversions, STYLE_CONTENTS x 1 generations,
    # generations, gated at max(t_edit, content_replace_step)
    gate = max(T_EDIT, CONTENT_REPLACE)
    gen_table = generation_table(seq, t_edit=gate, delta_times=[t for t in seq if t >= gate])
    n_inv, n_gen = inversion_table(seq).num_steps, gen_table.num_steps
    expect_k3 = (STYLE_CONTENTS + 1) * n_inv + STYLE_CONTENTS * n_gen
    n_dual = int(np.sum(gen_table.use_delta))
    phase(f"  (a) --diff_style: {STYLE_CONTENTS} content image(s) x 1 style, {STYLE_STEPS} + "
          f"{STYLE_STEPS} "
          f"steps, t_edit "
          f"{T_EDIT}, content_replace_step {CONTENT_REPLACE}, hs_coeff 0.9: K3 derived "
          f"{expect_k3} launches ({STYLE_CONTENTS + 1} x {n_inv} inversion steps + "
          f"{STYLE_CONTENTS} x {n_gen} generation steps, "
          f"{n_dual} of them dual-decoded)")
    out = {"expect_k3": expect_k3, "dual_steps_per_generation": n_dual}
    runs = {}
    for dname in DTYPES:
        ws = os.path.join(root, dname)
        for sub in ("contents", "styles"):
            shutil.copytree(os.path.join(root, sub), os.path.join(ws, sub))
        runs[dname] = style_run(torch, card, style_argv(ws, None, bf16=dname == "bfloat16"),
                                f"--diff_style {dname}", expect_k3)
    out["runs"] = {k: v[1] for k, v in runs.items()}
    ws = os.path.join(root, "float32")
    outs_k = runs["float32"][0]
    outs_p, _ = style_run(torch, card, style_argv(ws, model_path, save="styled_plain"),
                          "(b) --diff_style float32, plain versions", expect_k3, plain=True)
    err = outputs_err(torch, outs_k, outs_p)

    # the un-edited reconstruction of content 0 (the sweep's own engines)
    args = build_parser().parse_args(style_argv(ws, model_path))
    runner = AsyrpRunner(args, load_config(CONFIG), work_dir=ws)
    model = runner.load_pretrained()
    st = StyleTransfer(runner.spec, runner.schedule, n_inv_step=STYLE_STEPS,
                       n_gen_step=STYLE_STEPS,
                       t_edit=T_EDIT, content_replace_step=CONTENT_REPLACE)
    content0 = ImageFolderDataset(os.path.join(ws, "contents"), IMAGE)[0]
    x_lat = st.invert_content(model, torch.from_numpy(content0[None]).to(dev))
    recon, _ = engine.make_generate(runner.spec, runner.schedule, seq)(model, x_lat)
    moved = errs(torch.from_numpy(outs_p["content0_style0.png"]), recon[0].cpu())[1]
    phase(f"  (b) float32 sweep, kernels vs plain versions: max |a - b| / max |b| {err:.3e} (tol "
          f"{CHAIN_TOL:g}); stylized vs the un-edited reconstruction {moved:.3e} of scale")
    if err > CHAIN_TOL or not moved > 1e-3:
        fail(f"--diff_style: kernels vs plain {err:.3e}, edit moved {moved:.3e}")
    out.update(sweep_rel_err=err, edit_moved=moved)

    outs_mk, res_mk = style_run(torch, card,
                                style_argv(ws, model_path, save="masked", extra=["--use_mask"]),
                                "(c) --diff_style --use_mask float32", expect_k3)
    outs_mp, _ = style_run(torch, card, style_argv(ws, model_path, save="masked_plain",
                                                   extra=["--use_mask"]),
                           "(c) --diff_style --use_mask float32, plain versions", expect_k3,
                           plain=True)
    err_m = outputs_err(torch, outs_mk, outs_mp)
    apart = outputs_err(torch, outs_mk, outs_k)
    phase(f"  (c) masked sweep, kernels vs plain versions: {err_m:.3e} (tol {CHAIN_TOL:g}); "
          f"masked vs unmasked outputs {apart:.3e} of scale")
    if err_m > CHAIN_TOL or not apart > 1e-3:
        fail(f"--use_mask: kernels vs plain {err_m:.3e}, masked vs unmasked {apart:.3e}")
    out.update(masked_rel_err=err_m, masked_vs_unmasked=apart, masked_run=res_mk)

    out["image_noise"] = noise_gradient_check(torch, dev, card, runner.spec, model,
                                              runner.schedule, x_lat)
    torch.cuda.empty_cache()
    out["edit_modes"] = edit_modes_check(torch, dev, card, runner.spec, model)
    del model, runner, st
    torch.cuda.empty_cache()
    out["clip_terms"] = clip_terms_check(torch, dev, card)
    out["seconds"] = time.perf_counter() - t_phase
    phase(f"  phase 13 took {out['seconds']:.1f} s")
    return out



# ---------------------------------------------------------------------------
# phase 14: base training of the UNets, the train-state sidecar, respaced
# sampling, the serving export, ResNet-18 and the shape report
# ---------------------------------------------------------------------------

BASE_LR, BASE_EMA, BASE_STEPS = 1e-4, 0.9999, 3
BASE_RECIPES = {  # config: (training_losses keywords, timestep sampler)
    CONFIG: (dict(mean_type="eps", var_type="fixedsmall", loss_type="mse"), "uniform"),
    # the P2 recipe of the AFHQ / FFHQ / MetFACE checkpoints
    AFHQ_CONFIG: (dict(mean_type="eps", var_type="learned_range", loss_type="rescaled_mse",
                       p2_gamma=1.0, p2_k=1.0), "loss-second-moment"),
}
BASE_RUNS = (  # (config, dtype, batch, steps, gated): the f32 bs 2 step runs cuDNN's FFT path
    (CONFIG, "float32", 1, BASE_STEPS, True),
    (AFHQ_CONFIG, "bfloat16", 8, BASE_STEPS, True),
    (AFHQ_CONFIG, "float32", 1, BASE_STEPS, True),
    (AFHQ_CONFIG, "float32", 2, 1, False),
)
BASE_KERNELS = {CONFIG: ("group_norm", "group_norm_bwd", "attention", "attention_bwd"),
                AFHQ_CONFIG: ("group_norm", "group_norm_bwd", "attention_mh", "attention_mh_bwd")}
BASE_ABSENT = {CONFIG: ("attention_mh", "attention_mh_bwd", "ddim_step", "ddim_step_bwd",
                        "ddpm_step"),
               AFHQ_CONFIG: ("attention", "attention_bwd", "ddim_step", "ddim_step_bwd",
                             "ddpm_step")}
BASE_GRAD_T = {1: (500,), 2: (750, 250)}  # the gradient gate's timesteps by batch
# a leaf's gradient error counts at the leaf's own scale, or at this share of
# the largest leaf's where its own is smaller: a gradient that is zero in
# exact arithmetic (the attention key bias: softmax ignores a shift shared by
# a query's logits) is float noise in either run, and a bias whose gradient
# is a sum over space that nearly cancels reads its rounding at its own scale
GRAD_FLOOR = 1e-3
RESPACED_STEPS = 25
LIB_TOL = 1e-4  # ResNet-18 on the card against the CPU, TF32 off
PARAM_COUNTS = {CONFIG: 113_673_219, AFHQ_CONFIG: 93_563_910, IMAGENET_CONFIG: IMAGENET_PARAMS}


def base_setup(torch, dev, ws_root: str, config: str):
    """(spec, Gaussian tables of the config's schedule, the state dict on the
    card): custom.yml from phase 10's seeded init, afhq.yml from phase 8's
    perturbed `.pt`."""
    from asyrp_official_torch.cli.main import load_config
    from asyrp_official_torch.core import gaussian as G
    from asyrp_official_torch.core.schedule import linear_beta_schedule
    from asyrp_official_torch.models.registry import spec_from_config

    cfg = load_config(config)
    d = cfg["diffusion"]
    tab = G.make_tables(linear_beta_schedule(d["beta_start"], d["beta_end"],
                                             d["num_diffusion_timesteps"]))
    path = (os.path.join(ws_root, "rows", "unet_random.pt") if config == CONFIG
            else os.path.join(ws_root, "afhq", "afhq_perturbed.pt"))
    return spec_from_config(cfg), tab, torch.load(path, map_location=dev)


def base_batch(torch, dev, i: int, bs: int, sampler):
    """Step i's batch: images in [-1, 1] and noise from a generator of seed
    SEED + i, timesteps and their weights from `sampler` with
    RandomState(SEED + i)."""
    import numpy as np

    gen = torch.Generator(device=dev).manual_seed(SEED + i)
    x0 = torch.rand(bs, 3, IMAGE, IMAGE, generator=gen, device=dev) * 2.0 - 1.0
    noise = torch.randn(bs, 3, IMAGE, IMAGE, generator=gen, device=dev)
    t, w = sampler.sample(bs, np.random.RandomState(SEED + i))
    return x0, torch.from_numpy(t).to(dev), noise, torch.from_numpy(w).to(dev)


def base_trainer(torch, dev, setup, config: str, dname: str):
    """A fresh model of the setup's weights, its EMA, Adam and the step:
    returns (model, ema, optimizer, sampler, step(i, bs) -> metrics)."""
    from asyrp_official_torch.core.resample import (
        LossSecondMomentResampler, create_named_schedule_sampler)
    from asyrp_official_torch.pipelines.base_train import (
        init_train_state, make_base_train_step, unet_eps_fn)

    spec, tab, sd = setup
    model = spec.build().to(dev)
    model.load_state_dict(sd)
    model, ema, opt = init_train_state(model, torch.optim.Adam(model.parameters(), lr=BASE_LR))
    recipe, sampler_name = BASE_RECIPES[config]
    sampler = create_named_schedule_sampler(sampler_name, tab.num_timesteps)
    step_fn = make_base_train_step(unet_eps_fn, tab, opt, ema_rate=BASE_EMA,
                                   compute_dtype=getattr(torch, dname), **recipe)

    def step(i: int, bs: int):
        x0, t, noise, w = base_batch(torch, dev, i, bs, sampler)
        m = step_fn(model, ema, x0, t, noise, w)
        if isinstance(sampler, LossSecondMomentResampler):
            sampler.update_with_local_losses(t.cpu().numpy(), m["loss_per_sample"].cpu().numpy())
        return m

    return model, ema, opt, sampler, step


def params_of(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


@contextlib.contextmanager
def deterministic_cudnn(torch):
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def base_timed_run(torch, dev, card, setup, config: str, dname: str, bs: int, steps: int):
    """One base-training run with the kernels and the default cuDNN: its
    launches (counters zeroed first), ms per step, images/s and peak
    memory; then one more step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    model, ema, _, _, step = base_trainer(torch, dev, setup, config, dname)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    walls, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        m = step(i, bs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    counts = counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    what = f"{config} base training {dname} bs {bs}"
    require_launches(counts, BASE_KERNELS[config], what)
    if any(counts[n] for n in BASE_ABSENT[config]):
        fail(f"{what} launched a kernel off its path {BASE_ABSENT[config]}: {counts}")
    finite = all(torch.isfinite(p).all() for p in model.parameters()) and all(
        math.isfinite(v) for v in losses)
    if not finite:
        fail(f"{what}: non-finite loss or parameters, losses {losses}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(steps, bs)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    row = {"batch": bs, "dtype": dname, "steps": steps, "losses": losses, "walls_ms": walls,
           "ms_per_step": statistics.median(walls[1:] if steps > 1 else walls),
           "peak_gib": peak, "launches": counts,
           "profile": device_time(prof, prof_wall, what)}
    row["images_per_s"] = bs / row["ms_per_step"] * 1e3
    per_step = {k: v / steps for k, v in counts.items() if v}
    phase(f"  (a) {what} on {card}: {steps} step(s), losses {[round(v, 5) for v in losses]}; "
          f"ms per step {', '.join(f'{w:.1f}' for w in walls)} (steady {row['ms_per_step']:.1f}, "
          f"{row['images_per_s']:.2f} images/s); peak {peak:.2f} GiB; launches per step "
          f"{per_step}; one more step under torch.profiler: " + fmt_device_time(row["profile"]))
    del model, ema, step
    torch.cuda.empty_cache()
    return row


def base_trajectory(torch, dev, setup, config: str, sidecar: str = None, plain: bool = False):
    """BASE_STEPS float32 steps at bs 1 under deterministic cuDNN, with the
    kernels or the plain versions: the losses, the parameters' and the EMA's
    updates from the init. With `sidecar`, the train state is saved after
    step 2 (`save_train_state`, the EMA in `extra`), restored into a fresh
    model, EMA and optimizer, and step 3 taken again from it: it must be
    bit-identical to the uninterrupted step 3. Each step's EMA must be
    `ema * rate + params * (1 - rate)` of its new parameters, bit for bit."""
    from asyrp_official_torch.pipelines.checkpoint import load_train_state, save_train_state

    with deterministic_cudnn(torch), (plain_versions() if plain else contextlib.nullcontext()):
        model, ema, opt, _, step = base_trainer(torch, dev, setup, config, "float32")
        init, losses = params_of(model), []
        for i in range(BASE_STEPS):
            if sidecar and i == BASE_STEPS - 1:
                save_train_state(sidecar, trainable=model.state_dict(), opt_state=opt.state_dict(),
                                 it_out=i, extra={"ema": ema.state_dict()})
            ema_before = params_of(ema)
            losses.append(step(i, 1)["loss"])
            new, ema_now = params_of(model), params_of(ema)
            if any(not torch.equal(ema_now[k], ema_before[k] * BASE_EMA + new[k] * (1.0 - BASE_EMA))
                   for k in new):
                fail(f"{config} base training step {i + 1}: the EMA is not "
                     "ema * rate + params * (1 - rate) of the step's parameters")
        out = {"losses": [float(v) for v in losses], "init": init, "params": params_of(model),
               "ema": params_of(ema)}
        del model, ema, opt, step
        if sidecar:
            model, ema, opt, _, step = base_trainer(torch, dev, setup, config, "float32")
            state = load_train_state(sidecar, like={"trainable": model.state_dict()},
                                     map_location=dev)
            model.load_state_dict(state["trainable"])
            ema.load_state_dict(state["extra"]["ema"])
            opt.load_state_dict(state["opt_state"])
            loss = step(state["meta"]["it_out"], 1)["loss"]
            same = (torch.equal(loss, losses[-1])
                    and all(torch.equal(v, out["params"][k]) for k, v in params_of(model).items())
                    and all(torch.equal(v, out["ema"][k]) for k, v in params_of(ema).items()))
            out["resume_bit_identical"] = same
            out["sidecar_mib"] = os.path.getsize(sidecar) / 2**20
            del model, ema, opt, step
    torch.cuda.empty_cache()
    return out


def update_err(got, want, init):
    """The update's error (got - init against want - init) over every
    parameter: (in the L2 norm over the whole update's, in the max norm
    over the largest element's). The gate reads the L2 one: Adam divides
    by sqrt(v) + 1e-8 per element, so an element whose gradient is zero in
    exact arithmetic (the attention key bias) moves by +-lr of float noise
    in either run, which the max norm would read as a fault."""
    import torch

    d2 = n2 = dmax = nmax = 0.0
    for k in want:
        u, d = want[k] - init[k], got[k] - want[k]
        d2 += float(torch.sum(d.double() ** 2))
        n2 += float(torch.sum(u.double() ** 2))
        dmax, nmax = max(dmax, float(d.abs().max())), max(nmax, float(u.abs().max()))
    return math.sqrt(d2 / max(n2, 1e-300)), dmax / max(nmax, 1e-30)


def base_grads(torch, dev, setup, config: str, dname: str, bs: int, plain: bool):
    """One step's gradient w.r.t. every parameter (f32 copies), deterministic
    cuDNN, with the kernels or the plain versions, on a fixed batch with
    BASE_GRAD_T's timesteps."""
    from asyrp_official_torch.core import gaussian as G
    from asyrp_official_torch.pipelines.base_train import unet_eps_fn

    spec, tab, sd = setup
    dtype = getattr(torch, dname)
    with deterministic_cudnn(torch), (plain_versions() if plain else contextlib.nullcontext()):
        model = spec.build().to(dev)
        model.load_state_dict(sd)
        gen = torch.Generator(device=dev).manual_seed(SEED + 100)
        x0 = torch.rand(bs, 3, IMAGE, IMAGE, generator=gen, device=dev) * 2.0 - 1.0
        noise = torch.randn(bs, 3, IMAGE, IMAGE, generator=gen, device=dev)
        t = torch.tensor(BASE_GRAD_T[bs], device=dev)
        terms = G.training_losses(tab, lambda x, tt: unet_eps_fn(model, x.to(dtype), tt).float(),
                                  x0, t, noise, **BASE_RECIPES[config][0])
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(terms["loss"].mean(), params)
        out = {n: g.float() for n, g in zip(names, grads)}
    del model, terms, grads
    return out


def grad_errs(got, want, floor: float = GRAD_FLOOR):
    """Per leaf max |a - b| over the leaf's scale, floored at `floor` of the
    largest leaf's."""
    top = max(float(v.abs().max()) for v in want.values())
    return {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), floor * top, 1e-30)
            for k, w in want.items()}


def worst(errs_by_leaf, n: int = 3) -> str:
    top = sorted(errs_by_leaf.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{k} {v:.2e}" for k, v in top)


def base_gates(torch, dev, card, setup, config: str, sidecar: str = None):
    """The gradient gate (float32 at bs 1: every leaf of the kernels'
    gradient within GRAD_TOL of the plain versions'; bfloat16 at bs 2, two
    timesteps: the kernels no farther from the float32 plain gradient than
    BF16_GRAD_FACTOR x the plain bfloat16 one) and the trajectory gate (the
    3-step f32 run, kernels vs plain: the loss per step within CHAIN_TOL, the
    update and the EMA's update within UPDATE_TOL in the L2 norm,
    `update_err`), with the sidecar check where `sidecar` is given."""
    t0 = time.perf_counter()
    g_k = base_grads(torch, dev, setup, config, "float32", 1, plain=False)
    g_p = base_grads(torch, dev, setup, config, "float32", 1, plain=True)
    f32 = grad_errs(g_k, g_p)
    own = grad_errs(g_k, g_p, floor=0.0)  # at each leaf's own scale, for the record
    top = max(float(v.abs().max()) for v in g_p.values())
    floored = sorted(k for k, v in g_p.items() if float(v.abs().max()) < GRAD_FLOOR * top)
    del g_k, g_p
    ref = base_grads(torch, dev, setup, config, "float32", 2, plain=True)
    bf_k = grad_errs(base_grads(torch, dev, setup, config, "bfloat16", 2, plain=False), ref)
    bf_p = grad_errs(base_grads(torch, dev, setup, config, "bfloat16", 2, plain=True), ref)
    del ref
    torch.cuda.empty_cache()
    phase(f"  (a) {config} one step's gradient w.r.t. all {len(f32)} parameters, per leaf, f32 bs "
          f"1 (t = {BASE_GRAD_T[1][0]}), kernels vs plain: worst {max(f32.values()):.3e} (tol "
          f"{GRAD_TOL:g}) at {worst(f32)}; {len(floored)} leaves under the floor ({GRAD_FLOOR:g} "
          f"of the largest leaf's scale {top:.3e}): {floored}; at each leaf's own scale the "
          f"worst reads {worst(own)}; bf16 bs 2 (t = {BASE_GRAD_T[2]}) "
          "against f32 plain: kernels worst "
          f"{max(bf_k.values()):.3e} ({worst(bf_k, 2)}), plain {max(bf_p.values()):.3e} (tol "
          f"{BF16_GRAD_FACTOR:g}x)")
    if max(f32.values()) > GRAD_TOL:
        fail(f"{config}: the float32 base-training gradient with the kernels disagrees with the "
             f"plain one: {worst(f32)}")
    if max(bf_k.values()) > BF16_GRAD_FACTOR * max(bf_p.values()):
        fail(f"{config}: the bfloat16 base-training gradient with the kernels is farther from the "
             f"float32 one than {BF16_GRAD_FACTOR:g}x the plain versions'")
    k = base_trajectory(torch, dev, setup, config, sidecar=sidecar)
    p = base_trajectory(torch, dev, setup, config, plain=True)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"]))
    upd, upd_max = update_err(k["params"], p["params"], p["init"])
    ema, ema_max = update_err(k["ema"], p["ema"], p["init"])
    phase(f"  (a) {config} {BASE_STEPS} f32 steps at bs 1 (deterministic cuDNN), kernels vs "
          f"plain: losses {[round(v, 6) for v in k['losses']]} vs "
          f"{[round(v, 6) for v in p['losses']]}, worst {loss_err:.3e} (tol {CHAIN_TOL:g}); "
          f"update {upd:.3e}, EMA update {ema:.3e} in the L2 norm (tol {UPDATE_TOL:g}; in the "
          f"max norm {upd_max:.3e} / {ema_max:.3e}); each EMA bit for bit its step's rate "
          "expression")
    if loss_err > CHAIN_TOL or upd > UPDATE_TOL or ema > UPDATE_TOL:
        fail(f"{config}: the 3-step base-training trajectory with the kernels departs from the "
             f"plain one: loss {loss_err:.3e}, update {upd:.3e}, EMA {ema:.3e}")
    out = {"grad_f32_worst": max(f32.values()), "grad_floored_leaves": floored,
           "grad_f32_own_scale": sorted(own.items(), key=lambda kv: -kv[1])[:10],
           "grad_bf16_kernels": max(bf_k.values()), "grad_bf16_plain": max(bf_p.values()),
           "losses_kernels": k["losses"], "losses_plain": p["losses"], "loss_err": loss_err,
           "update_err": upd, "ema_err": ema, "update_err_max": upd_max, "ema_err_max": ema_max,
           "seconds": time.perf_counter() - t0}
    if sidecar:
        phase(f"  (b) sidecar after step 2 ({k['sidecar_mib']:.1f} MiB), restored into a fresh "
              f"model, EMA and Adam: step 3 bit-identical to the uninterrupted run's (params, "
              f"EMA, loss): {k['resume_bit_identical']}")
        if not k["resume_bit_identical"]:
            fail(f"{config}: base training resumed from the sidecar is not bit-identical")
        out["sidecar_mib"] = k["sidecar_mib"]
    return out


def respaced_check(torch, dev, card, setup):
    """(c) `ddim_sample_loop` and `p_sample_loop` over RESPACED_STEPS
    respaced steps (space_timesteps -> respaced_tables ->
    wrap_model_for_respacing) of the AFHQ UNet, learned_range, 256^2 bs 1,
    kernels vs plain within CHAIN_TOL of scale."""
    from asyrp_official_torch.core import gaussian as G
    from asyrp_official_torch.core.schedule import linear_beta_schedule, space_timesteps
    from asyrp_official_torch.pipelines.base_train import unet_eps_fn
    from asyrp_official_torch.utils import hostrng

    spec, _, sd = setup
    model = spec.build().to(dev).eval().requires_grad_(False)
    model.load_state_dict(sd)
    tab, tmap = G.respaced_tables(linear_beta_schedule(1e-4, 0.02, 1000),
                                  space_timesteps(1000, str(RESPACED_STEPS)))
    fn = G.wrap_model_for_respacing(lambda x, t: unet_eps_fn(model, x, t), tmap)
    gen = torch.Generator(device=dev).manual_seed(SEED + 200)
    x_t = torch.randn(1, 3, IMAGE, IMAGE, generator=gen, device=dev)
    out = {}
    for name, loop in (("ddim_sample_loop", G.ddim_sample_loop),
                       ("p_sample_loop", G.p_sample_loop)):
        res = {}
        with torch.no_grad():
            for label in ("kernels", "plain"):
                zero_counters()
                t0 = time.perf_counter()
                with plain_versions() if label == "plain" else contextlib.nullcontext():
                    res[label] = loop(fn, tab, x_t, hostrng.PRNGKey(SEED), var_type="learned_range")
                torch.cuda.synchronize()
                res[f"{label}_s"] = time.perf_counter() - t0
                res[f"{label}_launches"] = counters()
        err = errs(res["kernels"], res["plain"])[1]
        moved = errs(res["kernels"], x_t)[1]
        phase(f"  (c) {name}, {RESPACED_STEPS} respaced steps, learned_range, afhq.yml 256^2 bs 1 "
              f"on {card}: kernels vs plain {err:.3e} of scale (tol {CHAIN_TOL:g}); "
              f"{res['kernels_s']:.2f} s (plain {res['plain_s']:.2f} s); launches "
              f"{ {k: v for k, v in res['kernels_launches'].items() if v} }; "
              f"{moved:.3e} of scale from x_T")
        if not torch.isfinite(res["kernels"]).all() or err > CHAIN_TOL:
            fail(f"respaced {name}: kernels vs plain {err:.3e}")
        require_launches(res["kernels_launches"], ("group_norm", "attention_mh"),
                         f"respaced {name}")
        out[name] = {"err": err, "seconds": res["kernels_s"], "plain_seconds": res["plain_s"]}
    del model
    torch.cuda.empty_cache()
    return out


def export_check(torch, dev, card, ws_root: str):
    """(d) `export_invert_edit` of custom.yml's 40 + 40-step f32 invert ->
    edit (phase 10's seeded UNet, phase 4's seeded DeltaBlock), `save_serving`,
    `load_serving`, the artifact run against the live `make_invert_edit` from
    the same x0 and key (1e-3 of scale); every exported graph names the
    registered ops and no aten group_norm, SDPA or softmax; K1, K2 and K3
    launch during the loaded run."""
    from asyrp_official_torch.core.schedule import make_schedule, uniform_seq
    from asyrp_official_torch.models.delta import EditState, delta_block_from_tree, delta_block_init
    from asyrp_official_torch.pipelines import engine, export
    from asyrp_official_torch.utils import hostrng

    spec, _, sd = base_setup(torch, dev, ws_root, CONFIG)
    model = spec.build().to(dev).eval().requires_grad_(False)
    model.load_state_dict(sd)
    block = delta_block_from_tree(delta_block_init(hostrng.PRNGKey(7), spec.bottleneck_ch,
                                                   spec.temb_ch), spec.bottleneck_ch,
                                  spec.temb_ch).to(dev).eval()
    edit = EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0], device=dev))
    sched, seq = make_schedule(), uniform_seq(STEPS, 999)
    path = os.path.join(ws_root, "serving.pt2")
    t0 = time.perf_counter()
    artifact, meta = export.export_invert_edit(spec, sched, seq, seq, model, edit, t_edit=T_EDIT,
                                               t_addnoise=T_ADDNOISE, batch=1, image_size=IMAGE)
    export_s = time.perf_counter() - t0
    export.save_serving(path, artifact, meta)
    t0 = time.perf_counter()
    fn = export.load_serving(path)
    load_s = time.perf_counter() - t0
    for kind, prog in fn.programs.items():
        targets = {str(n.target) for n in prog.graph.nodes if n.op == "call_function"}
        missing = [op for op in ("asyrp.group_norm.default", "asyrp.attention.default",
                                 "asyrp.ddim_step.default") if op not in targets]
        hidden = [t for t in targets if any(s in t for s in (
            "group_norm", "scaled_dot_product", "softmax")) and not t.startswith("asyrp.")]
        if missing or hidden:
            fail(f"exported {kind} program: registered ops missing {missing}, hidden in "
                 f"{hidden}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 300)
    x0 = torch.rand(1, IMAGE, IMAGE, 3, generator=gen, device=dev) * 2.0 - 1.0
    key = hostrng.PRNGKey(SEED)
    zero_counters()
    t0 = time.perf_counter()
    got = fn(model.state_dict(), edit, x0, key)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = counters()
    require_launches(counts, ("group_norm", "attention", "ddim_step"), "the loaded artifact")
    live = engine.make_invert_edit(spec, sched, seq, seq, t_edit=T_EDIT, t_addnoise=T_ADDNOISE)(
        model, edit, x0, noise_fn=export.engine_noise_fn(key))
    err = errs(got, live)[1]
    size = (os.path.getsize(path) + os.path.getsize(path + ".meta.json")) / 2**20
    phase(f"  (d) export of custom.yml's {STEPS} + {STEPS}-step f32 invert -> edit on {card}: "
          f"export {export_s:.1f} s (three per-step programs), artifact {size:.2f} MiB, load "
          f"{load_s:.1f} s; each graph names asyrp.group_norm / attention / ddim_step; the loaded "
          f"run {run_s:.2f} s, launches {counts}; vs the live engine {err:.3e} of scale (tol "
          f"{CHAIN_TOL:g})")
    if not torch.isfinite(got).all() or err > CHAIN_TOL:
        fail(f"the exported program departs from the live engine: {err:.3e}")
    del model, fn
    torch.cuda.empty_cache()
    return {"export_s": export_s, "load_s": load_s, "run_s": run_s, "artifact_mib": size,
            "err": err, "launches": counts}


def library_check(torch, dev, card):
    """(e) ResNet-18 (a seeded random init) on the card against the CPU at bs
    1 and 8, 256^2, TF32 off, within LIB_TOL of scale; the shape report of
    custom.yml, afhq.yml and imagenet.yml with their parameter counts."""
    import io as _io

    from asyrp_official_torch.cli.main import load_config
    from asyrp_official_torch.losses import resnet18
    from asyrp_official_torch.models.debug import forward_shape_report
    from asyrp_official_torch.models.registry import spec_from_config

    cpu = resnet18.init(SEED)
    gpu = resnet18.init(SEED).to(dev)
    out = {}
    for bs in (1, 8):
        x = torch.randn(bs, 3, IMAGE, IMAGE, generator=torch.Generator().manual_seed(SEED + bs))
        with torch.no_grad():
            want = resnet18.resnet18_features(cpu, x)
            got = resnet18.resnet18_features(gpu, x.to(dev))
            ms = time_ms(lambda: resnet18.resnet18_features(gpu, x.to(dev)), runs=10)
        err = max(errs(g, w)[1] for g, w in zip(got, want))
        phase(f"  (e) ResNet-18 bs {bs}, 256^2, card vs CPU: {err:.3e} of scale (tol {LIB_TOL:g}); "
              f"{ms:.2f} ms per forward on {card}")
        if err > LIB_TOL:
            fail(f"ResNet-18 on the card departs from the CPU: {err:.3e}")
        out[f"resnet18_bs{bs}"] = {"err": err, "ms": ms}
    for config in (CONFIG, AFHQ_CONFIG, IMAGENET_CONFIG):
        with contextlib.redirect_stdout(_io.StringIO()):
            rows = forward_shape_report(spec_from_config(load_config(config)))
        shapes = dict(rows)
        phase(f"  (e) forward_shape_report({config}): {shapes}")
        if shapes["params (count)"] != (PARAM_COUNTS[config],):
            fail(f"{config}: the shape report counts {shapes['params (count)']} parameters")
        out[config] = {k: list(v) for k, v in shapes.items()}
    del gpu
    torch.cuda.empty_cache()
    return out


def base_phase(torch, dev, card, ws_root: str):
    """Phase 14: (a) base training of the full-width custom.yml and afhq.yml
    UNets (BASE_RUNS), with the gradient and trajectory gates; (b) the
    train-state sidecar; (c) respaced sampling; (d) the serving export; (e)
    ResNet-18 and the shape report."""
    t_phase = time.perf_counter()
    out = {"runs": {}, "gates": {}, "seconds_by_part": {}}

    def timed(part, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        out["seconds_by_part"][part] = time.perf_counter() - t0
        return res

    for config in (CONFIG, AFHQ_CONFIG):
        setup = base_setup(torch, dev, ws_root, config)
        for cfg, dname, bs, steps, gated in BASE_RUNS:
            if cfg == config:
                row = timed(f"{config} {dname} bs {bs}", base_timed_run, torch, dev, card, setup,
                            config, dname, bs, steps)
                row["gated"] = gated
                out["runs"][f"{config} {dname} bs {bs}"] = row
        out["gates"][config] = timed(
            f"{config} gates", base_gates, torch, dev, card, setup, config,
            sidecar=os.path.join(ws_root, "base_train_state.pt") if config == CONFIG else None)
        if config == AFHQ_CONFIG:
            out["respaced"] = timed("respaced", respaced_check, torch, dev, card, setup)
        del setup
        torch.cuda.empty_cache()
    out["export"] = timed("export", export_check, torch, dev, card, ws_root)
    out["library"] = timed("library", library_check, torch, dev, card)
    out["seconds"] = time.perf_counter() - t_phase
    phase(f"  phase 14 took {out['seconds']:.1f} s on {card}: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in out["seconds_by_part"].items()))
    return out


# ---------------------------------------------------------------------------
# phase 15: multi-device (parallel/), on the one card
# ---------------------------------------------------------------------------

# phase 15's grids: inversion, training and generation steps (the runs are
# compared with a single-process run of the same recipe, not timed)
MD_STEPS = 4
MD_TOL = 1e-3  # x of a sharded run against the single-process run, of scale
MD_DELTA_TOL = 5e-5  # Δ leaves, --dp 2 against one process (JAX tests/test_runner_dp.py)
MD_GRID_TOL = 2  # uint8 levels of a grid, likewise
MD_KERNELS = ("group_norm_part", "group_norm_apply", "attention_kv")
MD_DEVICE = "cuda:0"  # every rank on the one card: an explicit device pins it
TOL.update({"group_norm_across": {"float32": 1e-5, "bfloat16": 2e-2},
            "attention_kv": {"float32": 1e-5, "bfloat16": 2e-2}})

# One rank of phase 15: the process group (gloo on cuda:0 for every rank,
# as NCCL refuses two ranks on one card; NCCL for a world of one; none for
# the single-process references), then the port's CLI runs of its spec with
# the launch counters zeroed just before each and read just after. With
# "record", rank 0 also keeps the shapes of the across-ranks entries'
# launches (forward and backward), every collective's time (synchronized
# around it) and bytes received, those inside the Δ-training step apart,
# the training timesteps and the UNet evals of each run. Every rank counts
# the plain K1-across versions' calls on CUDA tensors (none may run there).
MD_WORKER = r"""
import json, sys, time
import torch
import torch.distributed as dist

port, rank, world, backend, spec_path = sys.argv[1:6]
rank, world = int(rank), int(world)
spec = json.load(open(spec_path))
sys.path.insert(0, spec["repo"])
torch.cuda.set_device(0)
if backend != "none":
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
import chip_smoke as cs
from asyrp_official_torch.cli.main import main
from asyrp_official_torch.models import registry
from asyrp_official_torch.ops import attention as k2, groupnorm as k1

from asyrp_official_torch.pipelines import train as tr

rec = {"gn": {}, "kv": {}, "gnb": {}, "kvb": {}, "coll": [0, 0, 0.0], "coll_train": [0, 0, 0.0],
       "train": False, "train_steps": 0, "evals": 0, "plain_on_card": 0}


def on_card(plain):  # counts a plain version's calls on CUDA tensors (none may run)
    def call(*a, **kw):
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
            rec["plain_on_card"] += 1
        return plain(*a, **kw)
    return call


k1.combine_group_stats = on_card(k1.combine_group_stats)  # the plain apply's Chan combination
k1.group_norm_bwd_apply_plain = on_card(k1.group_norm_bwd_apply_plain)  # and the divide
if spec.get("record"):
    apply_, attn = k1._apply_cuda, k2._attention_cuda
    bwd_part_, attn_bwd = k1._bwd_part_cuda, k2._attention_bwd_cuda
    reduce_, gather_ = dist.all_reduce, dist.all_gather
    fused = lambda pa, ss: "pre_add" if pa is not None else "scale_shift" if ss is not None else ""

    def apply_rec(x, w, b, parts, eps, silu, pre_add, scale_shift, stats):
        key = json.dumps([list(x.shape), str(x.dtype), bool(silu), fused(pre_add, scale_shift)])
        rec["gn"][key] = rec["gn"].get(key, 0) + 1
        return apply_(x, w, b, parts, eps, silu, pre_add, scale_shift, stats)

    def attn_rec(q, k, v, with_lse, num_heads=1, legacy_scale=False):
        if k.shape[1] != q.shape[1]:
            key = json.dumps([list(q.shape), list(k.shape), str(q.dtype), num_heads,
                              bool(legacy_scale)])
            rec["kv"][key] = rec["kv"].get(key, 0) + 1
        return attn(q, k, v, with_lse, num_heads, legacy_scale)

    def bwd_part_rec(x, dy, w, b, mean, rstd, silu):
        key = json.dumps([list(x.shape), str(x.dtype), bool(silu)])
        rec["gnb"][key] = rec["gnb"].get(key, 0) + 1
        return bwd_part_(x, dy, w, b, mean, rstd, silu)

    def attn_bwd_rec(q, k, v, o, d_o, lse, num_heads, legacy_scale):
        if k.shape[1] != q.shape[1]:
            key = json.dumps([list(q.shape), list(k.shape), str(q.dtype), num_heads,
                              bool(legacy_scale)])
            rec["kvb"][key] = rec["kvb"].get(key, 0) + 1
        return attn_bwd(q, k, v, o, d_o, lse, num_heads, legacy_scale)

    def timed(fn, n_bytes):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            for key in ("coll", "coll_train") if rec["train"] else ("coll",):
                rec[key][0] += 1
                rec[key][1] += n_bytes(*a)
                rec[key][2] += ms
            return out
        return call

    make_step = tr.make_train_step

    def make_step_rec(*a, **kw):
        step = make_step(*a, **kw)

        def call(*a_, **kw_):
            rec["train"] = True
            try:
                out = step(*a_, **kw_)
            finally:
                rec["train"] = False
            rec["train_steps"] += len(out["loss_per_step"])
            return out

        call.compute_origins = step.compute_origins
        return call

    reduce_rec = timed(reduce_, lambda t, *a: t.numel() * t.element_size())
    gather_rec = timed(gather_, lambda parts, t, *a: len(parts) * t.numel() * t.element_size())

    apply_model = registry.ModelSpec.apply

    def apply_count(self, *a, **kw):
        rec["evals"] += 1
        return apply_model(self, *a, **kw)

    k1._apply_cuda, k2._attention_cuda = apply_rec, attn_rec
    k1._bwd_part_cuda, k2._attention_bwd_cuda = bwd_part_rec, attn_bwd_rec
    tr.make_train_step = make_step_rec
    dist.all_reduce, dist.all_gather = reduce_rec, gather_rec
    registry.ModelSpec.apply = apply_count
results = []
for argv in spec["runs"]:
    rec.update(gn={}, kv={}, gnb={}, kvb={}, coll=[0, 0, 0.0], coll_train=[0, 0, 0.0],
               train_steps=0, evals=0, plain_on_card=0)
    cs.zero_counters()
    t0 = time.perf_counter()
    rc = main(argv)
    torch.cuda.synchronize()
    results.append({"rc": rc, "counts": cs.counters(), "wall_s": time.perf_counter() - t0,
                    **{k: v for k, v in json.loads(json.dumps(rec)).items() if k != "train"}})
    if rc != 0:
        break
json.dump(results, open(f"{spec['out']}.{rank}.json", "w"))
if backend != "none":
    dist.barrier()
    dist.destroy_process_group()
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_ranks(world: int, backend: str, runs, out: str, record: bool = False):
    """Start `world` rank processes of MD_WORKER on the CLI runs `runs`.
    Returns a waiter: wait(timeout) -> every rank's results."""
    spec = {"repo": REPO, "runs": runs, "out": out, "record": record}
    with open(out + ".spec.json", "w") as f:
        json.dump(spec, f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", MD_WORKER, str(port), str(r), str(world),
                               backend, out + ".spec.json"], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def wait(timeout: float):
        deadline = time.monotonic() + timeout
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            fail(f"phase 15: {world} {backend} rank(s) did not finish within {timeout:.0f} s")
        for r, (p, log_) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"phase 15: rank {r} of {world} ({backend}) exited {p.returncode}:\n"
                     f"{log_[-3000:]}")
        res = [json.load(open(f"{out}.{r}.json")) for r in range(world)]
        for r, rr in enumerate(res):
            bad = [x["rc"] for x in rr if x["rc"] != 0]
            if bad or len(rr) != len(runs):
                fail(f"phase 15: rank {r} of {world} ({backend}): a CLI run exited {bad}:\n"
                     f"{logs[r][-3000:]}")
        return res

    return wait


def grid_arrays(ws: str):
    import numpy as np
    from PIL import Image

    return {os.path.relpath(p, ws): np.asarray(Image.open(p)).astype(np.int16)
            for p in sorted(glob.glob(os.path.join(ws, "runs", "**", "*.png"), recursive=True))}


def pairs_arrays(ws: str):
    import numpy as np

    out = {}
    for p in sorted(glob.glob(os.path.join(ws, "precomputed", "*.npz"))):
        with np.load(p) as d:
            out.update({f"{os.path.basename(p)}:{k}": d[k] for k in ("x_lat", "x_rec")})
    return out


def grids_diff(a, b, what: str) -> int:
    import numpy as np

    if not a or sorted(a) != sorted(b):
        fail(f"{what}: grids {sorted(a)} vs {sorted(b)}")
    return max(int(np.abs(a[k] - b[k]).max()) for k in a)


def md_serve_argv(ws: str, config: str, imgs: str, extra=(), n_img: int = 1, bs: int = 1,
                  weights=("--allow_random_weights",), ckpt: Optional[str] = "smoke_delta.pth"):
    """Serving argv of phase 15; `ckpt` None serves the exp's own trained
    checkpoint."""
    return ["--config", config, "--exp", os.path.join(ws, "runs", "md"), "--run_test",
            "--train_delta_block", *weights, "--device", MD_DEVICE,
            "--custom_train_dataset_dir", imgs, "--custom_test_dataset_dir", imgs,
            "--work_dir", ws, *(["--manual_checkpoint_name", ckpt] if ckpt else []),
            "--n_inv_step", str(MD_STEPS), "--n_train_step", str(MD_STEPS),
            "--n_test_step", str(MD_STEPS),
            "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
            "--bs_train", str(bs), "--n_test_img", str(n_img), "--do_train", "0",
            "--save_x_origin", "--seed", str(SEED), "--ni", *extra]


def md_train_argv(ws: str, imgs: str, clip_ckpt: str, extra=()):
    return ["--config", CONFIG, "--exp", os.path.join(ws, "runs", "md"), "--run_train",
            "--train_delta_block", "--edit_attr", "smiling", "--allow_random_weights",
            "--device", MD_DEVICE, "--clip_ckpt", clip_ckpt, "--clip_loss_w", "1",
            "--l1_loss_w", "3",
            "--get_h_num", "1", "--n_inv_step", str(MD_STEPS), "--n_train_step", str(MD_STEPS),
            "--n_iter", "1", "--n_train_img", "2", "--bs_train", "2", "--lr_training", "0.5",
            "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
            "--do_test", "0", "--custom_train_dataset_dir", imgs,
            "--custom_test_dataset_dir", imgs, "--work_dir", ws, "--seed", str(SEED), "--ni",
            *extra]


def md_workspace(root: str, name: str, ckpts=()) -> str:
    """A work dir with the two random images and the seeded Δ checkpoints."""
    ws = os.path.join(root, name)
    os.makedirs(os.path.join(ws, "checkpoint"))
    make_serving_workspace(ws)
    for src in ckpts:
        shutil.copy(src, os.path.join(ws, "checkpoint"))
    return ws


def md_trained_leaves(ws: str):
    import numpy as np

    from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint

    (path,) = glob.glob(os.path.join(ws, "checkpoint", "md_*_0.pth"))
    blk = load_delta_checkpoint(path)["blocks"][0]
    return {f"{g}.{k}": np.asarray(blk[g][k]) for g in sorted(blk) for k in sorted(blk[g])}


def multi_device_phase(torch, dev, card, ws_root: str, clip_ckpt: str, afhq_model: str,
                       afhq_delta: str):
    """Phase 15: the port's multi-device paths through its CLI, with rank
    processes on the one card: (a) one NCCL rank, `--dp -1` serving, against
    the run without a process group (bit for bit); (b) two gloo ranks,
    `--dp 2` Δ-training (CLIP + L1, bs 2) then serving, against one process
    (Δ leaves 5e-5, grids 2 levels); (c) four gloo ranks, `--dp 4
    --tp_spatial` serving of custom.yml and `--dp 2 --sp 2` serving of
    afhq.yml (bs 2), against one process (x_lat and x_rec 1e-3 of scale,
    grids 2 levels), K1 across ranks and K2 with Tq != Tk launched and the
    one-rank K1 and K2 never; the collectives' time per UNet eval. Returns
    the results and the shapes (d) times."""
    import numpy as np

    t_phase = time.perf_counter()
    root = os.path.join(ws_root, "multi_device")
    os.makedirs(root)
    out = {}

    # (a) and (b): the rank processes and their single-process references together
    ws_a = {k: md_workspace(root, f"a_{k}") for k in ("nccl", "none")}
    ws_b = {k: md_workspace(root, f"b_{k}") for k in ("dp2", "none")}
    for ws in ws_b.values():
        os.remove(os.path.join(ws, "checkpoint", "smoke_delta.pth"))
    imgs = lambda ws: os.path.join(ws, "imgs")
    serve_a = lambda k: md_serve_argv(ws_a[k], CONFIG, imgs(ws_a[k]),
                                      ["--dp", "-1"] if k == "nccl" else [])
    # training, then serving its checkpoint (the exp's iteration 0)
    b_runs = lambda k: [md_train_argv(ws_b[k], imgs(ws_b[k]), clip_ckpt,
                                      ["--dp", "2"] if k == "dp2" else []),
                        md_serve_argv(ws_b[k], CONFIG, imgs(ws_b[k]),
                                      ["--n_iter", "1"] + (["--dp", "2"] if k == "dp2" else []),
                                      n_img=2, bs=2, ckpt=None)]
    # (c) spatial sharding on four ranks, and the single-process references
    afhq_imgs = os.path.join(os.environ["ASYRP_TPU_DATA"], "afhq", "test", "dog")
    ws_c = {(k, fam): md_workspace(root, f"c_{k}_{fam}", (afhq_delta,))
            for k in ("spatial", "none") for fam in ("custom", "afhq")}

    def c_runs(k):
        tp = ["--dp", "4", "--tp_spatial"] if k == "spatial" else []
        sp = ["--dp", "2", "--sp", "2"] if k == "spatial" else []
        ws = ws_c[k, "custom"]
        custom = md_serve_argv(ws, CONFIG, imgs(ws), tp)
        afhq = md_serve_argv(ws_c[k, "afhq"], AFHQ_CONFIG, afhq_imgs, sp, n_img=2, bs=2,
                             weights=("--model_path", afhq_model),
                             ckpt=os.path.basename(afhq_delta))
        return [custom, afhq]

    # (a), (b) and (c) side by side (their collectives' times include the
    # others' load on the host and the card)
    t0 = time.perf_counter()
    waits = [start_ranks(1, "nccl", [serve_a("nccl")], os.path.join(root, "a_nccl")),
             start_ranks(1, "none", [serve_a("none")], os.path.join(root, "a_none")),
             start_ranks(2, "gloo", b_runs("dp2"), os.path.join(root, "b_dp2")),
             start_ranks(1, "none", b_runs("none"), os.path.join(root, "b_none")),
             start_ranks(4, "gloo", c_runs("spatial"), os.path.join(root, "c_spatial"),
                         record=True),
             start_ranks(1, "none", c_runs("none"), os.path.join(root, "c_none"))]
    res_a_nccl, res_a_none, res_b_dp2, res_b_none, res_c, res_c_none = (w(900) for w in waits)
    out["seconds_a_b_c"] = time.perf_counter() - t0
    ga, gn = grid_arrays(ws_a["nccl"]), grid_arrays(ws_a["none"])
    pa, pn = pairs_arrays(ws_a["nccl"]), pairs_arrays(ws_a["none"])
    same = (sorted(ga) == sorted(gn) and all(np.array_equal(ga[k], gn[k]) for k in ga)
            and sorted(pa) == sorted(pn) and all(np.array_equal(pa[k], pn[k]) for k in pa))
    if not ga or not pa or not same:
        fail(f"phase 15 (a): --dp -1 on one NCCL rank differs from the run without a group "
             f"({sorted(ga)}, {sorted(pa)})")
    out["a"] = {"bitwise_equal": True, "grids": len(ga), "launches": res_a_nccl[0][0]["counts"]}
    phase(f"  (a) --dp -1 serving on one NCCL rank (custom.yml, {MD_STEPS} + {MD_STEPS} steps, "
          f"f32): {len(ga)} grids and {len(pa)} latent arrays bit for bit those of the run "
          f"without a process group; launches {res_a_nccl[0][0]['counts']}")
    la, lb = md_trained_leaves(ws_b["none"]), md_trained_leaves(ws_b["dp2"])
    d_err = max(float(np.abs(la[k] - lb[k]).max()) for k in la)
    g_err = grids_diff(grid_arrays(ws_b["dp2"]), grid_arrays(ws_b["none"]), "phase 15 (b)")
    counts_b = [r["counts"] for r in res_b_dp2[0]]
    for c_, what in zip(counts_b, ("training", "serving")):
        require_launches(c_, TRAIN_KERNELS if what == "training" else
                         ("group_norm", "attention", "ddim_step"), f"phase 15 (b) {what}")
    out["b"] = {"delta_max_abs_err": d_err, "grid_max_levels": g_err, "launches": counts_b,
                "wall_s": {k: [r["wall_s"] for r in v[0]] for k, v in
                           (("dp2", res_b_dp2), ("single", res_b_none))}}
    phase(f"  (b) --dp 2 on two gloo ranks: Δ-training (CLIP + L1, bs 2, {MD_STEPS} steps) then "
          f"serving, against one process: Δ leaves max |a - b| {d_err:.3e} (tol "
          f"{MD_DELTA_TOL:g}), grids {g_err} levels (tol {MD_GRID_TOL}); rank 0 launches "
          f"{counts_b}; walls (train, serve) 2 ranks {out['b']['wall_s']['dp2']} s, one process "
          f"{out['b']['wall_s']['single']} s")
    if d_err > MD_DELTA_TOL or g_err > MD_GRID_TOL:
        fail(f"phase 15 (b): --dp 2 differs from one process: Δ {d_err:.3e}, grids {g_err}")

    # (c): against the single-process references
    g_err, x_err = 0, {}
    for fam in ("custom", "afhq"):
        gs, gn = grid_arrays(ws_c["spatial", fam]), grid_arrays(ws_c["none", fam])
        g_err = max(g_err, grids_diff(gs, gn, f"phase 15 (c) {fam}"))
        ps, pn = pairs_arrays(ws_c["spatial", fam]), pairs_arrays(ws_c["none", fam])
        if not ps or sorted(ps) != sorted(pn):
            fail(f"phase 15 (c) {fam}: latent caches {sorted(ps)} vs {sorted(pn)}")
        x_err.update({f"{fam} {k.split(':')[1]}": float(np.abs(ps[k] - pn[k]).max()
                                                      / np.abs(pn[k]).max()) for k in ps})
    labels = ("custom.yml --dp 4 --tp_spatial", "afhq.yml --dp 2 --sp 2")
    out["c"] = {"x_rel_err": x_err, "grid_max_levels": g_err, "runs": {}}
    seen = {"group_norm_across": {}, "attention_kv": {}}
    for i, label in enumerate(labels):
        counts = {k_: sum(r[i]["counts"][k_] for r in res_c) for k_ in res_c[0][i]["counts"]}
        if not all(counts[k_] for k_ in MD_KERNELS):
            fail(f"phase 15 (c) {label}: the new entries did not all launch: {counts}")
        if counts["group_norm"] or counts["attention"] or counts["attention_mh"]:
            fail(f"phase 15 (c) {label}: a one-rank K1 or K2 launched under spatial sharding: "
                 f"{counts}")
        plain_calls = sum(r[i]["plain_on_card"] for r in res_c)
        if plain_calls:
            fail(f"phase 15 (c) {label}: {plain_calls} plain K1-across calls (Chan's combination "
                 f"in torch ops) on the card path")
        r0 = res_c[0][i]
        n_coll, n_bytes, coll_ms = r0["coll"]
        evals = max(r0["evals"], 1)
        run = {"launches": counts, "rank0_launches": r0["counts"], "wall_s": r0["wall_s"],
               "single_process_wall_s": res_c_none[0][i]["wall_s"], "unet_evals": r0["evals"],
               "collectives": n_coll, "collective_mb": n_bytes / 1e6,
               "collective_ms": coll_ms, "collective_ms_per_eval": coll_ms / evals,
               "collectives_per_eval": n_coll / evals}
        out["c"]["runs"][label] = run
        family = "openai" if "afhq" in label else "ddpm"
        for key, n in r0["gn"].items():
            shape, dname, silu, fused = json.loads(key)
            if dname == "torch.float32":
                k_ = (tuple(shape), silu, 1e-5 if family == "openai" else 1e-6, fused or None)
                seen["group_norm_across"][k_] = seen["group_norm_across"].get(k_, 0) + n
        for key, n in r0["kv"].items():
            qs, ks, dname, heads, legacy = json.loads(key)
            if dname == "torch.float32":
                k_ = (tuple(qs), tuple(ks), heads, legacy)
                seen["attention_kv"][k_] = seen["attention_kv"].get(k_, 0) + n
        phase(f"  (c) {label} ({MD_STEPS} + {MD_STEPS} steps, f32) on {card}: launches over "
              f"the ranks {counts}; rank 0 ran {r0['evals']} UNet evals with {n_coll} "
              f"collectives ({n_bytes / 1e6:.1f} MB; {n_coll / evals:.0f} per eval) taking "
              f"{coll_ms:.1f} ms = {coll_ms / evals:.2f} ms per eval, synchronized around each "
              f"(gloo through the host, four ranks sharing one card: what the exchanges cost "
              f"here, not multi-GPU scaling); whole CLI run {r0['wall_s']:.1f} s on 4 ranks vs "
              f"{res_c_none[0][i]['wall_s']:.1f} s in one process")
    worst = max(x_err.values())
    phase(f"  (c) against one process: x_lat / x_rec max |a - b| / max |b| "
          + ", ".join(f"{k} {v:.3e}" for k, v in x_err.items())
          + f" (tol {MD_TOL:g}); grids {g_err} levels (tol "
          f"{MD_GRID_TOL})")
    if worst > MD_TOL or g_err > MD_GRID_TOL:
        fail(f"phase 15 (c): sharded serving differs from one process: x {worst:.3e}, grids "
             f"{g_err}")
    out["seconds"] = time.perf_counter() - t_phase
    phase(f"  phase 15 (a)-(c) took {out['seconds']:.1f} s ((a), (b) and (c) side by side "
          f"{out['seconds_a_b_c']:.1f} s)")
    return out, seen


def md_row_table(torch, dev, seen, builders, seed: int, per: str, lib_name: str):
    """Phase 15 (d)'s row driver. For each kernel name of `builders` and
    each shape (key) that `seen` recorded on rank 0, float32 then bfloat16,
    `builders[name](key, dtype, randn, inputs)` gives the row: `run_k`,
    `run_p` (the kernel and plain calls), `lib` (one PyTorch call of the
    same function, or None), the outputs `got` and `want`, `ref` (None, or
    float32 plain outputs: then the bound is BF16_GRAD_FACTOR x the plain
    version's own distance from them), `bound`, `label`, `note` and
    `bitwise` (two calls must agree bit for bit). Every output must be
    finite and within the bound; CUDA-event and device times of each call.
    Returns {name: {dtype: totals}}, each weighted by the calls per `per`
    (`inputs` is the builder's own cache, shared by a key's two dtypes)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    out = {}
    for name, build in builders.items():
        out[name] = {}
        inputs = {}
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0,
                   "plain_device_ms": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0, "calls": 0,
                   "library_ms": None, "library_device_ms": None}
            by = {"bytes": 0.0, "operations": 0.0}
            for key, count in sorted(seen[name].items(), key=lambda kv: str(kv[0])):
                r = build(key, dtype, randn, inputs)
                label, ref = r["label"], r.get("ref")
                torch.cuda.synchronize()
                abs_err = rel_err = 0.0
                for g_, w_ in zip(r["got"], r["want"] if ref is None else ref):
                    if not torch.isfinite(g_.float()).all():
                        fail(f"{name} {label} {dname}: non-finite output")
                    a_, r_ = errs(g_.float(), w_.float())
                    abs_err, rel_err = max(abs_err, a_), max(rel_err, r_)
                if ref is None:
                    tol = TOL[name][dname]
                    tol_note = f"tol {tol:g}"
                else:  # bf16: against the f32 plain versions, 2x the plain bf16's own error
                    plain_err = max(errs(w_.float(), r_.float())[1]
                                    for w_, r_ in zip(r["want"], ref))
                    tol = BF16_GRAD_FACTOR * plain_err
                    tol_note = (f"vs float32 plain; tol {BF16_GRAD_FACTOR:g} x the plain "
                                f"bfloat16's {plain_err:.3e}")
                bit_note = ""
                if r.get("bitwise"):
                    if not same_bits(r["run_k"](), r["run_k"]()):
                        fail(f"{name} {label} {dname}: two calls on the same inputs differ")
                    bit_note = "; bitwise equal across two calls"
                lib = r.get("lib")
                fns = (r["run_k"], r["run_p"]) + ((lib,) if lib else ())
                ms = [time_ms(f, runs=ROW_RUNS) for f in fns]
                dv = [device_ms(f, runs=ROW_DEVICE_RUNS) for f in fns]
                lib_note = (f", {lib_name} {ms[2]:.4f} ms (device {dv[2]:.4f})" if lib else "")
                b_ms, b_by = r["bound"]
                phase(f"  {name} {dname} {label} x{count}: rel err {rel_err:.3e} ({tol_note})"
                      f"{r.get('note', '')}{bit_note}; kernel {ms[0]:.4f} ms per call (device "
                      f"{dv[0]:.4f}), plain {ms[1]:.4f} ms (device {dv[1]:.4f}){lib_note}; "
                      f"bound {b_ms:.4f} ms ({b_by}){'' if rel_err <= tol else '  <-- FAIL'}")
                if rel_err > tol:
                    fail(f"{name} {label} {dname} disagrees with its plain version: {rel_err:.3e}")
                for k_, v_ in (("ms", ms[0]), ("plain_ms", ms[1]), ("device_ms", dv[0]),
                               ("plain_device_ms", dv[1]), ("bound_ms", b_ms)):
                    tot[k_] += v_ * count
                if lib:
                    tot["library_ms"] = (tot["library_ms"] or 0.0) + ms[2] * count
                    tot["library_device_ms"] = (tot["library_device_ms"] or 0.0) + dv[2] * count
                tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
                tot["max_rel_err"] = max(tot["max_rel_err"], rel_err)
                tot["calls"] += count
                by[b_by] += b_ms * count
            tot["bound_by"] = max(by, key=by.get)
            out[name][dname] = tot
            lib_sum = ("" if tot["library_ms"] is None else
                       f", {lib_name} {tot['library_ms']:.3f} ms (device "
                       f"{tot['library_device_ms']:.3f})")
            phase(f"  {name} {dname}: {tot['calls']} calls per {per} on rank 0 take "
                  f"{tot['ms']:.3f} ms (device {tot['device_ms']:.3f}) vs plain "
                  f"{tot['plain_ms']:.3f} ms (device {tot['plain_device_ms']:.3f}){lib_sum}; "
                  f"bound {tot['bound_ms']:.3f} ms")
    return out


def md_rows(torch, dev, seen):
    """Phase 15 (d): K1 across ranks (the part statistics, then the apply
    from the combined statistics) and K2 with Tq != Tk against their plain
    versions at every shape (c) gave them on rank 0, f32 and bf16: CUDA-event
    and device times, SDPA at the same Tq / Tk (K2), the bound. Per row and
    per request (rank 0's calls over one run of (c))."""
    import torch.nn.functional as F

    from asyrp_official_torch.ops import attention as k2, groupnorm as k1

    def k1_across(key, dtype, randn, inputs):
        es = torch.tensor([], dtype=dtype).element_size()
        shape, silu, eps, fused = key
        x = (randn(*shape) * 3 + 4).to(dtype)
        w, b = 1 + 0.1 * randn(shape[1]), 0.1 * randn(shape[1])
        kw, extra = {}, 0
        if fused == "pre_add":
            kw["pre_add"] = randn(shape[0], shape[1]).to(dtype)
            extra = shape[0] * shape[1] * es
        elif fused == "scale_shift":
            kw["scale_shift"] = (0.1 * randn(shape[0], 2 * shape[1])).to(dtype)
            extra = 2 * shape[0] * shape[1] * es
        # this block as one of 4 ranks' (the other parts as its own), the
        # gathered parts made once: a call is the two kernels (the part
        # statistics, then the apply, which combines the 4 parts in its
        # prologue), not the gather's stack copy between them
        def gathered(part):
            parts = part(x, pre_add=kw.get("pre_add"))
            return parts.expand(4, *parts.shape).contiguous()

        gathered_k = gathered(k1.group_norm_part_stats)
        gathered_p = gathered(k1.group_norm_part_stats_plain)

        def run_k():
            k1.group_norm_part_stats(x, pre_add=kw.get("pre_add"))
            return k1.group_norm_apply(x, w, b, gathered_k, eps=eps, silu=silu, stats=True, **kw)

        def run_p():
            k1.group_norm_part_stats_plain(x, pre_add=kw.get("pre_add"))
            return k1.group_norm_apply_plain(x, w, b, gathered_p, eps=eps, silu=silu, stats=True,
                                             **kw)

        y, m_k, r_k = run_k()
        y_p, mean, rstd = run_p()
        n = x.numel()
        return dict(run_k=run_k, run_p=run_p, got=[m_k, r_k, y], want=[mean, rstd, y_p],
                    bound=bound(2 * n * es + 2 * shape[1] * 4 + extra, n * (10 + 4 * silu),
                                PEAK_FLOPS["float32"]),
                    label=f"{list(shape)} silu={int(silu)} eps={eps:g} fused={fused}",
                    bitwise=True)

    def k2_kv(key, dtype, randn, inputs):
        es = torch.tensor([], dtype=dtype).element_size()
        dname = str(dtype).split(".")[-1]
        qs, ks, heads, legacy = key
        q = randn(*qs).to(dtype)
        kk, v = randn(*ks).to(dtype), randn(*ks).to(dtype)
        kw = dict(num_heads=heads, legacy_scale=legacy)
        run_k = lambda: k2.attention(q, kk, v, **kw)
        run_p = lambda: k2.attention_plain(q, kk, v, **kw)
        bsz, tq, c = qs
        tk, hd = ks[1], c // heads
        q4 = q.view(bsz, tq, heads, hd).transpose(1, 2)
        k4, v4 = (a.view(bsz, tk, heads, hd).transpose(1, 2) for a in (kk, v))
        o_p, lse_p = k2._plain_with_lse(q, kk, v, heads, legacy)
        return dict(run_k=run_k, run_p=run_p,
                    lib=lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=hd ** -0.5),
                    got=[run_k(), *k2._attention_cuda(q, kk, v, True, heads, legacy)],
                    want=[o_p, o_p, lse_p],
                    bound=bound(2 * bsz * (tq + tk) * c * es, 4 * bsz * tq * tk * c,
                                PEAK_FLOPS[dname]),
                    label=f"q {list(qs)} k {list(ks)} heads={heads} legacy_scale={int(legacy)}")

    return md_row_table(torch, dev, seen, {"group_norm_across": k1_across, "attention_kv": k2_kv},
                        seed=15, per="request", lib_name="SDPA")


# phase 15 (e) and (f): spatial training and the other modes under spatial
# sharding (the Δ leaves and grids against one process, with the JAX
# package's bounds; the LPIPS curves at its --lpips bound)
MD_LPIPS_TOL = 5e-3
MD_TRAIN_KERNELS = ("group_norm_bwd_part", "group_norm_bwd_apply", "attention_kv_bwd")
MD_ONE_RANK = ("group_norm", "group_norm_bwd", "attention", "attention_mh", "attention_bwd",
               "attention_mh_bwd")
TOL.update({"group_norm_bwd_across": {"float32": 1e-4},
            "attention_kv_bwd": {"float32": 1e-4}})


def md_e_runs(ws: str, case: str, clip_ckpt: str, afhq_model: str, mesh=()):
    """(e)'s CLI runs of one case: `blocks` (custom.yml, CLIP + L1, bs 1,
    then serving its block), `rows` (custom.yml --train_delta_h, bs 1) or
    `afhq` (afhq.yml, CLIP + L1, bs 2)."""
    imgs = os.path.join(ws, "imgs")
    one = ["--bs_train", "1", "--n_train_img", "1", *mesh]
    if case == "blocks":
        return [md_train_argv(ws, imgs, clip_ckpt, one),
                md_serve_argv(ws, CONFIG, imgs, ["--n_iter", "1", *mesh], ckpt=None)]
    if case == "rows":
        argv = md_train_argv(ws, imgs, clip_ckpt, one)
        return [["--train_delta_h" if a == "--train_delta_block" else a for a in argv]]
    return [openai_train_argv("afhq", ws, afhq_model, clip_ckpt, "md", extra=[
        "--device", MD_DEVICE, "--n_inv_step", str(MD_STEPS), "--n_train_step", str(MD_STEPS),
        "--n_iter", "1", "--n_train_img", "2", "--bs_train", "2", "--do_test", "0", *mesh])]


def md_f_runs(ws: str, npz: str, mesh=()):
    """(f)'s CLI runs on custom.yml with the seeded random UNet: `--lpips`
    (MD_STEPS inversion steps of 2 images), `--run_fidelity` (phase 15's
    seeded block, 1 image) and `--diff_style` (1 content x 1 style)."""
    imgs = os.path.join(ws, "imgs")
    common = ["--config", CONFIG, "--allow_random_weights", "--device", MD_DEVICE,
              "--work_dir", ws, "--seed", str(SEED), "--ni",
              "--user_defined_t_edit", str(T_EDIT), "--user_defined_t_addnoise", str(T_ADDNOISE),
              "--custom_train_dataset_dir", imgs, "--custom_test_dataset_dir", imgs,
              "--n_inv_step", str(MD_STEPS), "--n_train_step", str(MD_STEPS),
              "--n_test_step", str(MD_STEPS), "--bs_train", "1", *mesh]
    return [["--exp", os.path.join(ws, "runs", "calib"), "--lpips", "--lpips_ckpt", npz,
             "--n_train_img", "1", *common],
            ["--exp", os.path.join(ws, "runs", "fid"), "--run_fidelity", "--train_delta_block",
             "--manual_checkpoint_name", "smoke_delta.pth", "--n_test_img", "1", *common],
            ["--exp", os.path.join(ws, "runs", "style"), "--diff_style",
             "--content_dir", os.path.join(ws, "contents"), "--style_dir",
             os.path.join(ws, "styles"), "--save_dir", os.path.join(ws, "runs", "styled"),
             "--n_gen_step", str(MD_STEPS), *common]]


def md_leaves(ws: str):
    """The trained Δ's leaves (the exp's iteration 0): a block's, or the rows."""
    import numpy as np

    from asyrp_official_torch.compat.delta_ckpt import load_delta_checkpoint

    (path,) = glob.glob(os.path.join(ws, "checkpoint", "md_*_0.pth"))
    loaded = load_delta_checkpoint(path)
    if "blocks" not in loaded:
        return {f"row {t}": np.asarray(r) for t, r in loaded["delta_rows"].items()}
    blk = loaded["blocks"][0]
    return {f"{g}.{k}": np.asarray(blk[g][k]) for g in sorted(blk) for k in sorted(blk[g])}


def md_train_phase(torch, card, ws_root: str, clip_ckpt: str, afhq_model: str):
    """Phase 15 (e): four gloo ranks on the one card, Δ-training under
    spatial sharding against one process: `custom.yml --dp 4 --tp_spatial`
    (a DeltaBlock, CLIP + L1, bs 1, then serving its block; the Δh rows),
    `afhq.yml --dp 2 --sp 2` (bs 2); Δ leaves within MD_DELTA_TOL, grids
    within MD_GRID_TOL; K1-bwd across ranks and K2-bwd with Tq != Tk
    launched, no one-rank K1, K2, K1-bwd or K2-bwd; rank 0's collectives per
    training timestep. (f): two gloo ranks, `--lpips`, `--run_fidelity` and
    `--diff_style` under `--dp 2 --tp_spatial` against one process (curves
    within MD_LPIPS_TOL, images within MD_GRID_TOL). Returns the results
    and the backward entries' shapes on rank 0 (for their rows)."""
    import numpy as np

    from asyrp_official_torch.utils.assets import load_lpips_tsv

    t_phase = time.perf_counter()
    root = os.path.join(ws_root, "multi_device_train")
    os.makedirs(root)
    cases = ("blocks", "rows", "afhq")
    ws_e = {(k, c): md_workspace(root, f"e_{k}_{c}") for k in ("spatial", "none") for c in cases}
    ws_f = {k: md_workspace(root, f"f_{k}") for k in ("spatial", "none")}
    npz = write_lpips_npz(os.path.join(root, "lpips.npz"))
    for ws in ws_f.values():
        write_images(ws, n=1, sub="contents")
        write_images(ws, n=1, sub="styles")
    meshes = {"blocks": ["--dp", "4", "--tp_spatial"], "rows": ["--dp", "4", "--tp_spatial"],
              "afhq": ["--dp", "2", "--sp", "2"]}
    e_runs = lambda k: [argv for c in cases for argv in md_e_runs(
        ws_e[k, c], c, clip_ckpt, afhq_model, meshes[c] if k == "spatial" else ())]
    t0 = time.perf_counter()
    waits = [start_ranks(4, "gloo", e_runs("spatial"), os.path.join(root, "e_spatial"),
                         record=True),
             start_ranks(1, "none", e_runs("none"), os.path.join(root, "e_none")),
             start_ranks(2, "gloo", md_f_runs(ws_f["spatial"], npz, ["--dp", "2", "--tp_spatial"]),
                         os.path.join(root, "f_spatial"), record=True),
             start_ranks(1, "none", md_f_runs(ws_f["none"], npz), os.path.join(root, "f_none"))]
    res_e, res_e_none, res_f, res_f_none = (w(900) for w in waits)
    out = {"seconds_e_f": time.perf_counter() - t0, "e": {}, "f": {}}

    # (e): the Δ, the grids, the launches and rank 0's collectives per timestep
    labels = {"blocks": "custom.yml --dp 4 --tp_spatial, DeltaBlock",
              "rows": "custom.yml --dp 4 --tp_spatial, Δh rows",
              "afhq": "afhq.yml --dp 2 --sp 2, DeltaBlock, bs 2"}
    seen = {"group_norm_bwd_across": {}, "attention_kv_bwd": {}}
    i = 0
    worst_d = worst_g = 0
    for c in cases:
        la, lb = md_leaves(ws_e["none", c]), md_leaves(ws_e["spatial", c])
        if sorted(la) != sorted(lb):
            fail(f"phase 15 (e) {c}: leaves {sorted(la)} vs {sorted(lb)}")
        d_err = max(float(np.abs(la[k] - lb[k]).max()) for k in la)
        g_err = (grids_diff(grid_arrays(ws_e["spatial", c]), grid_arrays(ws_e["none", c]),
                            f"phase 15 (e) {c}") if c == "blocks" else None)
        worst_d, worst_g = max(worst_d, d_err), max(worst_g, g_err or 0)
        n_runs = 2 if c == "blocks" else 1
        train = [r[i] for r in res_e]
        counts = {k_: sum(r[k_] for r in (t["counts"] for t in train)) for k_ in train[0]["counts"]}
        if not all(counts[k_] for k_ in MD_TRAIN_KERNELS + MD_KERNELS):
            fail(f"phase 15 (e) {c}: the across-ranks entries did not all launch: {counts}")
        if any(counts[k_] for k_ in MD_ONE_RANK):
            fail(f"phase 15 (e) {c}: a one-rank K1, K2, K1-bwd or K2-bwd launched under "
                 f"spatial sharding: {counts}")
        plain_calls = sum(t["plain_on_card"] for t in train)
        if plain_calls:
            fail(f"phase 15 (e) {c}: {plain_calls} plain K1-across calls (Chan's combination or "
                 f"the sums' divide in torch ops) on the card path")
        r0 = train[0]
        n_coll, n_bytes, coll_ms = r0["coll_train"]
        steps = max(r0["train_steps"], 1)
        run = {"delta_max_abs_err": d_err, "grid_max_levels": g_err, "launches": counts,
               "rank0_launches": r0["counts"], "wall_s": r0["wall_s"],
               "single_process_wall_s": res_e_none[0][i]["wall_s"],
               "train_timesteps": r0["train_steps"], "collectives_per_timestep": n_coll / steps,
               "collective_mb_per_timestep": n_bytes / steps / 1e6,
               "collective_ms_per_timestep": coll_ms / steps,
               "collective_ms_run": r0["coll"][2]}
        out["e"][labels[c]] = run
        family = "openai" if c == "afhq" else "ddpm"
        for key, n in r0["gnb"].items():
            shape, dname, silu = json.loads(key)
            if dname == "torch.float32":
                k_ = (tuple(shape), silu, 1e-5 if family == "openai" else 1e-6)
                seen["group_norm_bwd_across"][k_] = seen["group_norm_bwd_across"].get(k_, 0) + n
        for key, n in r0["kvb"].items():
            qs, ks, dname, heads, legacy = json.loads(key)
            if dname == "torch.float32":
                k_ = (tuple(qs), tuple(ks), heads, legacy)
                seen["attention_kv_bwd"][k_] = seen["attention_kv_bwd"].get(k_, 0) + n
        grids = "" if g_err is None else f", grids {g_err} levels (tol {MD_GRID_TOL})"
        phase(f"  (e) {labels[c]} ({MD_STEPS} + {MD_STEPS} steps, f32) on {card}: Δ leaves max "
              f"|a - b| {d_err:.3e} against one process (tol {MD_DELTA_TOL:g}){grids}; training "
              f"launches over the ranks {counts}; rank 0: {r0['train_steps']} training "
              f"timesteps with {n_coll / steps:.0f} collectives each ({n_bytes / steps / 1e6:.2f} "
              f"MB, {coll_ms / steps:.1f} ms per timestep, synchronized around each: gloo "
              f"through the host, ranks sharing one card, not multi-GPU scaling); CLI run "
              f"{r0['wall_s']:.1f} s vs {res_e_none[0][i]['wall_s']:.1f} s in one process")
        i += n_runs
    if worst_d > MD_DELTA_TOL or worst_g > MD_GRID_TOL:
        fail(f"phase 15 (e): spatial training differs from one process: Δ {worst_d:.3e}, "
             f"grids {worst_g}")

    # (f): --lpips, --run_fidelity and --diff_style under --dp 2 --tp_spatial
    g_err = grids_diff(grid_arrays(ws_f["spatial"]), grid_arrays(ws_f["none"]), "phase 15 (f)")
    curve_err = 0.0
    for kind in LPIPS_KINDS:
        name = f"celeba_LPIPS_distance_{kind}.tsv"
        a, b = (load_lpips_tsv(os.path.join(ws_f[k], "utils", name)) for k in ("none", "spatial"))
        if list(a) != list(b) or not a:
            fail(f"phase 15 (f): {name} keys {list(a)} vs {list(b)}")
        curve_err = max(curve_err, max(abs(a[t] - b[t]) for t in a))
    counts = [{k_: sum(r[j]["counts"][k_] for r in res_f) for k_ in res_f[0][j]["counts"]}
              for j in range(3)]
    for c_, what in zip(counts, ("--lpips", "--run_fidelity", "--diff_style")):
        if not all(c_[k_] for k_ in MD_KERNELS) or any(c_[k_] for k_ in MD_ONE_RANK):
            fail(f"phase 15 (f) {what}: launches {c_} (the across-ranks entries must launch, "
                 "the one-rank ones never)")
    out["f"] = {"image_max_levels": g_err, "lpips_curve_max_abs_err": curve_err,
                "launches": counts, "wall_s": [r["wall_s"] for r in res_f[0]],
                "single_process_wall_s": [r["wall_s"] for r in res_f_none[0]]}
    phase(f"  (f) --lpips ({MD_STEPS} steps, 2 images), --run_fidelity and --diff_style under "
          f"--dp 2 --tp_spatial on {card}, against one process: images {g_err} levels (tol "
          f"{MD_GRID_TOL}), LPIPS curves max |a - b| {curve_err:.3e} (tol {MD_LPIPS_TOL:g}); "
          f"launches over the ranks {counts}; walls {out['f']['wall_s']} s vs "
          f"{out['f']['single_process_wall_s']} s in one process")
    if g_err > MD_GRID_TOL or curve_err > MD_LPIPS_TOL:
        fail(f"phase 15 (f): differs from one process: images {g_err}, curves {curve_err:.3e}")
    out["seconds"] = time.perf_counter() - t_phase
    phase(f"  phase 15 (e)-(f) took {out['seconds']:.1f} s")
    return out, seen


def md_bwd_rows(torch, dev, seen):
    """Phase 15 (d), the backward entries: K1-bwd across ranks (the part
    sums, then dx from the combined sums) and K2-bwd with Tq != Tk against
    their plain versions at every shape (e) gave them on rank 0: float32
    within 1e-4 of scale (the gradients also against `torch.autograd.grad`
    through the plain forward and, K2-bwd, against SDPA's backward at the
    same Tq / Tk); bfloat16 no farther from the float32 plain versions on
    the float32 inputs than 2x the plain versions in bfloat16;
    two calls bit for bit; CUDA-event and device times, SDPA's backward at
    the same Tq / Tk (K2), the bound. Per row and per run (rank 0's calls)."""
    import torch.nn.functional as F

    from asyrp_official_torch.ops import attention as k2, groupnorm as k1

    def k1_bwd_across(key, dtype, randn, inputs):
        es = torch.tensor([], dtype=dtype).element_size()
        shape, silu, eps = key
        if key not in inputs:
            inputs[key] = (randn(*shape) * 3 + 4, randn(*shape), 1 + 0.1 * randn(shape[1]),
                           0.1 * randn(shape[1]))
        x32, dy32, w, b = inputs[key]

        def make(x, dy):
            # this block as one of 4 ranks' (the other parts, and sums, as its own)
            parts = k1.group_norm_part_stats_plain(x)
            mean, rstd = k1.combine_group_stats(parts.expand(4, *parts.shape), eps)
            count = 4 * x[0, : x.shape[1] // 32].numel()

            def run(part, apply, summed):
                sums, wsum = part(x, dy, w, b, mean, rstd, silu=silu)
                return sums, wsum, apply(x, dy, w, b, mean, rstd, summed, count, silu=silu)

            # the all-reduce's result made once: a call is the two kernels
            summed_k = 4 * k1.group_norm_bwd_part(x, dy, w, b, mean, rstd, silu=silu)[0]
            summed_p = 4 * k1.group_norm_bwd_part_plain(x, dy, w, b, mean, rstd, silu=silu)[0]

            return (lambda: run(k1.group_norm_bwd_part, k1.group_norm_bwd_apply, summed_k),
                    lambda: run(k1.group_norm_bwd_part_plain, k1.group_norm_bwd_apply_plain,
                                summed_p))

        run_k, run_p = make(x32.to(dtype), dy32.to(dtype))
        n, bsz, c = x32.numel(), shape[0], shape[1]
        # the function's own traffic, as the one-rank K1-bwd row counts it: x
        # and dy read and dx written once; the weight and bias read and wsum
        # [B, 2, C] written; mean and rstd read, the [B, G, 2] sums written
        # and read back (the two-pass design reads x and dy twice: 5n)
        return dict(run_k=run_k, run_p=run_p, got=run_k(), want=run_p(),
                    ref=make(x32, dy32)[1]() if dtype != torch.float32 else None,
                    bound=bound(3 * n * es + (2 + 2 * bsz) * c * 4 + 6 * bsz * 32 * 4,
                                n * (17 + 10 * silu), PEAK_FLOPS["float32"]),
                    label=f"{list(shape)} silu={int(silu)} eps={eps:g}", bitwise=True)

    def k2_kv_bwd(key, dtype, randn, inputs):
        es = torch.tensor([], dtype=dtype).element_size()
        dname = str(dtype).split(".")[-1]
        qs, ks, heads, legacy = key
        if key not in inputs:
            inputs[key] = (randn(*qs), randn(*ks), randn(*ks), randn(*qs))
        q32, k32, v32, do32 = inputs[key]
        kw = dict(num_heads=heads, legacy_scale=legacy)
        q, kk, v, d_o = (t.to(dtype) for t in (q32, k32, v32, do32))
        o, lse = k2._plain_with_lse(q, kk, v, heads, legacy)
        run_k = lambda: k2.attention_backward(q, kk, v, o, d_o, lse, **kw)
        run_p = lambda: k2.attention_backward_plain(q, kk, v, o, d_o, lse, **kw)
        ref = None
        if dtype != torch.float32:
            o32, lse32 = k2._plain_with_lse(q32, k32, v32, heads, legacy)
            ref = k2.attention_backward_plain(q32, k32, v32, o32, do32, lse32, **kw)
        bsz, tq, c = qs
        tk, hd = ks[1], c // heads
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, kk, v))
        q4, k4, v4 = (a.view(bsz, a.shape[1], heads, hd).transpose(1, 2) for a in (qg, kg, vg))
        do4 = d_o.view(bsz, tq, heads, hd).transpose(1, 2)
        o_lib = F.scaled_dot_product_attention(q4, k4, v4, scale=hd ** -0.5)
        lib = lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do4, retain_graph=True)
        label = f"q {list(qs)} k {list(ks)} heads={heads} legacy_scale={int(legacy)}"
        got, want, note = run_k(), run_p(), ""
        if dtype == torch.float32:
            # the gradients through autograd, against the plain forward's
            qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, kk, v))
            got_a = torch.autograd.grad(k2.attention(qa, ka, va, **kw), (qa, ka, va), d_o)
            want_a = torch.autograd.grad(k2.attention_plain(qa, ka, va, **kw), (qa, ka, va), d_o)
            got, want = tuple(got) + tuple(got_a), tuple(want) + tuple(want_a)
            # and against SDPA's backward at the same Tq / Tk (the same
            # function: d^-0.5 on the logits of the unscaled q and k)
            sdpa_err = max(errs(g_.float(), w_.float())[1] for g_, w_ in zip(got_a, lib()))
            note = f"; vs SDPA's backward {sdpa_err:.3e}"
            if sdpa_err > TOL["attention_kv_bwd"][dname]:
                fail(f"attention_kv_bwd {label}: the gradients differ from SDPA's backward by "
                     f"{sdpa_err:.3e}")
        return dict(run_k=run_k, run_p=run_p, lib=lib, got=got, want=want, ref=ref,
                    bound=bound(4 * bsz * (tq + tk) * c * es + 8 * bsz * heads * tq,
                                10 * bsz * tq * tk * c, PEAK_FLOPS[dname]),
                    label=label, note=note, bitwise=True)

    return md_row_table(torch, dev, seen, {"group_norm_bwd_across": k1_bwd_across,
                                           "attention_kv_bwd": k2_kv_bwd},
                        seed=16, per="run", lib_name="SDPA backward")


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
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name]["smem"] = int(smem.group(1)) if smem else 0
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


_STEP_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16"}
_STEP_RE = re.compile(r"(ddim_fwd_rows|ddpm_fwd_rows|ddim_fwd|ddim_bwd|ddpm_fwd)I"
                      r"(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)(?:Li(\d)E)?")


def step_entries():
    """Phase 2's lines for `csrc/steps.cu`: per entry (kernel, carry and
    model-output dtypes, instance) its registers, static shared memory and
    spills; fails on a spill. Returns {label: ptxas info}."""
    from asyrp_official_torch.ops import _build

    out = {}
    for fn, info in sorted(_ptxas_by_entry(_build.build_log("steps")).items()):
        m = _STEP_RE.search(fn)
        if not m:
            continue
        tx = _STEP_TYPES[m.group(2)]
        te = tx if m.group(3).startswith("S") else _STEP_TYPES[m.group(3)]
        kernel, mode = m.group(1), m.group(4)
        instance = "rows" if mode is None else INSTANCES[int(mode)]
        label = f"{kernel.replace('_rows', '')} {tx} carry, {te} eps, {instance}"
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", info.get("spills", ""))]
        out[label] = {"registers": info.get("registers"), "smem": info.get("smem"),
                      "spill_bytes": sum(spills)}
        phase(f"  {label}: {info.get('registers')} registers, {info.get('smem')} bytes static "
              f"shared memory; {info.get('spills')}")
        if not spills or sum(spills):
            fail(f"steps.cu entry {label} spills (or ptxas gave no spill line): "
                 f"{info.get('spills')}")
    if len(out) != 32:  # K3 and the DDPM step: 2 x 2 dtypes x 3 instances; K3-bwd: 2 x 2 x 2
        fail(f"expected 32 steps.cu entries in the ptxas log, found {sorted(out)}")
    return out


def build_kernels():
    """Phase 2: nvcc for every source at once; per step entry its ptxas
    line (`step_entries`); then, per attention entry (forward `attn_fwd`,
    backward `attn_bwd`, in f32 and bf16), its tensor-core instructions
    (HGMMA from wgmma, HMMA from mma.sync) with its registers and spills.
    Fails if a bf16 entry has no HGMMA or an f32 entry no HMMA (3xTF32 on
    mma.sync). Returns {entry label: counts}."""
    from asyrp_official_torch.ops import _build

    t0 = time.perf_counter()
    names = ("groupnorm", "attention", "steps")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:  # nvcc runs in parallel
        for f in [pool.submit(_build.load_library, n) for n in names]:
            f.result()
    for name in names:
        if name == "steps":  # 32 entries: one line each below
            phase("phase 2: built csrc/steps.cu for sm_90a")
            continue
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        phase(f"phase 2: built csrc/{name}.cu for sm_90a; ptxas: {' | '.join(ptxas)}")
    phase(f"phase 2: nvcc builds took {time.perf_counter() - t0:.1f} s")
    step_entries()
    for fn, info in sorted(_ptxas_by_entry(_build.build_log("groupnorm")).items()):
        m = re.search(r"(gn_fwd|gn_bwd)I(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E", fn)
        if m:
            dname = "bfloat16" if m.group(2) != "f" else "float32"
            phase(f"  K1 {m.group(1)} {dname}, {m.group(3)} per vector, {m.group(4)} threads: "
                  f"{info.get('registers')} "
                  f"registers, {info.get('smem')} bytes static shared memory (+ the slice, "
                  f"dynamic); {info.get('spills')}; cluster of 1-16 blocks chosen per call "
                  f"(phase 3 rows)")
        m = re.search(r"(gn_fwd_nhwc_\w+?)I(13__nv_bfloat16|f)Li(\d+)E(?:Lb(\d)ELb(\d)E)?", fn)
        if m:
            dname = "bfloat16" if m.group(2) != "f" else "float32"
            epi = "" if m.group(4) is None else f", pre-add {m.group(4)}, FiLM {m.group(5)}"
            phase(f"  K1 channels-last {m.group(1)} {dname}, {m.group(3)} per vector{epi}, 256 "
                  f"threads: {info.get('registers')} registers, {info.get('smem')} bytes static "
                  f"shared memory; {info.get('spills')}")
            spilled = re.search(r"(\d+) bytes spill stores", info.get("spills") or "")
            if spilled and int(spilled.group(1)):
                fail(f"K1 channels-last {m.group(1)} {dname} spills: {info.get('spills')}")
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

    phase(f"phase 3: kernels against their plain versions (ms = median of {ROW_RUNS} CUDA-event "
          "runs)")
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
    seen_imagenet = record_imagenet_shapes(torch, dev)
    phase("  one edited IMAGENET UNet eval at batch 1: "
          f"{sum(seen_imagenet['group_norm_imagenet'].values())} group_norm calls over "
          f"{len(seen_imagenet['group_norm_imagenet'])} shapes, "
          f"{sum(seen_imagenet['attention_mh_imagenet'].values())} multi-head attention calls "
          "(plus the classifier's attention pool at batch 1 and 8, x0); one IMAGENET "
          f"training-mode eval: {seen_imagenet['train_group_norm_imagenet']} group_norm calls "
          f"({sum(seen_imagenet['group_norm_bwd_imagenet'].values())} with a gradient, over "
          f"{len(seen_imagenet['group_norm_bwd_imagenet'])} shapes), "
          f"{seen_imagenet['train_attention_mh_imagenet']} multi-head attention calls "
          f"({sum(seen_imagenet['attention_bwd_mh_imagenet'].values())} with a gradient)")
    rows = kernel_rows(torch, dev, {**seen, **seen_afhq, **seen_imagenet})
    seen_nhwc = record_nhwc_shapes(torch, dev)
    phase(f"  one edited AFHQ UNet eval at batch 16 on the bf16 channels-last route: "
          f"{sum(seen_nhwc.values())} group_norm calls over {len(seen_nhwc)} shapes, every one "
          "channels-last")
    nhwc = nhwc_rows(torch, dev, seen_nhwc)
    seen_base = record_base_train_shapes(torch)
    phase("  one base-training step (every parameter trained, batch 2, t = 750 and 250): "
          + "; ".join(f"{name} {sum(v.values())} calls over {len(v)} shapes"
                      for name, v in seen_base.items()))
    base_rows = base_train_rows(torch, dev, seen_base)

    os.makedirs(ws_root)
    log = _RunnerLog()
    from asyrp_official_torch.losses.clip_model import CLIP, VIT_B16

    # the random CLIP weights the training phases share
    clip_ckpt = os.path.join(ws_root, "clip_vit_b16_random.pt")
    torch.save(CLIP(VIT_B16, seed=SEED).state_dict(), clip_ckpt)
    logging.getLogger("asyrp_official_torch.runner").addHandler(log)
    logging.getLogger("asyrp_official_torch.pipelines.lpips_stage").addHandler(log)
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
        afhq_timings, afhq_launches = openai_phase(torch, card, log, "afhq", afhq_root,
                                                   model_path, AFHQ_RUNS)
        ws = os.path.join(afhq_root, "float32")
        phase("  the float32 AFHQ serving chain, kernels vs plain versions:")
        afhq_chain_err, afhq_chain_ms, afhq_per_request, afhq_served = chain_phase(
            torch, dev, card, ws, openai_argv("afhq", ws, model_path), AFHQ_CONFIG,
            "afhq_delta.pth",
            f"AFHQ_test_t999_nim2_ninv{STEPS}_pairs.npz", eps_check=True)
        phase("  where the time goes in one AFHQ UNet eval at batch 1 (torch.profiler):")
        afhq_profile = profile_phase(torch, dev, card, afhq_served)
        del afhq_served
        torch.cuda.empty_cache()
        phase("phase 9: OpenAI-family training through the port's CLI (--run_train "
              f"--train_delta_block, CLIP directional loss, {AFHQ_ATTR}, afhq.yml 256^2, the "
              "perturbed AFHQ .pt)")
        write_images(os.path.join(os.environ["ASYRP_TPU_DATA"], "afhq", "train"), sub="dog")
        afhq_training, afhq_train_launches = openai_train_phase(
            torch, card, log, "afhq", afhq_root, model_path, clip_ckpt)
        torch.cuda.empty_cache()
        phase("phase 10: the h-rows path (--train_delta_h) and the multi-edit serving modes "
              "through the port's CLI (custom.yml 256^2)")
        rows_multi = rows_phase(torch, card, log, ws_root, clip_ckpt)
        torch.cuda.empty_cache()
        phase("phase 11: the LPIPS calibration stage (--lpips), ID-loss training (--id_loss_w) "
              "and the fidelity runbook (--run_fidelity) through the port's CLI (custom.yml "
              "256^2)")
        m7 = m7_phase(torch, card, log, ws_root, clip_ckpt)
        torch.cuda.empty_cache()
        phase("phase 12: IMAGENET through the port's CLI (imagenet.yml, ADM 256^2, 553.8M "
              "params, --target_class_num; a perturbed .pt without label_emb) and the ADM 256^2 "
              "classifier")
        imagenet = imagenet_phase(torch, dev, card, log, ws_root, clip_ckpt)
        torch.cuda.empty_cache()
        phase("phase 13: DiffStyle through the port's CLI (--diff_style, custom.yml 256^2), the "
              "image-noise engine's gradient, the global and interp_batch edit modes, the RN50 "
              "tower and the CLIP terms")
        style = style_phase(torch, dev, card, ws_root)
        torch.cuda.empty_cache()
        phase("phase 14: base training of the full-width UNets (custom.yml, afhq.yml), the "
              "train-state sidecar, respaced sampling, the serving export, ResNet-18 and the "
              "shape report")
        base = base_phase(torch, dev, card, ws_root)
        torch.cuda.empty_cache()
        phase("phase 15: multi-device through the port's CLI (parallel/: --dp, --tp_spatial, "
              "--sp), rank processes on the one card")
        md, md_seen = multi_device_phase(torch, dev, card, ws_root, clip_ckpt, model_path,
                                         os.path.join(afhq_root, "afhq_delta.pth"))
        phase(f"  (d) K1 across ranks and K2 with Tq != Tk against their plain versions at the "
              f"shapes of (c) (ms = median of {ROW_RUNS} CUDA-event runs)")
        md_kernel_rows = md_rows(torch, dev, md_seen)
        phase("  (e) Δ-training under spatial sharding (four gloo ranks) and (f) --lpips, "
              "--run_fidelity and --diff_style under --dp 2 --tp_spatial, against one process")
        md_train, md_bwd_seen = md_train_phase(torch, card, ws_root, clip_ckpt, model_path)
        phase(f"  (d) K1-bwd across ranks and K2-bwd with Tq != Tk against their plain versions "
              f"at the shapes of (e) (ms = median of {ROW_RUNS} CUDA-event runs)")
        md_kernel_rows.update(md_bwd_rows(torch, dev, md_bwd_seen))
        md["train"] = md_train
    finally:
        shutil.rmtree(ws_root, ignore_errors=True)

    runs = {"custom.yml serving float32": serve_launches,
            "custom.yml training float32": train_launches,
            **{f"afhq.yml serving {k}": v for k, v in afhq_launches.items()},
            "afhq.yml training float32": afhq_train_launches,
            **{f"custom.yml {k}": v for k, v in rows_multi["launches"].items()},
            **{f"custom.yml {k}": v for k, v in m7["launches"].items()},
            **{f"imagenet.yml serving {k}": v for k, v in imagenet["launches"].items()},
            "imagenet.yml training float32": imagenet["train_launches"],
            "custom.yml --diff_style float32": style["runs"]["float32"]["launches"],
            "custom.yml image-noise gradient float32": style["image_noise"]["launches"],
            **{f"{k} base training": v["launches"] for k, v in base["runs"].items()},
            "custom.yml exported invert -> edit float32": base["export"]["launches"]}
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
        "ddim_step": ("cuda", "asyrp_official_torch/csrc/steps.cu",
                      "asyrp_official_tpu/core/ddim.py:33 (ddim_step; XLA on the TPU)",
                      "ddim_step", serve_launches),
        "ddim_step_bwd": ("cuda", "asyrp_official_torch/csrc/steps.cu",
                          "asyrp_official_tpu/core/ddim.py:33 (the gradient XLA derives for "
                          "ddim_step in the edited training step, pipelines/train.py:186-190)",
                          "ddim_step_bwd", train_launches),
        "group_norm_afhq": ("cuda", "asyrp_official_torch/csrc/groupnorm.cu",
                            gn_ref[:-1] + "; eps 1e-5, and group_norm_1d at models/common.py:170 "
                            "for the attention norms)", "group_norm", afhq_f32),
        "attention_mh": ("cuda", "asyrp_official_torch/csrc/attention.cu",
                         attn_ref[:-1] + " with num_heads=8, legacy_scale=True, called from "
                         "models/openai_unet.py:286)", "attention_mh", afhq_f32),
        "ddim_step_learn_sigma": ("cuda", "asyrp_official_torch/csrc/steps.cu",
                                  "asyrp_official_tpu/core/ddim.py:33 (ddim_step on the learn_sigma "
                                  "split of core/sampler.py:115-122; XLA on the TPU)", "ddim_step",
                                  afhq_f32),
        "ddpm_step": ("cuda", "asyrp_official_torch/csrc/steps.cu",
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
        "group_norm_imagenet": ("cuda", "asyrp_official_torch/csrc/groupnorm.cu",
                                gn_ref[:-1] + "; eps 1e-5 at imagenet.yml's shapes, and "
                                "group_norm_1d at models/common.py:170 for the attention norms)",
                                "group_norm", imagenet["launches"]["float32"]),
        "attention_mh_imagenet": ("cuda", "asyrp_official_torch/csrc/attention.cu",
                                  attn_ref[:-1] + " with 8 heads of 64 at 32^2 and 16 at 16^2 "
                                  "and 8^2, legacy_scale=True, called from "
                                  "models/openai_unet.py:286; the classifier's pool from "
                                  "models/encoder_unet.py:136)", "attention_mh",
                                  imagenet["launches"]["float32"]),
        "group_norm_bwd_imagenet": ("cuda", "asyrp_official_torch/csrc/groupnorm.cu",
                                    "asyrp_official_tpu/models/common.py:147 (group_norm's "
                                    "gradient at eps 1e-5, imagenet.yml's decoder shapes; former "
                                    "jax.custom_vjp ops/groupnorm.py:105-127 at 4b63bc3^)",
                                    "group_norm_bwd", imagenet["train_launches"]),
        "attention_bwd_mh_imagenet": ("cuda", "asyrp_official_torch/csrc/attention.cu",
                                      "asyrp_official_tpu/models/common.py:238 (the gradient XLA "
                                      "derives for spatial_attention with 8 and 16 heads of 64, "
                                      "legacy_scale=True, called from "
                                      "models/openai_unet.py:286)", "attention_mh_bwd",
                                      imagenet["train_launches"]),
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
            # calls per UNet eval as phase 3 recorded them; a step kernel
            # runs once per sampler step, not per eval: null
            "calls_per_eval": f32.get("calls"),
            "by_dtype": {d: {k: v[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "device_ms", "plain_device_ms",
                                               "l2_device_ms", "library_device_ms", "library_profiled_ms",
                                               "profiled_ms")
                             if k in v} for d, v in r.items()},
        })
    md_runs = md["c"]["runs"]
    md_train_runs = md["train"]["e"]
    for name, replaces, counter in (
            ("group_norm_across", "asyrp_official_tpu/models/common.py:147 (group_norm on "
             "activations GSPMD splits by rows, parallel/spatial.py:42 spatial_shard and :65 "
             "batch_spatial_shard; former Pallas ops/groupnorm.py:80 at 4b63bc3^): gn_part + "
             "gn_apply", "group_norm_apply"),
            ("attention_kv", "asyrp_official_tpu/models/common.py:238 (spatial_attention on "
             "activations GSPMD splits by rows, parallel/spatial.py:42 and :65: a rank's query "
             "rows against the whole image's keys)", "attention_kv"),
            ("group_norm_bwd_across", "asyrp_official_tpu/models/common.py:147 (group_norm's "
             "gradient on activations GSPMD splits by rows in Δ-training, parallel/spatial.py:42 "
             "and :65; former jax.custom_vjp ops/groupnorm.py:105-127 at 4b63bc3^): gn_bwd_part "
             "+ gn_bwd_apply", "group_norm_bwd_apply"),
            ("attention_kv_bwd", "asyrp_official_tpu/models/common.py:238 (spatial_attention's "
             "gradient on activations GSPMD splits by rows in Δ-training: a rank's query rows "
             "against the whole image's keys; former jax.custom_vjp ops/attention.py:98-125 at "
             "4b63bc3^)", "attention_kv_bwd")):
        r = md_kernel_rows[name]
        f32 = r["float32"]
        runs_ = md_train_runs if name.endswith("_bwd_across") or name.endswith("_kv_bwd") \
            else md_runs
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("asyrp_official_torch/csrc/groupnorm.cu" if name.startswith("group_norm")
                       else "asyrp_official_torch/csrc/attention.cu"),
            "replaces": replaces,
            "launches": sum(v["launches"][counter] for v in runs_.values()),
            "launches_by_run": {k: v["launches"][counter] for k, v in runs_.items()},
            "max_abs_err": max(v["max_abs_err"] for v in r.values()),
            "max_rel_err_by_dtype": {d: v["max_rel_err"] for d, v in r.items()},
            "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "calls_per_request": f32["calls"],
            "by_dtype": {d: {k: v[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "device_ms", "plain_device_ms",
                                               "library_device_ms") if k in v}
                         for d, v in r.items()},
        })
    summary = {"card": card, "attention_sass": sass, "step_rows": rows["step_rows"],
               "group_norm_nhwc": {"per_eval": nhwc[0], "rows": nhwc[1]},
               "serving": timings,
               "invert_edit_chain_ms": chain_ms,
               "chain_rel_err": chain_err, "launches_per_invert_edit_chain": per_request,
               "profile": profile, "training": training,
               "afhq": {"serving": afhq_timings, "launches": afhq_launches,
                        "invert_edit_chain_ms": afhq_chain_ms,
                        "chain_rel_err": afhq_chain_err,
                        "launches_per_invert_edit_chain": afhq_per_request,
                        "profile": afhq_profile, "training": afhq_training},
               "rows_and_multi_edit": rows_multi, "lpips_id_fidelity": m7, "imagenet": imagenet,
               "style_and_library_modes": style, "base_training_rows": base_rows,
               "base_training_and_library": base, "multi_device": md,
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
