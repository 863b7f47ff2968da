"""CLI of the port: the reference flag surface (`cli/args.build_parser`)
plus `--device` (default `cuda`), driving the port's AsyrpRunner.

    # Δ-training of a DeltaBlock with the CLIP directional loss
    python -m asyrp_official_torch.cli.main --run_train --train_delta_block \
        --config custom.yml --exp ./runs/smiling --edit_attr smiling --device cuda \
        --model_path pretrained/celeba_hq.ckpt --clip_ckpt pretrained/ViT-B-16.pt \
        --clip_loss_w 1 --l1_loss_w 3 --get_h_num 1 --n_inv_step 40 --n_train_step 40 \
        --n_iter 2 --n_train_img 2 --bs_train 1 --lr_training 0.5 \
        --user_defined_t_edit 513 --user_defined_t_addnoise 167 --do_test 1 --ni

    # edit serving with a trained block
    python -m asyrp_official_torch.cli.main --run_test --train_delta_block \
        --config custom.yml --exp ./runs/smiling --device cuda \
        --model_path pretrained/celeba_hq.ckpt \
        --manual_checkpoint_name smiling_LC_CelebA_HQ_t999_ninv40_ngen40_0.pth \
        --n_inv_step 40 --n_test_step 40 \
        --user_defined_t_edit 513 --user_defined_t_addnoise 167 --ni

    # the LPIPS calibration stage: the four per-timestep tsvs in {work_dir}/utils/
    python -m asyrp_official_torch.cli.main --lpips --config custom.yml \
        --exp ./runs/calib --device cuda --model_path pretrained/celeba_hq.ckpt \
        --lpips_ckpt pretrained/lpips_alex.npz --custom_train_dataset_dir ./imgs \
        --n_inv_step 1000 --n_train_img 100 --bs_train 1

    # the fidelity runbook: invert→edit the test images, LPIPS against the
    # reference's outputs of the same names
    python -m asyrp_official_torch.cli.main --run_fidelity --train_delta_block \
        --config custom.yml --exp ./runs/smiling --device cuda \
        --model_path pretrained/celeba_hq.ckpt --manual_checkpoint_name smiling.pth \
        --fidelity_ref_dir ./ref_outputs --lpips_ckpt pretrained/lpips_alex.npz \
        --n_inv_step 40 --n_test_step 40 --user_defined_t_edit 513 \
        --user_defined_t_addnoise 167 --ni

    # DiffStyle: every content image stylized by every style image
    python -m asyrp_official_torch.cli.main --diff_style --config custom.yml \
        --exp ./runs/style --device cuda --model_path pretrained/celeba_hq.ckpt \
        --content_dir ./contents --style_dir ./styles --save_dir ./styled \
        --n_inv_step 40 --n_gen_step 40 --user_defined_t_edit 513 \
        --user_defined_t_addnoise 167 --hs_coeff 0.9 --ni

Every mode of the JAX CLI is ported: `--run_train` / `--just_precompute`
(with the ID term: `--id_loss_w` and `--ir_se50_ckpt`), `--run_test`,
`--lpips`, `--run_fidelity` and `--diff_style`, dispatched in that order of
precedence, with `--align_face` and `--trace_dir`. Like the JAX CLI, every
failure after argument parsing is logged and returns 1.
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import random
import shutil
import sys

import numpy as np
import torch

from asyrp_official_torch.cli.args import build_parser as _reference_parser
from asyrp_official_torch.cli.args import load_config

__all__ = ["build_parser", "build_contexts", "load_config", "main"]


def build_parser():
    p = _reference_parser()
    p.description = "Asyrp on PyTorch/CUDA"
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run: cuda (the hand-written kernels) or cpu "
                        "(their plain PyTorch versions)")
    return p


def build_contexts(args, device: torch.device):
    """The optional loss networks, frozen, on `device`, from user-supplied
    weights (None for a flag not given): the CLIP context of `--clip_ckpt`
    (an OpenAI ViT state dict or TorchScript archive), IR-SE50 from
    `--ir_se50_ckpt` (the reference's `ir_se50.pth`, a strict load) and
    LPIPS from `--lpips_ckpt` (an npz whose 'params' entry holds the JAX
    tree of `losses.lpips.params_from_torch`).
    Returns (clip_ctx, id_net, lpips_net)."""
    from asyrp_official_torch.compat.delta_ckpt import load_state_dict_numpy

    clip_ctx = id_net = lpips_net = None
    if args.clip_ckpt:
        from asyrp_official_torch.losses import clip_model
        from asyrp_official_torch.losses.clip_loss import CLIPContext

        model = clip_model.from_state_dict(load_state_dict_numpy(args.clip_ckpt))
        model = model.to(device).eval().requires_grad_(False)
        clip_ctx = CLIPContext(model, model.cfg)
    if args.ir_se50_ckpt:
        from asyrp_official_torch.losses.id_loss import IRSE50

        id_net = IRSE50()  # frozen, in inference mode
        id_net.load_state_dict({k: torch.as_tensor(v) for k, v in
                                load_state_dict_numpy(args.ir_se50_ckpt).items()})
        id_net = id_net.to(device)
    if args.lpips_ckpt:
        from asyrp_official_torch.compat.from_jax import lpips_state_dict_from_jax
        from asyrp_official_torch.losses.lpips import LPIPS

        blob = np.load(args.lpips_ckpt, allow_pickle=True)
        if "params" not in blob:
            raise ValueError(
                f"--lpips_ckpt {args.lpips_ckpt}: expected an npz with a 'params' entry "
                f"(np.savez(path, params=np.array(tree, dtype=object))); found keys "
                f"{list(blob.files)} — convert torch lpips weights via "
                "losses.lpips.params_from_torch")
        lpips_net = LPIPS()
        lpips_net.load_state_dict(lpips_state_dict_from_jax(blob["params"].item()))
        lpips_net = lpips_net.to(device).eval().requires_grad_(False)
    return clip_ctx, id_net, lpips_net


def align_dataset_dirs(args) -> None:
    """--align_face: FFHQ-align every image of the custom dataset dirs into
    `{work_dir}/aligned/...` and point the args there, so every later stage
    reads aligned faces (the reference ships `run_alignment` but never calls
    it). Needs dlib and its shape predictor (`utils/align.py`)."""
    from asyrp_official_torch.utils.align import run_alignment

    exts = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
    done = {}
    for attr in ("custom_train_dataset_dir", "custom_test_dataset_dir"):
        src = getattr(args, attr, None)
        if not src or not os.path.isdir(src):
            continue
        key = os.path.abspath(src)
        if key in done:  # train dir == test dir: align once
            setattr(args, attr, done[key])
            continue
        tag = hashlib.sha1(key.encode()).hexdigest()[:8]
        dst = os.path.join(args.work_dir or ".", "aligned",
                           f"{os.path.basename(os.path.normpath(src))}_{tag}")
        os.makedirs(dst, exist_ok=True)
        n = 0
        for name in sorted(os.listdir(src)):
            if not name.lower().endswith(exts):
                continue
            out = os.path.join(dst, name)
            if not os.path.exists(out):  # idempotent across runs
                run_alignment(os.path.join(src, name)).save(out)
            n += 1
        logging.info("--align_face: %d aligned images: %s -> %s", n, src, dst)
        done[key] = dst
        setattr(args, attr, dst)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.verbose.upper(), logging.INFO),
        format="%(levelname)s - %(filename)s - %(asctime)s - %(message)s",
    )
    try:
        config = load_config(args.config)
        args.exp = (args.exp + f"_LC_{config['data']['category']}_t{args.t_0}"
                    + f"_ninv{args.n_inv_step}_ngen{args.n_train_step}")
        random.seed(args.seed)
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)
        os.makedirs(args.exp, exist_ok=True)
        if args.sh_file_name and os.path.exists(args.sh_file_name):
            mode = "test" if args.run_test else "train" if args.run_train else "run"
            base = os.path.basename(args.sh_file_name).split(".")[0]
            shutil.copy(args.sh_file_name, os.path.join(args.exp, f"{base}_{mode}.sh"))
        if not (args.run_train or args.just_precompute or args.run_test or args.lpips
                or args.run_fidelity or args.diff_style):
            print("nothing to do: pass --run_train / --run_test / --lpips / --run_fidelity / "
                  "--diff_style")
            return 1
        if getattr(args, "align_face", 0):
            align_dataset_dirs(args)

        from asyrp_official_torch.runner import AsyrpRunner, resolve_device
        from asyrp_official_torch.utils.profiling import trace

        clip_ctx, id_net, lpips_net = build_contexts(args, resolve_device(args.device))
        runner = AsyrpRunner(args, config, clip_ctx=clip_ctx, id_net=id_net,
                             lpips_net=lpips_net, work_dir=args.work_dir)
        with trace(args.trace_dir) if args.trace_dir else contextlib.nullcontext():
            if args.run_train or args.just_precompute:
                runner.run_training()
            elif args.run_test:
                runner.run_test()
            elif args.lpips:
                runner.run_lpips()
            elif args.run_fidelity:
                runner.run_fidelity()
            else:
                runner.run_style_transfer()
    except Exception:
        logging.exception("run failed")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
