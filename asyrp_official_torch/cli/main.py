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

`--run_train` / `--just_precompute` and `--run_test` are ported; the other
modes raise NotImplementedError. Like the JAX CLI, every failure after
argument parsing is logged and returns 1.
"""
from __future__ import annotations

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

_UNPORTED_MODES = ("lpips", "run_fidelity", "diff_style")


def build_parser():
    p = _reference_parser()
    p.description = "Asyrp on PyTorch/CUDA"
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run: cuda (the hand-written kernels) or cpu "
                        "(their plain PyTorch versions)")
    return p


def build_contexts(args, device: torch.device):
    """The CLIP context of `--clip_ckpt` (an OpenAI ViT state dict or
    TorchScript archive), frozen, on `device`; None without the flag."""
    if not args.clip_ckpt:
        return None
    from asyrp_official_torch.compat.delta_ckpt import load_state_dict_numpy
    from asyrp_official_torch.losses import clip_model
    from asyrp_official_torch.losses.clip_loss import CLIPContext

    model = clip_model.from_state_dict(load_state_dict_numpy(args.clip_ckpt))
    model = model.to(device).eval().requires_grad_(False)
    return CLIPContext(model, model.cfg)


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
        for flag in ("align_face", "ir_se50_ckpt", "lpips_ckpt", "trace_dir"):
            if getattr(args, flag, None):
                raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP.md Queue 1)")
        for mode in _UNPORTED_MODES:
            if getattr(args, mode, False):
                raise NotImplementedError(f"--{mode} is not ported yet (ROADMAP.md Queue 1)")
        if not (args.run_train or args.just_precompute or args.run_test):
            print("nothing to do: pass --run_train / --run_test")
            return 1

        from asyrp_official_torch.runner import AsyrpRunner, resolve_device

        clip_ctx = build_contexts(args, resolve_device(args.device))
        runner = AsyrpRunner(args, config, clip_ctx=clip_ctx, work_dir=args.work_dir)
        if args.run_train or args.just_precompute:
            runner.run_training()
        else:
            runner.run_test()
    except Exception:
        logging.exception("run failed")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
