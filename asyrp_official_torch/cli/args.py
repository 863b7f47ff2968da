"""The reference command line — the port's copy of `build_parser` and
`load_config` from the JAX package's `cli/main.py` (the same flags, names
and defaults, so a script written for one package runs the other).
`load_config` reads a config by path, or by name from the port's own
`configs/` copies.
"""
from __future__ import annotations

import argparse
import os

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")

VESTIGIAL_FLAGS = [
    # parsed-but-undispatched reference flags, scattered through
    # main.py:31-226 (the dispatched flags are declared separately below)
    "do_alternate", "style_transfer", "style_transfer_style_from_train_images",
    "latent_classifier", "warigari", "attr_index",
    "clip_finetune", "global_clip",
    "run_origin", "latent_at", "test_celeba_dialog", "latent_clr",
    "eval_latent_clr", "interpolation", "interpolation2", "clip_latent_optim",
    "edit_images_from_dataset", "edit_one_image", "unseen2unseen",
    "clip_finetune_eff", "edit_one_image_eff", "test_pretrained",
    "compute_distance_graph", "global_cliploss", "from_noise", "random_ddim",
    "direct_ddim", "direct_same_regardless_of_t", "step_40_to_ddpm",
    "l1_loss_with_x0", "pass_origin_and_save_real_image",
    "style_transfer_use_mean", "analysis", "run_optimize_delta_h",
    "run_test_pretrained_self_delta_h", "test_pretrained_at_once",
    "hybrid_noise",
    # incomplete reference research modes: parsed, checked in
    # run_training/save_image, but their image_space_noise_dict is
    # never populated by any reference path (diffusion_latent.py:451)
    "image_space_noise_optim", "image_space_noise_optim_delta_block",
    "image_space_noise_optim_origin", "DirectionalClipSmilarity",
    "Three_compare_addnoise", "get_SNR",
]

# accepted with the reference's value arity/defaults, but undispatched —
# declared individually in build_parser, reported by --list_vestigial
VESTIGIAL_VALUE_FLAGS = [
    "bs_test", "rambda", "LPIPS_addnoise_th", "n_test_pretrained_inv_step",
    "lr_clip_finetune", "lr_latent_clr", "lr_clip_lat_opt", "var",
    "maintain", "maintain_min", "interpolation_step",
    # truthy reference defaults — declared with them so a default-sensitive
    # script diff is byte-faithful (test_cli_defaults_parity)
    "deterministic_inv", "style_transfer_noise_from",
    "classification_results_file_name",
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Asyrp-TPU")
    add = p.add_argument

    # mode dispatch
    add("--run_train", action="store_true")
    add("--run_test", action="store_true")
    add("--lpips", action="store_true")
    add("--just_precompute", action="store_true")
    add("--diff_style", action="store_true", help="h-space style transfer")
    add("--run_fidelity", action="store_true",
        help="real-weights runbook: invert+edit test images through the "
             "fused serving engine and emit the LPIPS gate report vs "
             "--fidelity_ref_dir (fails fast listing missing artifacts)")
    add("--fidelity_ref_dir", type=str, default=None,
        help="directory of torch-reference outputs (matching file names)")

    # config / experiment
    add("--config", type=str, required=True, help="config yml name or path")
    add("--exp", type=str, default="./runs/")
    add("--comment", type=str, default="")
    add("--seed", type=int, default=1234)
    add("--verbose", type=str, default="info")
    # reference: type=int default=1 (main.py:149); nargs="?" keeps the
    # bare `--ni` form working alongside the reference's `--ni 1`
    add("--ni", nargs="?", const=1, default=1, type=int,
        help="no interaction (overwrite folders)")
    add("--sh_file_name", type=str, default="script.sh")
    add("--bf16", action="store_true", help="run the UNet in bfloat16")
    add("--remat", action="store_true",
        help="recompute the UNet's resblocks in the backward "
             "(torch.utils.checkpoint): about one extra forward of FLOPs "
             "for activation memory, so a larger --bs_train fits")
    add("--trace_dir", type=str, default=None,
        help="write a TensorBoard-loadable torch.profiler trace of the "
             "whole run, host and CUDA device with the port's own spans, to "
             "this directory as *.pt.trace.json (utils/profiling.trace)")
    add("--work_dir", type=str, default=".")

    # multi-chip (the reference's DataParallel analog, integrated in the
    # runner: batches sharded over a jax.sharding.Mesh, params replicated)
    add("--dp", type=int, default=0,
        help="data-parallel over N chips (-1 = all); bs_train must divide")
    add("--sp", type=int, default=0,
        help="spatial ways of a 2D data x spatial mesh: --dp D image "
             "groups in parallel, each image's activation height split "
             "over S chips (uses D*S devices; --dp -1/absent = all//S; "
             "image_size must divide by S, bs_train by D)")
    add("--tp_spatial", action="store_true",
        help="with --dp: shard activation HEIGHT across the chips, dividing "
             "the per-image conv work — serving AND training (the only "
             "multi-chip lever at the reference's default bs=1 recipe); "
             "image_size must divide by --dp")

    # editing target
    add("--edit_attr", type=str, default=None)
    add("--src_txts", type=str, nargs="+", default=None)
    add("--trg_txts", type=str, nargs="+", default=None)
    add("--target_class_num", type=int, default=None)

    # trajectory
    add("--t_0", type=int, default=999)
    add("--n_inv_step", type=int, default=40)
    add("--n_train_step", type=int, default=6)
    add("--n_test_step", type=int, default=40)
    add("--sample_type", type=str, default="ddim", choices=["ddim", "ddpm"])
    add("--eta", type=float, default=0.0)

    # training
    add("--train_delta_block", action="store_true")
    add("--train_delta_h", action="store_true")
    add("--delta_injection", type=str, default="add", choices=["add", "slerp"],
        help="input-delta_h injection semantics: 'add' = the paper's "
             "additive rule h2 = h*c0 + dh*c1 (preserved in the reference's "
             "forward_layer_check:633); 'slerp' = the reference's PUBLISHED "
             "main-forward branch (models/ddpm/diffusion.py:517-539), which "
             "the DiffStyle merge overwrote — note slerp is a no-op at the "
             "default hs_coeff_origin_h=1.0")
    add("--ignore_timesteps", action="store_true")
    add("--do_train", type=int, default=1)
    add("--do_test", type=int, default=1)
    add("--retrain", type=int, default=0)
    add("--n_iter", type=int, default=1)
    add("--bs_train", type=int, default=1)
    add("--bs_test", type=int, default=1)  # undispatched in the reference too (CLIP-finetune leftover, main.py:179); listed by --list_vestigial
    add("--n_precomp_img", type=int, default=100)
    add("--n_train_img", type=int, default=50)
    add("--n_test_img", type=int, default=10)
    add("--get_h_num", type=int, default=0)
    add("--lr_training", type=float, default=2e-1)
    add("--scheduler", type=int, default=1)
    add("--scheduler_step_size", type=int, default=3)
    add("--sch_gamma", type=float, default=0.1)
    add("--clip_loss_w", type=float, default=3.0)
    add("--l1_loss_w", type=float, default=0.0)
    add("--id_loss_w", type=float, default=0.0)
    add("--clr_loss_w", type=float, default=3.0)
    add("--use_id_loss", action="store_true")
    add("--clip_model_name", type=str, default="ViT-B/16")
    add("--save_train_image", nargs="?", const=1, default=1, type=int)
    add("--save_train_image_step", type=int, default=4)
    add("--save_train_image_iter", type=int, default=1)
    add("--save_checkpoint_only_last_iter", action="store_true")
    add("--save_checkpoint_during_iter", action="store_true")
    add("--save_checkpoint_step", type=int, default=200)
    add("--start_iter_when_you_use_pretrained", type=int, default=0)
    add("--shuffle_train_dataloader", action="store_true")
    add("--re_precompute", action="store_true")
    add("--use_x0_tensor", action="store_true")

    # interval
    add("--user_defined_t_edit", type=int, default=None)
    add("--user_defined_t_addnoise", type=int, default=None)
    add("--lpips_edit_th", type=float, default=0.33)
    add("--lpips_addnoise_th", type=float, default=0.1)
    add("--add_noise_from_xt", action="store_true")
    add("--origin_process_addnoise", action="store_true")

    # inference
    add("--load_random_noise", action="store_true")
    add("--saved_random_noise", action="store_true")
    add("--delta_interpolation", action="store_true")
    add("--max_delta", type=float, default=1.0)
    add("--min_delta", type=float, default=0.0)
    add("--num_delta", type=int, default=5)
    add("--hs_coeff_delta_h", type=float, default=1.0)
    add("--hs_coeff_origin_h", type=float, default=1.0)
    add("--target_image_id", type=str, default=None)
    add("--start_image_id", type=int, default=0)
    add("--save_x0", action="store_true")
    add("--save_x_origin", action="store_true")
    add("--save_process_origin", action="store_true")
    add("--save_process_delta_h", action="store_true")
    add("--save_precomputed_images", action="store_true")
    add("--num_mean_of_delta_hs", type=int, default=0)
    add("--multiple_attr", type=str, default="")
    add("--multiple_hs_coeff", type=str, default="")
    add("--masked_h", nargs="?", const=True, type=str, default="")
    add("--use_mask", action="store_true")
    add("--manual_checkpoint_name", type=str, default="")
    add("--choose_checkpoint_num", type=str, default="")
    add("--load_from_checkpoint", type=str, default=None)
    add("--pass_editing", action="store_true")
    add("--dt_lambda", type=float, default=1.0)
    add("--dt_end", type=int, default=950)
    add("--model_ratio", type=float, default=1.0)
    add("--save_grid", action="store_true")

    # DiffStyle (reference parses these, main.py:191-203; dispatched here)
    add("--content_dir", type=str, default="./source_images/content")
    add("--style_dir", type=str, default="./source_images/style")
    add("--save_dir", type=str, default="./results")
    add("--n_gen_step", type=int, default=1000)
    add("--content_replace_step", type=int, default=50)
    add("--hs_coeff", type=float, default=0.9)
    add("--t_noise", type=int, default=0)

    # paths / weights
    add("--model_path", type=str, default=None)
    add("--allow_random_weights", action="store_true",
        help="run on RANDOM base-model weights (tests/plumbing only; "
             "without this a missing --model_path is an error)")
    add("--download_weights", action="store_true",
        help="auto-download the pretrained base ckpt (registry URLs; "
             "mirrors the reference's unconditional auto-download, "
             "diffusion_latent.py:81-106)")
    add("--img_path", type=str, default=None)
    add("--align_face", type=int, nargs="?", const=1, default=0,
        help="FFHQ-align the custom dataset images (dlib 68-landmark) "
             "before any pipeline reads them. The reference parses this "
             "flag (main.py:150) but never dispatches it; here a truthy "
             "value runs utils/align.run_alignment over the custom dirs. "
             "Off by default to preserve the reference's effective "
             "behavior (it never aligns)")
    add("--custom_train_dataset_dir", type=str, default="./custom/train")
    add("--custom_test_dataset_dir", type=str, default="./custom/test")
    add("--custom_dataset_name", type=str, default="celeba")
    add("--clip_ckpt", type=str, default=None, help="OpenAI CLIP .pt/.pth")
    add("--ir_se50_ckpt", type=str, default=None, help="ArcFace weights")
    add("--lpips_ckpt", type=str, default=None, help="AlexNet+lin weights")

    # remaining reference flags: value-typed vestigial (reference defaults)
    add("--save_to_folder", type=str, default=None,
        help="override the training_images folder (main.py:292-293)")
    add("--rambda", type=float, default=1.0, help=argparse.SUPPRESS)
    add("--LPIPS_addnoise_th", type=float, default=0.1, help=argparse.SUPPRESS)
    add("--n_test_pretrained_inv_step", type=int, default=40, help=argparse.SUPPRESS)
    add("--lr_clip_finetune", type=float, default=2e-6, help=argparse.SUPPRESS)
    add("--lr_latent_clr", type=float, default=2e-6, help=argparse.SUPPRESS)
    add("--lr_clip_lat_opt", type=float, default=2e-2, help=argparse.SUPPRESS)
    add("--var", type=int, default=100, help=argparse.SUPPRESS)
    add("--maintain", type=int, default=400, help=argparse.SUPPRESS)
    add("--maintain_min", type=int, default=50, help=argparse.SUPPRESS)
    add("--interpolation_step", type=int, default=4, help=argparse.SUPPRESS)
    add("--deterministic_inv", type=int, default=1, help=argparse.SUPPRESS)
    add("--style_transfer_noise_from", type=str, default="contents",
        help=argparse.SUPPRESS)
    add("--classification_results_file_name", type=str,
        default="classification_results", help=argparse.SUPPRESS)

    # vestigial (accepted, no dispatch — reference parity)
    for flag in VESTIGIAL_FLAGS:
        add(f"--{flag}", nargs="?", const=True, default=None,
            help=argparse.SUPPRESS)
    add("--list_vestigial", action="store_true",
        help="list accepted-but-undispatched reference flags")
    return p


def load_config(name: str) -> dict:
    path = name if os.path.exists(name) else os.path.join(CONFIG_DIR, name)
    with open(path) as f:
        return yaml.safe_load(f)
