"""Tiny-model workspace scaffolding for end-to-end runs of the CLI — the
port's copy of the JAX package's `utils/tinyws.py`
(`tests/test_torch_boundary.py` holds it equal to the original): one 32x32
two-level DDPM++ config, a folder of random PNGs, and the common CLI argv
prefix."""
from __future__ import annotations

import copy
import os
from typing import List, Optional, Sequence, Tuple

TINY_DDPMPP_CONFIG = {
    "data": {"dataset": "CelebA_HQ", "category": "CUSTOM", "image_size": 32,
             "channels": 3, "num_workers": 0},
    "model": {"family": "ddpmpp", "in_channels": 3, "out_ch": 3, "ch": 32,
              "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [16],
              "dropout": 0.0, "var_type": "fixedsmall", "resamp_with_conv": True,
              "learn_sigma": False},
    "diffusion": {"beta_schedule": "linear", "beta_start": 0.0001,
                  "beta_end": 0.02, "num_diffusion_timesteps": 1000},
    "sampling": {"batch_size": 2, "last_only": True},
}


def write_tiny_workspace(
    root: str, n_images: int = 4, image_size: int = 32, seed: int = 0
) -> Tuple[str, str]:
    """Create `{root}/imgs/{i}.png` random images and `{root}/tiny.yml`.
    Returns (config_path, imgs_dir)."""
    import numpy as np
    import yaml
    from PIL import Image

    imgs = os.path.join(root, "imgs")
    os.makedirs(imgs, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n_images):
        Image.fromarray(
            (rng.rand(image_size, image_size, 3) * 255).astype(np.uint8)
        ).save(os.path.join(imgs, f"{i}.png"))
    config_path = os.path.join(root, "tiny.yml")
    with open(config_path, "w") as f:
        yaml.safe_dump(copy.deepcopy(TINY_DDPMPP_CONFIG), f)
    return config_path, imgs


def tiny_base_argv(
    config_path: str,
    imgs_dir: str,
    work_dir: str,
    exp: str,
    *,
    n_img: int = 2,
    bs_train: int = 2,
    edit_attr: Optional[str] = "smiling",
    allow_random_weights: bool = True,
    extra: Sequence[str] = (),
) -> List[str]:
    """The argv prefix every tiny end-to-end run shares: 4-step grids,
    fixed t_edit/t_addnoise, CLIP loss off (no CLIP weights in CI),
    non-interactive. Mode flags (--run_train/--run_test/...) go in
    `extra`."""
    argv = ["--config", config_path, "--exp", exp]
    if edit_attr is not None:
        argv += ["--edit_attr", edit_attr]
    argv += [
        "--custom_train_dataset_dir", imgs_dir,
        "--custom_test_dataset_dir", imgs_dir,
        "--work_dir", work_dir,
        "--n_inv_step", "4", "--n_train_step", "4", "--n_test_step", "4",
        "--n_train_img", str(n_img), "--n_test_img", str(n_img),
        "--bs_train", str(bs_train),
        "--user_defined_t_edit", "500", "--user_defined_t_addnoise", "100",
        "--lr_training", "0.01", "--n_iter", "1", "--clip_loss_w", "0",
        # reference-faithful defaults (get_h_num=0, l1_loss_w=0) train
        # nothing — the tiny recipes opt into the reference scripts' values
        "--get_h_num", "1", "--l1_loss_w", "3.0",
        "--ni",
    ]
    if allow_random_weights:
        argv.append("--allow_random_weights")
    return argv + list(extra)
