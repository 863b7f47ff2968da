"""AsyrpRunner — the port of the JAX `runner.py` for the edit-serving path
(`run_test` with `--train_delta_block` checkpoints), on one device.

Not ported yet (each raises `NotImplementedError`): training, the LPIPS
stage, DiffStyle, fidelity, `--train_delta_h` rows, multi-attribute mixing,
delta-interpolation sweeps, mean-of-Δh harvesting, random-noise latents,
process dumps and the multi-device flags (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from asyrp_official_torch.compat.from_jax import (
    ddpmpp_state_dict_from_jax,
    delta_block_state_dict_from_jax,
)
from asyrp_official_torch.models.delta import DeltaBlock, EditState
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import engine, precompute as pc
from asyrp_official_tpu.compat import delta_ckpt
from asyrp_official_tpu.core.schedule import make_schedule, uniform_seq
from asyrp_official_tpu.data import datasets as data
from asyrp_official_tpu.data.imageio import save_image
from asyrp_official_tpu.pipelines.interval import select_interval
from asyrp_official_tpu.utils import hostrng

log = logging.getLogger(__name__)

__all__ = ["AsyrpRunner", "resolve_device"]

_TODO = "is not ported yet (ROADMAP.md Queue 1)"

# run_test options outside the ported path: flag -> value that means "off"
_UNPORTED_TEST_FLAGS = {
    "train_delta_h": False, "multiple_attr": "", "delta_interpolation": False,
    "num_mean_of_delta_hs": 0, "load_random_noise": False, "save_process_origin": False,
    "save_process_delta_h": False, "pass_editing": False, "diff_style": False,
    "use_mask": False, "target_class_num": None,
}


def resolve_device(name: str) -> torch.device:
    """`--device` → torch.device; a CUDA device without CUDA raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available here (use --device cpu)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"--device {name}: only cpu and cuda are supported")
    return dev


def _route_key(config) -> str:
    d = config["data"]
    return f"LSUN_{d['category']}" if d["dataset"] == "LSUN" else d["dataset"]


class AsyrpRunner:
    def __init__(self, args, config: Dict[str, Any], *, work_dir: str = "."):
        for flag in ("dp", "sp", "tp_spatial"):
            if getattr(args, flag, 0):
                raise NotImplementedError(f"--{flag}: multi-device serving {_TODO} (M10)")
        self.args = args
        self.config = config
        self.spec = spec_from_config(config)
        self.device = resolve_device(getattr(args, "device", "cuda"))
        if self.device.type == "cuda":
            # full-f32 convolutions and matmuls, as the JAX f32 reference;
            # PyTorch's default would run cuDNN convolutions in TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        diff = config["diffusion"]
        self.schedule = make_schedule(
            num_timesteps=diff["num_diffusion_timesteps"],
            beta_start=diff["beta_start"],
            beta_end=diff["beta_end"],
            var_type=config["model"].get("var_type", "fixedsmall"),
        )
        self.work_dir = work_dir
        self.compute_dtype = torch.bfloat16 if getattr(args, "bf16", False) else torch.float32
        self._model = None
        self._engine_cache: Dict[Any, Any] = {}

    # ------------------------------------------------------------------
    def load_pretrained(self):
        """The frozen UNet: `--model_path` (a reference `.ckpt`, loaded by
        key name), or `--allow_random_weights` (the JAX package's seeded
        init, bridged), else an error naming what is missing."""
        if self._model is not None:
            return self._model
        a = self.args
        path = getattr(a, "model_path", None)
        if getattr(a, "download_weights", False) and not path:
            raise NotImplementedError(f"--download_weights {_TODO}: pass --model_path")
        if path:
            if not os.path.exists(path):
                raise FileNotFoundError(f"--model_path {path!r} does not exist")
            from asyrp_official_tpu.compat.torch_convert import load_state_dict_numpy

            sd = {k: torch.from_numpy(np.asarray(v, np.float32))
                  for k, v in load_state_dict_numpy(path).items()}
            log.info("loaded pretrained diffusion model from %s", path)
        elif getattr(a, "allow_random_weights", False):
            log.warning("--allow_random_weights: using RANDOM weights — outputs are NOT "
                        "meaningful edits")
            sd = ddpmpp_state_dict_from_jax(self.spec.init(hostrng.PRNGKey(a.seed)))
        else:
            raise FileNotFoundError(
                f"no pretrained diffusion weights for {_route_key(self.config)}: pass "
                "--model_path <ckpt>; --allow_random_weights runs with random weights "
                "(tests/plumbing only)")
        model = self.spec.build()
        model.load_state_dict(sd)
        self._model = model.to(self.device).eval().requires_grad_(False)
        return self._model

    def set_interval(self) -> None:
        """t_edit / t_addnoise: user-defined, or read off the LPIPS curves.
        Without CLIP weights the source/target cosine is 1, as in the JAX
        runner without a CLIP context."""
        a = self.args
        if a.user_defined_t_edit and a.user_defined_t_addnoise:
            self.t_edit, self.t_addnoise = a.user_defined_t_edit, a.user_defined_t_addnoise
            return
        from asyrp_official_tpu.utils.assets import load_lpips_tsv, lpips_curve

        candidates = []
        custom_name = getattr(a, "custom_dataset_name", None)
        if self.config["data"]["category"] == "CUSTOM" and custom_name:
            candidates.append(custom_name)
        candidates.append(_dataset_key(self.config))
        key, curve_x0_t, curve_x = candidates[-1], None, None
        for cand in candidates:
            tsv = os.path.join(self.work_dir, "utils", f"{cand}_LPIPS_distance_x0_t.tsv")
            if os.path.exists(tsv):
                key, curve_x0_t = cand, load_lpips_tsv(tsv)
                tsv_x = os.path.join(self.work_dir, "utils", f"{cand}_LPIPS_distance_x.tsv")
                if os.path.exists(tsv_x):
                    curve_x = load_lpips_tsv(tsv_x)
                break
            try:
                lpips_curve(cand, "x0_t")
                key = cand
                break
            except KeyError:
                continue
        self.t_edit, self.t_addnoise = select_interval(
            key, 1.0,
            lpips_edit_th=a.lpips_edit_th,
            lpips_addnoise_th=a.lpips_addnoise_th,
            add_noise_from_xt=getattr(a, "add_noise_from_xt", False),
            user_defined_t_edit=a.user_defined_t_edit or None,
            user_defined_t_addnoise=a.user_defined_t_addnoise or None,
            curve_x0_t=curve_x0_t, curve_x=curve_x,
        )
        log.info("t_edit=%d t_addnoise=%d", self.t_edit, self.t_addnoise)

    # ------------------------------------------------------------------
    def get_pairs(self, model, mode: str) -> Dict[str, np.ndarray]:
        a = self.args
        d = self.config["data"]
        n_consume = a.n_train_img if mode == "train" else a.n_test_img
        n_img = max(n_consume, getattr(a, "n_precomp_img", 0) or 0)
        from asyrp_official_tpu.configs.paths import DATASET_PATHS

        paths = dict(DATASET_PATHS)
        if d["category"] == "CUSTOM":
            paths["custom_train"] = a.custom_train_dataset_dir
            paths["custom_test"] = a.custom_test_dataset_dir
        train_ds, test_ds = data.get_dataset(d["dataset"], paths, category=d["category"],
                                             image_size=d["image_size"])
        save_dir = None
        if getattr(a, "save_precomputed_images", False):
            save_dir = self._dir(os.path.join(a.exp, "image_samples"))
        return pc.precompute_pairs(
            self.spec, model, self.schedule, train_ds if mode == "train" else test_ds,
            n_img=n_img, n_inv_step=a.n_inv_step, device=self.device, t_0=a.t_0, mode=mode,
            category=d["category"], cache_dir=self._dir("precomputed"), batch_size=a.bs_train,
            re_precompute=getattr(a, "re_precompute", False), compute_dtype=self.compute_dtype,
            save_imgs_dir=save_dir,
            shuffle_seed=(a.seed if mode == "train" and getattr(a, "shuffle_train_dataloader", False)
                          else None),
        )

    def _dir(self, name: str) -> str:
        p = os.path.join(self.work_dir, name)
        os.makedirs(p, exist_ok=True)
        return p

    def _ckpt_path(self, it: int, extra=None) -> str:
        a = self.args
        if getattr(a, "load_from_checkpoint", None):
            name = delta_ckpt.checkpoint_name(
                a.load_from_checkpoint, self.config["data"]["category"], a.t_0, a.n_inv_step,
                a.n_train_step, it, extra)
        else:
            exp_id = os.path.split(a.exp)[-1]
            name = f"{exp_id}_{it}.pth" if extra is None else f"{exp_id}_{it}_{extra}.pth"
        return os.path.join(self._dir("checkpoint"), name)

    def _load_blocks(self, path: str) -> DeltaBlock:
        loaded = delta_ckpt.load_delta_checkpoint(path)
        block = DeltaBlock(self.spec.bottleneck_ch, self.spec.temb_ch)
        block.load_state_dict(delta_block_state_dict_from_jax(loaded["blocks"][0]))
        return block.to(self.device).eval().requires_grad_(False)

    # ------------------------------------------------------------------
    def save_grid(self, model, edit: EditState, x_lat: np.ndarray, seq, *,
                  file_name: str, folder: str, x0: Optional[np.ndarray] = None):
        """One grid: [x0 if --save_x0;] [plain generation if --save_x_origin;]
        the edited generation."""
        a = self.args
        x_dev = torch.from_numpy(np.ascontiguousarray(x_lat, np.float32)).to(self.device)
        rows: List[np.ndarray] = []
        if a.save_x0 and x0 is not None:
            rows.append(np.asarray(x0))
        if a.save_x_origin:
            gen = self._cached_engine(
                "gen", tuple(seq), t_addnoise=self.t_addnoise if a.origin_process_addnoise else -1)
            x, _ = gen(model, x_dev, self._generator())
            rows.append(x.cpu().numpy())
        run = self._cached_engine(
            "edit", tuple(seq), t_edit=self.t_edit, t_addnoise=self.t_addnoise,
            dt_lambda=a.dt_lambda, dt_end=a.dt_end)
        x, _ = run(model, edit, x_dev, self._generator())
        rows.append(x.cpu().numpy())
        out = os.path.join(folder, f"{file_name}_ngen{a.n_train_step}.png")
        save_image(np.concatenate(rows, axis=0), out, nrow=max(1, x_lat.shape[0]), pm1=True)
        log.info("%s saved (%d rows)", out, len(rows))

    def _generator(self) -> torch.Generator:
        """The eta noise source of one grid: seeded by --seed on the device."""
        return torch.Generator(device=self.device).manual_seed(self.args.seed)

    def _cached_engine(self, kind: str, seq: tuple, **kw):
        key = (kind, seq, tuple(sorted(kw.items())))
        if key not in self._engine_cache:
            make = engine.make_generate if kind == "gen" else engine.make_edit_generate
            self._engine_cache[key] = make(self.spec, self.schedule, list(seq),
                                           compute_dtype=self.compute_dtype, **kw)
        return self._engine_cache[key]

    # ------------------------------------------------------------------
    def run_test(self):
        a = self.args
        for flag, off in _UNPORTED_TEST_FLAGS.items():
            if getattr(a, flag, off) not in (off, None, False, 0, ""):
                raise NotImplementedError(f"--{flag} {_TODO}")
        if a.sample_type != "ddim":
            raise NotImplementedError(f"--sample_type {a.sample_type} {_TODO} (M8)")
        if not a.train_delta_block:
            raise NotImplementedError(
                f"run_test without --train_delta_block {_TODO}: the port serves DeltaBlock "
                "checkpoints")
        self.set_interval()
        seq_test = uniform_seq(a.n_test_step, a.t_0) if a.n_test_step else list(range(0, a.t_0))
        model = self.load_pretrained()

        n_train_eff = a.n_train_step or a.t_0
        n_test_eff = a.n_test_step or a.t_0
        scaling = n_train_eff / n_test_eff * a.hs_coeff_delta_h
        hs_coeff = (1.0 * a.hs_coeff_origin_h, 1.0 * scaling)

        if getattr(a, "manual_checkpoint_name", None):
            ckpt = os.path.join(self._dir("checkpoint"), a.manual_checkpoint_name)
        elif getattr(a, "choose_checkpoint_num", None):
            ckpt = self._ckpt_path(a.n_iter - 1, a.choose_checkpoint_num)
        else:
            ckpt = self._ckpt_path(a.n_iter - 1)
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"checkpoint({ckpt}) does not exist!")
        edit = EditState(
            blocks=(self._load_blocks(ckpt),),
            hs_coeff=torch.tensor(hs_coeff, dtype=torch.float32, device=self.device),
            flavor=self.spec.delta_flavor, ignore_timestep=a.ignore_timesteps,
        )

        folder = self._dir(os.path.join(a.exp, "test_images", str(a.n_test_step)))
        target_ids = None
        if a.target_image_id:
            target_ids = [int(i) for i in str(a.target_image_id).split(" ")]
            if a.bs_train != 1:
                raise ValueError("target_image_id is only supported for bs_train == 1")
        splits = ([("train", a.n_train_img)] if a.do_train else []) + (
            [("test", a.n_test_img)] if a.do_test else [])
        grid_ms: List[float] = []
        for mode, n_img in splits:
            pairs = self.get_pairs(model, mode)
            for ofs in range(0, min(n_img, pairs["x_lat"].shape[0]), a.bs_train):
                if target_ids is not None and ofs not in target_ids:
                    continue
                if getattr(a, "start_image_id", 0) > ofs:
                    continue
                xb = pairs["x_lat"][ofs:ofs + a.bs_train]
                if xb.shape[0] != a.bs_train:
                    break
                t0 = time.perf_counter()
                self.save_grid(model, edit, xb, seq_test,
                               file_name=f"{mode}_{ofs + a.bs_train - 1}_{a.n_iter - 1}",
                               folder=folder, x0=pairs["x0"][ofs:ofs + a.bs_train])
                grid_ms.append((time.perf_counter() - t0) * 1e3)
        if grid_ms:
            log.info("serving on %s: %d grids, first %.1f ms, last %.1f ms (%d-step chain, bs %d)",
                     self.device, len(grid_ms), grid_ms[0], grid_ms[-1], len(seq_test), a.bs_train)
        return edit


def _dataset_key(config) -> str:
    return {
        "CelebA_HQ": "celeba", "CUSTOM": "celeba", "CelebA_HQ_Dialog": "celeba",
        "LSUN_church_outdoor": "church", "LSUN_bedroom": "bedroom",
    }.get(_route_key(config), "celeba")
