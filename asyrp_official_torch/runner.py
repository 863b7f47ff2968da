"""AsyrpRunner — the port of the JAX `runner.py` for Δ-training of
DeltaBlocks (`run_training` with `--train_delta_block`, the CLIP
directional loss; the DDPM++ family) and edit serving (`run_test` with
`--train_delta_block` checkpoints, `--sample_type ddim` or `ddpm`; the DDPM++
and OpenAI families), on one device.

Not ported yet (each raises `NotImplementedError`): training the OpenAI
family (it needs the multi-head attention backward), the LPIPS stage,
DiffStyle, fidelity, `--train_delta_h` rows, the ID loss, multi-attribute
mixing, delta-interpolation sweeps, mean-of-Δh harvesting, random-noise
latents, process dumps and the multi-device flags (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from asyrp_official_torch.compat import delta_ckpt
from asyrp_official_torch.compat.from_jax import delta_block_state_dict_from_jax
from asyrp_official_torch.configs.paths import DATASET_PATHS
from asyrp_official_torch.core.schedule import make_schedule, train_seq, uniform_seq
from asyrp_official_torch.data import datasets as data
from asyrp_official_torch.data.imageio import save_image
from asyrp_official_torch.models.delta import EditState, delta_block_from_tree, init_delta_blocks
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.pipelines import engine, precompute as pc, train as tr
from asyrp_official_torch.pipelines.interval import select_interval
from asyrp_official_torch.utils import assets, hostrng

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
# run_training options outside the ported path
_UNPORTED_TRAIN_FLAGS = {
    "train_delta_h": "--train_delta_h rows (M6)", "load_random_noise": "--load_random_noise (M5)",
    "target_class_num": "--target_class_num (M8)",
}
# the origin-trajectory cache stays on the device up to this many bytes
_ORIGIN_CACHE_BYTES = 4 * 2**30


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
    def __init__(self, args, config: Dict[str, Any], *, clip_ctx=None, work_dir: str = "."):
        for flag in ("dp", "sp", "tp_spatial"):
            if getattr(args, flag, 0):
                raise NotImplementedError(f"--{flag}: multi-device runs {_TODO} (M10)")
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
        self.clip_ctx = clip_ctx
        self.work_dir = work_dir
        self.compute_dtype = torch.bfloat16 if getattr(args, "bf16", False) else torch.float32
        # the prompts of --edit_attr, or --src_txts / --trg_txts
        if getattr(args, "edit_attr", None) not in (None, "attribute"):
            self.src_txts, self.trg_txts = assets.src_trg_prompts()[args.edit_attr]
        else:
            self.src_txts = getattr(args, "src_txts", None)
            self.trg_txts = getattr(args, "trg_txts", None)
        self._model = None
        self._engine_cache: Dict[Any, Any] = {}

    # ------------------------------------------------------------------
    def load_pretrained(self):
        """The frozen UNet of the config's family: `--model_path` (a
        reference `.ckpt`, or an iDDPM/ADM `.pt`, loaded by key name), or
        `--allow_random_weights` (the JAX package's seeded init, bridged),
        else an error naming what is missing."""
        if self._model is not None:
            return self._model
        a = self.args
        path = getattr(a, "model_path", None)
        if getattr(a, "download_weights", False) and not path:
            raise NotImplementedError(f"--download_weights {_TODO}: pass --model_path")
        if path:
            if not os.path.exists(path):
                raise FileNotFoundError(f"--model_path {path!r} does not exist")
            sd = {k: torch.from_numpy(np.asarray(v, np.float32))
                  for k, v in delta_ckpt.load_state_dict_numpy(path).items()}
            log.info("loaded pretrained diffusion model from %s", path)
        elif getattr(a, "allow_random_weights", False):
            log.warning("--allow_random_weights: using RANDOM weights — outputs are NOT "
                        "meaningful edits")
            sd = self.spec.state_dict_from_jax(self.spec.init(hostrng.PRNGKey(a.seed)))
        else:
            raise FileNotFoundError(
                f"no pretrained diffusion weights for {_route_key(self.config)}: pass "
                "--model_path <ckpt>; --allow_random_weights runs with random weights "
                "(tests/plumbing only)")
        model = self.spec.build()
        model.load_state_dict(sd)
        self._model = model.to(self.device).eval().requires_grad_(False)
        return self._model

    def set_interval(self) -> float:
        """t_edit / t_addnoise: user-defined, or read off the LPIPS curves
        with the threshold scaled by the CLIP text cosine of the prompts.
        Returns the cosine (1 without a CLIP context), which also scales the
        training's L1 term."""
        a = self.args
        if a.user_defined_t_edit and a.user_defined_t_addnoise and self.clip_ctx is None:
            self.t_edit, self.t_addnoise = a.user_defined_t_edit, a.user_defined_t_addnoise
            return 1.0
        cosine = 1.0
        if self.clip_ctx is not None:
            cosine = self.clip_ctx.text_cosine(self.src_txts, self.trg_txts)
        candidates = []
        custom_name = getattr(a, "custom_dataset_name", None)
        if self.config["data"]["category"] == "CUSTOM" and custom_name:
            candidates.append(custom_name)
        candidates.append(_dataset_key(self.config))
        key, curve_x0_t, curve_x = candidates[-1], None, None
        for cand in candidates:
            tsv = os.path.join(self.work_dir, "utils", f"{cand}_LPIPS_distance_x0_t.tsv")
            if os.path.exists(tsv):
                key, curve_x0_t = cand, assets.load_lpips_tsv(tsv)
                tsv_x = os.path.join(self.work_dir, "utils", f"{cand}_LPIPS_distance_x.tsv")
                if os.path.exists(tsv_x):
                    curve_x = assets.load_lpips_tsv(tsv_x)
                break
            try:
                assets.lpips_curve(cand, "x0_t")
                key = cand
                break
            except KeyError:
                continue
        self.t_edit, self.t_addnoise = select_interval(
            key, cosine,
            lpips_edit_th=a.lpips_edit_th,
            lpips_addnoise_th=a.lpips_addnoise_th,
            add_noise_from_xt=getattr(a, "add_noise_from_xt", False),
            user_defined_t_edit=a.user_defined_t_edit or None,
            user_defined_t_addnoise=a.user_defined_t_addnoise or None,
            curve_x0_t=curve_x0_t, curve_x=curve_x,
        )
        log.info("t_edit=%d t_addnoise=%d cosine=%.4f", self.t_edit, self.t_addnoise, cosine)
        return cosine

    # ------------------------------------------------------------------
    def get_pairs(self, model, mode: str) -> Dict[str, np.ndarray]:
        a = self.args
        d = self.config["data"]
        n_consume = a.n_train_img if mode == "train" else a.n_test_img
        n_img = max(n_consume, getattr(a, "n_precomp_img", 0) or 0)
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

    def _load_blocks(self, path: str) -> torch.nn.Module:
        loaded = delta_ckpt.load_delta_checkpoint(path)
        block = delta_block_from_tree(loaded["blocks"][0], self.spec.bottleneck_ch,
                                      self.spec.temb_ch, flavor=self.spec.delta_flavor)
        return block.to(self.device).eval().requires_grad_(False)

    # ------------------------------------------------------------------
    def run_training(self):
        """Δ-training of DeltaBlock 0 (`--train_delta_block`): per outer
        iteration the StepLR learning rate, the drop-last batches of the
        training latents, SGD at every edited timestep, the `.pth`
        checkpoint; an existing checkpoint of an iteration is loaded and the
        iteration skipped (plain SGD keeps no optimizer state). `--do_test`
        then writes the test grids."""
        a = self.args
        for flag, what in _UNPORTED_TRAIN_FLAGS.items():
            if getattr(a, flag, None):
                raise NotImplementedError(f"{what} {_TODO}")
        if self.spec.family == "openai" and not getattr(a, "just_precompute", False):
            raise NotImplementedError(
                "training on the OpenAI-family UNets needs the multi-head attention backward "
                "(kernel K2-bwd with num_heads > 1), which is not ported yet (ROADMAP.md Queue 2)")
        if a.get_h_num < 1:
            # the reference's default 0 leaves its optimizer with no parameters
            raise ValueError("--train_delta_block needs --get_h_num >= 1 (the reference "
                             "default 0 leaves the optimizer with no parameters)")
        cosine = self.set_interval()
        seq_train, _ = train_seq(a.n_train_step, a.t_0, self.t_edit)
        # n_train_step == 0 is the reference's 'no skip' mode
        seq_test = uniform_seq(a.n_train_step, a.t_0) if a.n_train_step else list(range(0, a.t_0))
        model = self.load_pretrained()

        # the reference trains block 0 only; the get_h_num > 1 extras keep
        # their init and are saved untouched (JAX-layout trees)
        blocks = init_delta_blocks(a.seed, a.get_h_num, self.spec.bottleneck_ch,
                                   self.spec.temb_ch, flavor=self.spec.delta_flavor)
        block = blocks[0].to(self.device).train()
        extra_blocks = [self._block_tree(b) for b in blocks[1:]]
        edit = EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0], device=self.device),
                         flavor=self.spec.delta_flavor, ignore_timestep=a.ignore_timesteps)

        extra_loss = None
        if self.clip_ctx is not None and a.clip_loss_w:
            from asyrp_official_torch.losses.clip_loss import train_clip_term

            extra_loss = train_clip_term(self.clip_ctx, self.src_txts[0], self.trg_txts[0],
                                         a.clip_loss_w)

        def loss_fn(x0_t, x0_t_origin, x0):
            return tr.default_loss(x0_t, x0_t_origin, x0, l1_w=a.l1_loss_w, cosine=cosine,
                                   extra=extra_loss)

        optimizer = tr.make_optimizer(block.parameters(), a.lr_training)
        pairs = self.get_pairs(model, "train")
        if getattr(a, "just_precompute", False):
            log.info("pre-computed done.")
            return edit

        x_lat_all = pairs["x_lat"][: a.n_train_img]
        x0_all = pairs["x0"][: a.n_train_img]
        if a.target_image_id:
            keep = [int(i) for i in str(a.target_image_id).split(" ")]
            keep = [i for i in range(x_lat_all.shape[0]) if i in keep]
            x_lat_all, x0_all = x_lat_all[keep], x0_all[keep]
        if not getattr(a, "do_train", 1):
            log.info("--do_train 0: skipping the training loop")
            if a.do_test:
                self._test_sweep(model, edit, seq_test)
            return edit
        if x_lat_all.shape[0] < a.bs_train:
            raise ValueError(
                f"no full batch to train on: bs_train={a.bs_train} > {x_lat_all.shape[0]} "
                "available training images (drop_last would skip every batch and save an "
                "UNTRAINED checkpoint)")

        # The no-grad plain reference trajectory depends only on the frozen
        # UNet and x_lat, so with more than one outer iteration it is
        # computed once per batch and reused; the stacks stay on the device
        # up to _ORIGIN_CACHE_BYTES.
        n_outer = a.n_iter - a.start_iter_when_you_use_pretrained
        n_batches = max(1, x_lat_all.shape[0] // a.bs_train)
        origin_bytes = (n_batches * len(seq_train) * a.bs_train
                        * int(np.prod(x_lat_all.shape[1:])) * 4)
        use_origin_cache = n_outer > 1 and origin_bytes <= _ORIGIN_CACHE_BYTES
        step = tr.make_train_step(self.spec, self.schedule, seq_train, t_edit=self.t_edit,
                                  loss_fn=loss_fn, compute_dtype=self.compute_dtype,
                                  ignore_timesteps=a.ignore_timesteps,
                                  cached_origin=use_origin_cache)
        origin_cache: Dict[int, torch.Tensor] = {}
        if use_origin_cache:
            log.info("origin-trajectory cache ON: %d batch(es) x %d steps (%.0f MB), reused "
                     "across %d outer iterations", n_batches, len(seq_train),
                     origin_bytes / 2**20, n_outer)
        # timesteps the optimizer edits per batch: blocks gate on t >= t_edit
        n_edit_steps = sum(1 for t in seq_train if t >= self.t_edit) or 1

        for it_out in range(a.start_iter_when_you_use_pretrained, a.n_iter):
            save_name = self._ckpt_path(it_out)
            if not a.retrain and os.path.exists(save_name):
                log.info("%s exists; loading checkpoint and skipping iter", save_name)
                extra_blocks = self._apply_loaded_delta(block, save_name) or extra_blocks
                continue
            lr = tr.steplr_lr(a.lr_training, it_out, a.scheduler_step_size, a.sch_gamma)
            losses: List[float] = []
            batch_ms: List[float] = []
            save_counter = 0
            for bi, ofs in enumerate(range(0, len(x_lat_all), a.bs_train)):
                if x_lat_all[ofs: ofs + a.bs_train].shape[0] != a.bs_train:
                    break  # drop_last
                xb = torch.from_numpy(x_lat_all[ofs: ofs + a.bs_train]).to(self.device)
                x0b = torch.from_numpy(x0_all[ofs: ofs + a.bs_train]).to(self.device)
                t0 = time.perf_counter()
                if use_origin_cache:
                    if ofs not in origin_cache:
                        origin_cache[ofs] = step.compute_origins(model, xb)
                    metrics = step(model, edit, optimizer, xb, x0b, lr, origin_cache[ofs])
                else:
                    metrics = step(model, edit, optimizer, xb, x0b, lr)
                losses.append(float(metrics["loss"]))  # the host fetch waits for the device
                batch_ms.append((time.perf_counter() - t0) * 1e3)
                # the reference checks its counter before incrementing: saves at
                # batches 0, step, 2*step ...
                if a.save_checkpoint_during_iter and bi % a.save_checkpoint_step == 0:
                    self._save_delta(block, extra_blocks, self._ckpt_path(it_out, save_counter))
                    save_counter += 1
                if (a.save_train_image and (len(losses) - 1) % a.save_train_image_step == 0
                        and it_out % a.save_train_image_iter == 0):
                    self.save_grid(model, edit, x_lat_all[ofs: ofs + a.bs_train], seq_test,
                                   file_name=f"train_{ofs + a.bs_train - 1}_{it_out}",
                                   folder=getattr(a, "save_to_folder", None)
                                   or self._dir(os.path.join(a.exp, "training_images")),
                                   x0=x0_all[ofs: ofs + a.bs_train])
            # the steady-state batch time leaves out the run's first batch
            first_iter = it_out == a.start_iter_when_you_use_pretrained
            steady = sorted(batch_ms[1:] if first_iter and len(batch_ms) > 1 else batch_ms)
            timing = ""
            if steady:
                med = steady[len(steady) // 2]
                timing = (f", {med:.0f} ms/batch -> {med / n_edit_steps:.1f} ms/edit-timestep "
                          f"({n_edit_steps} edited)")
            log.info("iter %d: mean loss %.4f (lr %.4g%s)", it_out,
                     float(np.mean(losses or [0.0])), lr, timing)
            self._save_delta(block, extra_blocks, save_name)
            if a.save_checkpoint_only_last_iter and it_out > 0:
                prev = self._ckpt_path(it_out - 1)
                if os.path.exists(prev):
                    os.remove(prev)

        if a.do_test:
            self._test_sweep(model, edit, seq_test)
        return edit

    @staticmethod
    def _block_tree(block: torch.nn.Module) -> Dict[str, Any]:
        """A DeltaBlock → its JAX-layout tree (the checkpoint format)."""
        return delta_ckpt.convert_delta_block(
            {k: v.detach().cpu().numpy() for k, v in block.state_dict().items()})

    def _save_delta(self, block: torch.nn.Module, extra_blocks, path: str) -> None:
        """The trained block first, the untrained get_h_num > 1 extras after it."""
        delta_ckpt.save_delta_checkpoint(
            path, blocks=[self._block_tree(block)] + list(extra_blocks),
            flavor=self.spec.delta_flavor)
        log.info("saved %s", path)

    def _apply_loaded_delta(self, block: torch.nn.Module, path: str):
        """Load the checkpoint's first block into the trained `block`;
        returns the untrained extras saved after it."""
        loaded = delta_ckpt.load_delta_checkpoint(path)["blocks"]
        with torch.no_grad():
            block.load_state_dict(delta_block_state_dict_from_jax(loaded[0],
                                                                  self.spec.delta_flavor))
        return loaded[1:]

    def _test_sweep(self, model, edit: EditState, seq_test) -> None:
        a = self.args
        pairs = self.get_pairs(model, "test")
        folder = self._dir(os.path.join(a.exp, "test_images"))
        for ofs in range(0, min(a.n_test_img, pairs["x_lat"].shape[0]), a.bs_train):
            xb = pairs["x_lat"][ofs: ofs + a.bs_train]
            if xb.shape[0] != a.bs_train:
                break
            self.save_grid(model, edit, xb, seq_test,
                           file_name=f"test_{ofs + a.bs_train - 1}_{a.n_iter - 1}",
                           folder=folder, x0=pairs["x0"][ofs: ofs + a.bs_train])

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
                "gen", tuple(seq), t_addnoise=self.t_addnoise if a.origin_process_addnoise else -1,
                sample_type=a.sample_type)
            x, _ = gen(model, x_dev, self._generator())
            rows.append(x.cpu().numpy())
        run = self._cached_engine(
            "edit", tuple(seq), t_edit=self.t_edit, t_addnoise=self.t_addnoise,
            sample_type=a.sample_type, dt_lambda=a.dt_lambda, dt_end=a.dt_end)
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
        "LSUN_church_outdoor": "church", "LSUN_bedroom": "bedroom", "AFHQ": "afhq",
        "FFHQ": "afhq", "MetFACE": "metface", "CelebA_HQ_P2": "metface", "IMAGENET": "celeba",
    }.get(_route_key(config), "celeba")
