"""AsyrpRunner — the port of the JAX `runner.py` for the DDPM++ and the
OpenAI families (iDDPM AFHQ/FFHQ, ADM MetFACE/CelebA_HQ_P2):

  * `run_training`: Δ-training of a DeltaBlock (`--train_delta_block`) or
    of per-timestep Δh rows (`--train_delta_h`, injected by
    `--delta_injection add|slerp`), with the CLIP directional loss;
  * `run_test`: edit serving from block or row checkpoints (rows trained on
    another grid are remapped onto the test grid), `--multiple_attr`
    mixing, `--delta_interpolation` sweeps (one generation per
    coefficient tuple), the mean-of-Δh harvest
    (`--num_mean_of_delta_hs`), `--load_random_noise` latents, the
    per-step process dumps and `--pass_editing`; `--sample_type ddim` or
    `ddpm`;
  * the ArcFace ID term of the training loss (`--id_loss_w` with an IR-SE50
    net), anchored to the un-edited x0_t_origin;
  * `run_lpips`: the LPIPS calibration stage (`--lpips`), which writes the
    four per-timestep tsvs that `set_interval` reads;
  * `run_fidelity`: the fidelity runbook (`--run_fidelity`), invert→edit of
    every test image and, against `--fidelity_ref_dir`, the LPIPS report;
  * IMAGENET (`imagenet.yml`): `--target_class_num` picks the class that
    serving and training read, and names their latent caches;
  * `run_style_transfer`: DiffStyle (`--diff_style`), every `--content_dir`
    image stylized by every `--style_dir` image.

Multi-device (`--dp`, `--sp`, `--tp_spatial`; one process per GPU under
`torchrun`, `parallel/mesh.py`): every rank holds the same host batches,
runs its block of each (`Mesh.put` / `Mesh.put_padded`, the JAX runner's
`_put` / `_put_padded`) and fetches the whole result back; the writer
rank writes the files. Data parallelism and spatial sharding
(`--tp_spatial`, `--sp`) run every mode: the eta noise is drawn for the
global batch and sliced, the mean-of-Δh harvest combines the ranks' sums;
under spatial sharding the UNets' layers exchange halos and statistics
inside `spatial.sharded` (`parallel/spatial.py`), differentiably in
training, where each rank backpropagates its share of the loss (the CLIP
and ID terms on the gathered image) and the Δ gradients are summed over
the spatial ranks and averaged over the data axis after each backward; the
LPIPS net of `--lpips` takes the gathered images, DiffStyle's h trajectory
is gathered whole and each rank injects its own rows.
"""
from __future__ import annotations

import dataclasses
import json
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
from asyrp_official_torch.core.steptable import generation_table
from asyrp_official_torch.data import datasets as data
from asyrp_official_torch.data.imageio import save_image
from asyrp_official_torch.models.delta import (EditState, delta_block_from_tree, init_delta_blocks,
                                               rows_to_nchw, rows_to_nhwc)
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.parallel import mesh as pmesh, spatial
from asyrp_official_torch.parallel.multislice import combine_delta_means
from asyrp_official_torch.pipelines import engine, precompute as pc, train as tr
from asyrp_official_torch.pipelines.fidelity import compare_output_dirs
from asyrp_official_torch.pipelines.interval import select_interval
from asyrp_official_torch.pipelines.lpips_stage import compute_lpips_distance
from asyrp_official_torch.utils import assets, hostrng

log = logging.getLogger(__name__)

__all__ = ["AsyrpRunner", "resolve_device"]

_TODO = "is not ported yet (ROADMAP.md Queue 1)"

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
    def __init__(self, args, config: Dict[str, Any], *, clip_ctx=None, id_net=None,
                 lpips_net=None, work_dir: str = "."):
        """`id_net`: a frozen `losses.id_loss.IRSE50` (the `--id_loss_w`
        term); `lpips_net`: a `losses.lpips.LPIPS` (`--lpips`, and
        `--run_fidelity` with a reference dir); both on the run's device."""
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
        self.id_net = id_net
        self.lpips_net = lpips_net
        self.work_dir = work_dir
        self.compute_dtype = torch.bfloat16 if getattr(args, "bf16", False) else torch.float32
        # the mesh of --dp / --sp / --tp_spatial over the processes torchrun
        # started (the JAX runner's guards, parallel/mesh.plan_mesh)
        plan = pmesh.plan_mesh(int(getattr(args, "dp", 0) or 0), int(getattr(args, "sp", 0) or 0),
                               bool(getattr(args, "tp_spatial", False)), pmesh.world_size(),
                               config["data"]["image_size"], getattr(args, "bs_train", 1),
                               self.spec.bottleneck_hw)
        self.mesh = (pmesh.make_mesh(*plan, device=self.device) if plan is not None
                     else pmesh.Mesh(device=self.device))
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
    def _datasets(self, target_class_num=None):
        """(train, test) datasets of the config, the CUSTOM category reading
        --custom_train_dataset_dir / --custom_test_dataset_dir. Only the
        latent precompute passes `target_class_num`, as the JAX runner does:
        the LPIPS stage and the fidelity runbook read no class, so IMAGENET's
        reader raises there."""
        a, d = self.args, self.config["data"]
        paths = dict(DATASET_PATHS)
        if d["category"] == "CUSTOM":
            paths["custom_train"] = a.custom_train_dataset_dir
            paths["custom_test"] = a.custom_test_dataset_dir
        return data.get_dataset(d["dataset"], paths, category=d["category"],
                                image_size=d["image_size"], target_class_num=target_class_num)

    def get_pairs(self, model, mode: str) -> Dict[str, np.ndarray]:
        a = self.args
        d = self.config["data"]
        n_consume = a.n_train_img if mode == "train" else a.n_test_img
        n_img = max(n_consume, getattr(a, "n_precomp_img", 0) or 0)
        if getattr(a, "load_random_noise", False):
            with self._sharded():
                return pc.random_noise_pairs(
                    self.spec, model, self.schedule, n_img=n_img, n_inv_step=a.n_inv_step,
                    device=self.device, image_size=d["image_size"], mode=mode,
                    category=d["category"], cache_dir=self._dir("precomputed"),
                    saved_noise=getattr(a, "saved_random_noise", False), batch_size=a.bs_train,
                    seed=a.seed, compute_dtype=self.compute_dtype, t_0=a.t_0, mesh=self.mesh)
        class_num = getattr(a, "target_class_num", None)
        train_ds, test_ds = self._datasets(class_num)
        save_dir = None
        if getattr(a, "save_precomputed_images", False):
            save_dir = self._dir(os.path.join(a.exp, "image_samples"))
        class_name = None
        if d["dataset"] == "IMAGENET" and class_num is not None:
            class_name = data.imagenet_classes()[str(class_num)][1]
        with self._sharded():
            return pc.precompute_pairs(
                self.spec, model, self.schedule, train_ds if mode == "train" else test_ds,
                n_img=n_img, n_inv_step=a.n_inv_step, device=self.device, t_0=a.t_0, mode=mode,
                category=d["category"], cache_dir=self._dir("precomputed"),
                batch_size=a.bs_train, re_precompute=getattr(a, "re_precompute", False),
                compute_dtype=self.compute_dtype, class_name=class_name, save_imgs_dir=save_dir,
                shuffle_seed=(a.seed if mode == "train"
                              and getattr(a, "shuffle_train_dataloader", False) else None),
                mesh=self.mesh)

    def _dir(self, name: str) -> str:
        p = os.path.join(self.work_dir, name)
        os.makedirs(p, exist_ok=True)
        return p

    # ------------------------------------------------------------------
    # placement on the mesh (the JAX runner's _put / _put_padded / fetch)
    # ------------------------------------------------------------------
    def _sharded(self):
        """The mesh's spatial group for the UNet calls in the block (none
        without spatial sharding)."""
        return spatial.sharded(self.mesh.spatial_info())

    def _noise(self, shape, n_real: Optional[int] = None):
        """(generator, noise_fn) for a chain over a global batch of `shape`
        (its first `n_real` rows real): the seeded generator; on a mesh a
        noise_fn that draws the global batch's noise from it, as one
        process draws, and takes this rank's block."""
        gen = self._generator()
        fn = self.mesh.noise_fn(gen, shape, n_real)
        return (gen, None) if fn is None else (None, fn)

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
        """Δ-training of DeltaBlock 0 (`--train_delta_block`) or of the
        per-timestep Δh rows (`--train_delta_h`, one row per timestep of
        the training grid, or one under `--ignore_timesteps`, drawn as
        0.2·N(0, 1) from `--seed`): per outer iteration the StepLR learning
        rate, the drop-last batches of the training latents, SGD at every
        edited timestep, the `.pth` checkpoint; an existing checkpoint of an
        iteration is loaded and the iteration skipped (plain SGD keeps no
        optimizer state). `--do_test` then writes the test grids.

        Under --dp each rank trains on its rows of every batch (bs_train
        divides by the data axis); under --tp_spatial / --sp on its rows of
        each image, with its share of the loss. The gradients are summed
        over the spatial ranks and averaged over the data axis before each
        SGD step; the CLIP term's batch mean is the global batch's
        (`Mesh.batch_mean`)."""
        a = self.args
        train_target = "rows" if a.train_delta_h else "blocks"
        if train_target == "blocks" and a.get_h_num < 1:
            # the reference's default 0 leaves its optimizer with no parameters
            raise ValueError("--train_delta_block needs --get_h_num >= 1 (the reference "
                             "default 0 leaves the optimizer with no parameters)")
        cosine = self.set_interval()
        seq_train, _ = train_seq(a.n_train_step, a.t_0, self.t_edit)
        # n_train_step == 0 is the reference's 'no skip' mode
        seq_test = uniform_seq(a.n_train_step, a.t_0) if a.n_train_step else list(range(0, a.t_0))
        model = self.load_pretrained()

        extra_blocks: List[Any] = []
        if train_target == "blocks":
            # the reference trains block 0 only; the get_h_num > 1 extras keep
            # their init and are saved untouched (JAX-layout trees)
            blocks = init_delta_blocks(a.seed, a.get_h_num, self.spec.bottleneck_ch,
                                       self.spec.temb_ch, flavor=self.spec.delta_flavor)
            block = blocks[0].to(self.device).train()
            extra_blocks = [self._block_tree(b) for b in blocks[1:]]
            edit = EditState(blocks=(block,), hs_coeff=torch.tensor([1.0, 1.0], device=self.device),
                             flavor=self.spec.delta_flavor, ignore_timestep=a.ignore_timesteps)
            trainable = list(block.parameters())
        else:
            hw = self.spec.bottleneck_hw
            k = 1 if a.ignore_timesteps else len(seq_train)
            rows = np.float32(0.2) * hostrng.normal(hostrng.PRNGKey(a.seed),
                                                    (k, hw, hw, self.spec.bottleneck_ch))
            edit = EditState(
                mode="input", delta_rows=rows_to_nchw(rows).to(self.device).requires_grad_(True),
                hs_coeff=torch.tensor([1.0, 1.0], device=self.device),
                input_style=getattr(a, "delta_injection", "add"),
                ignore_timestep=a.ignore_timesteps,
                times=None if a.ignore_timesteps else tuple(seq_train))
            trainable = [edit.delta_rows]
        self.mesh.replicate(trainable)  # one Δ state on every rank

        extra_loss = None
        if self.clip_ctx is not None and a.clip_loss_w:
            from asyrp_official_torch.losses.clip_loss import train_clip_term

            extra_loss = train_clip_term(self.clip_ctx, self.src_txts[0], self.trg_txts[0],
                                         a.clip_loss_w, batch_mean=self.mesh.batch_mean)
        if self.id_net is not None and a.id_loss_w:
            clip_extra, id_net = extra_loss, self.id_net

            def extra_loss(x0, x0_t, x0_t_origin):  # noqa: F811
                # the reference anchors identity to the un-edited x0_t_origin,
                # not to the source image (diffusion_latent.py:346); x0_t's
                # features are detached, as its IDLoss does
                out = a.id_loss_w * id_net.id_loss(x0_t.permute(0, 3, 1, 2),
                                                   x0_t_origin.permute(0, 3, 1, 2)).mean()
                return out if clip_extra is None else out + clip_extra(x0, x0_t, x0_t_origin)

        def loss_fn(x0_t, x0_t_origin, x0):
            return tr.default_loss(x0_t, x0_t_origin, x0, l1_w=a.l1_loss_w, cosine=cosine,
                                   extra=extra_loss)

        optimizer = tr.make_optimizer(trainable, a.lr_training)
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
        # up to _ORIGIN_CACHE_BYTES of this rank's block (its rows of the
        # batch and of each image).
        n_outer = a.n_iter - a.start_iter_when_you_use_pretrained
        n_batches = max(1, x_lat_all.shape[0] // a.bs_train)
        origin_bytes = (n_batches * len(seq_train) * (a.bs_train // self.mesh.data)
                        * int(np.prod(x_lat_all.shape[1:])) // self.mesh.spatial * 4)
        use_origin_cache = n_outer > 1 and origin_bytes <= _ORIGIN_CACHE_BYTES
        step = tr.make_train_step(self.spec, self.schedule, seq_train, t_edit=self.t_edit,
                                  loss_fn=loss_fn, compute_dtype=self.compute_dtype,
                                  ignore_timesteps=a.ignore_timesteps, train_target=train_target,
                                  cached_origin=use_origin_cache,
                                  sync_grads=self.mesh.sync_grads if self.mesh.size > 1 else None)
        origin_cache: Dict[int, torch.Tensor] = {}
        if use_origin_cache:
            log.info("origin-trajectory cache ON: %d batch(es) x %d steps (%.0f MB), reused "
                     "across %d outer iterations", n_batches, len(seq_train),
                     origin_bytes / 2**20, n_outer)
        # timesteps the optimizer edits per batch: every step has a row in
        # rows mode; blocks gate on t >= t_edit
        n_edit_steps = (len(seq_train) if train_target == "rows"
                        else sum(1 for t in seq_train if t >= self.t_edit)) or 1

        for it_out in range(a.start_iter_when_you_use_pretrained, a.n_iter):
            save_name = self._ckpt_path(it_out)
            if not a.retrain and os.path.exists(save_name):
                log.info("%s exists; loading checkpoint and skipping iter", save_name)
                extra_blocks = self._apply_loaded_delta(edit, save_name, seq_train) or extra_blocks
                continue
            lr = tr.steplr_lr(a.lr_training, it_out, a.scheduler_step_size, a.sch_gamma)
            losses: List[float] = []
            batch_ms: List[float] = []
            save_counter = 0
            for bi, ofs in enumerate(range(0, len(x_lat_all), a.bs_train)):
                if x_lat_all[ofs: ofs + a.bs_train].shape[0] != a.bs_train:
                    break  # drop_last
                xb = self.mesh.put(x_lat_all[ofs: ofs + a.bs_train])
                x0b = self.mesh.put(x0_all[ofs: ofs + a.bs_train])
                t0 = time.perf_counter()
                with self._sharded():
                    if use_origin_cache:
                        if ofs not in origin_cache:
                            origin_cache[ofs] = step.compute_origins(model, xb)
                        metrics = step(model, edit, optimizer, xb, x0b, lr, origin_cache[ofs])
                    else:
                        metrics = step(model, edit, optimizer, xb, x0b, lr)
                # the host fetch waits for the device
                losses.append(self.mesh.mean_over_data(float(metrics["loss"])))
                batch_ms.append((time.perf_counter() - t0) * 1e3)
                # the reference checks its counter before incrementing: saves at
                # batches 0, step, 2*step ...
                if a.save_checkpoint_during_iter and bi % a.save_checkpoint_step == 0:
                    self._save_delta(edit, extra_blocks, self._ckpt_path(it_out, save_counter),
                                     seq_train)
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
            self._save_delta(edit, extra_blocks, save_name, seq_train)
            if a.save_checkpoint_only_last_iter and it_out > 0 and self.mesh.is_writer:
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

    def _row_keys(self, seq_train) -> List[int]:
        """The timesteps a rows checkpoint is keyed by: the training grid,
        or 0 alone under --ignore_timesteps."""
        return [0] if self.args.ignore_timesteps else list(seq_train)

    def _save_delta(self, edit: EditState, extra_blocks, path: str, seq_train) -> None:
        """Blocks: the trained block first, the untrained get_h_num > 1
        extras after it. Rows: one NHWC row per key of `_row_keys`. Written
        by the writer rank (every rank holds the same Δ state)."""
        if not self.mesh.is_writer:
            return
        if edit.mode == "input":
            rows = rows_to_nhwc(edit.delta_rows)
            delta_ckpt.save_delta_checkpoint(
                path, delta_rows={t: rows[i] for i, t in enumerate(self._row_keys(seq_train))})
        else:
            delta_ckpt.save_delta_checkpoint(
                path, blocks=[self._block_tree(edit.blocks[0])] + list(extra_blocks),
                flavor=self.spec.delta_flavor)
        log.info("saved %s", path)

    def _apply_loaded_delta(self, edit: EditState, path: str, seq_train):
        """Load a checkpoint into the trained state in place: its first
        block into the DeltaBlock, or its rows into `edit.delta_rows`.
        Returns the untrained block extras saved after the first."""
        loaded = delta_ckpt.load_delta_checkpoint(path)
        with torch.no_grad():
            if edit.mode == "input":
                rows = np.stack([loaded["delta_rows"][t] for t in self._row_keys(seq_train)])
                edit.delta_rows.copy_(rows_to_nchw(rows))
                return []
            edit.blocks[0].load_state_dict(
                delta_block_state_dict_from_jax(loaded["blocks"][0], self.spec.delta_flavor))
        return loaded["blocks"][1:]

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
    def save_grid(self, model, edit: Optional[EditState], x_lat: np.ndarray, seq, *,
                  file_name: str, folder: str, hs_coeff_list: Optional[List] = None,
                  x0: Optional[np.ndarray] = None, collect_delta: bool = False):
        """One grid: [x0 if --save_x0;] [plain generation if --save_x_origin;]
        the edited generation, once per coefficient tuple of `hs_coeff_list`,
        each pass from the same seeded eta noise, unless --pass_editing.
        `--save_process_origin` / `--save_process_delta_h` also write the
        per-step [x; x0_t] frames. With `collect_delta`, returns the
        per-step Δh [S, B, h, w, C], summed over the coefficient passes (on
        a mesh: this rank's rows of the batch, whole images).

        On a mesh every rank runs its block of the batch (B divides by the
        data axis) with the global batch's eta noise, and fetches the
        images; the writer rank writes the grid."""
        a = self.args
        x_dev = self.mesh.put(x_lat)
        rows: List[np.ndarray] = []
        if a.save_x0 and x0 is not None:
            rows.append(np.asarray(x0))
        if a.save_x_origin:
            process = getattr(a, "save_process_origin", False)
            gen = self._cached_engine(
                "gen", tuple(seq), t_addnoise=self.t_addnoise if a.origin_process_addnoise else -1,
                sample_type=a.sample_type, collect=("x", "x0_t") if process else ())
            with self._sharded():
                x, ys = gen(model, x_dev, *self._noise(x_lat.shape))
            rows.append(self.mesh.fetch(x))
            if process:
                self._dump_process(ys, seq, folder, file_name, "origin")

        harvested = None
        if not getattr(a, "pass_editing", False) and edit is not None:
            delta_times = None
            if edit.mode == "input" and not a.ignore_timesteps:
                delta_times = tuple(edit.times) if edit.times else tuple(seq)
            process = getattr(a, "save_process_delta_h", False)
            collect = (("delta_h",) if collect_delta else ()) + (("x", "x0_t") if process else ())
            run = self._cached_engine(
                "edit", tuple(seq), t_edit=self.t_edit, t_addnoise=self.t_addnoise,
                delta_times=delta_times, ignore_timesteps=a.ignore_timesteps,
                sample_type=a.sample_type, dt_lambda=a.dt_lambda, dt_end=a.dt_end,
                collect=collect)
            for coeff in (list(hs_coeff_list) if hs_coeff_list else [None]):
                e = edit if coeff is None else dataclasses.replace(
                    edit, hs_coeff=torch.tensor(coeff, dtype=torch.float32, device=self.device))
                with self._sharded():
                    x, ys = run(model, e, x_dev, *self._noise(x_lat.shape))
                rows.append(self.mesh.fetch(x))
                if collect_delta:
                    # summed over the coefficient passes; the harvest divides
                    # by the image count only, as the reference does
                    h_new = self.mesh.fetch(ys["delta_h"], batch_dim=None, height_dim=2)
                    harvested = h_new if harvested is None else harvested + h_new
                if process:
                    self._dump_process(ys, seq, folder, file_name, "delta_h")

        if not rows:
            raise ValueError("nothing to draw: --pass_editing with neither --save_x0 nor "
                             "--save_x_origin leaves zero grid rows")
        out = os.path.join(folder, f"{file_name}_ngen{a.n_train_step}.png")
        if self.mesh.is_writer:
            save_image(np.concatenate(rows, axis=0), out, nrow=max(1, x_lat.shape[0]), pm1=True)
            log.info("%s saved (%d rows)", out, len(rows))
        return harvested

    def _dump_process(self, ys, seq, folder: str, file_name: str, tag: str) -> None:
        """Per-step [x; x0_t] frames, `{folder}/{file_name}/{tag}_{t}.png`
        (the [S, B, H, W, C] stacks gathered from the mesh; the writer rank
        writes)."""
        xs, x0s = (self.mesh.fetch(ys[k], batch_dim=1, height_dim=2) for k in ("x", "x0_t"))
        if not self.mesh.is_writer:
            return
        out_dir = os.path.join(folder, file_name)
        os.makedirs(out_dir, exist_ok=True)
        for i, t in enumerate(generation_table(seq).t):
            save_image(np.concatenate([xs[i], x0s[i]], axis=0),
                       os.path.join(out_dir, f"{tag}_{int(t)}.png"), nrow=xs.shape[1], pm1=True)

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

    def _edit_from_rows(self, rows_dict, hs_coeff, seq_test) -> EditState:
        """An `input`-mode edit from {t: NHWC row}: the rows of the test
        grid's timesteps, or row 0 alone under --ignore_timesteps."""
        a = self.args
        if a.ignore_timesteps:
            times, rows = None, np.stack([rows_dict[0]])
        else:
            times = [t for t in seq_test if t in rows_dict]
            rows = np.stack([rows_dict[t] for t in times])
        return EditState(
            mode="input", delta_rows=rows_to_nchw(rows).to(self.device),
            hs_coeff=torch.tensor(hs_coeff, dtype=torch.float32, device=self.device),
            input_style=getattr(a, "delta_injection", "add"), ignore_timestep=a.ignore_timesteps,
            use_mask=bool(getattr(a, "masked_h", False) or getattr(a, "use_mask", False)),
            times=tuple(times) if times else None)

    @staticmethod
    def _remap_rows(rows_dict, seq_train, seq_test_edit):
        """Rows trained on `seq_train` onto the test grid's edited steps, by
        the reference's index walk: the walk advances after a test step
        above the previous training step (diffusion_latent.py:700-723)."""
        remapped, idx = {}, 0
        interval = seq_train[1] - seq_train[0] if len(seq_train) > 1 else 0
        for t in seq_test_edit:
            remapped[t] = rows_dict[seq_train[idx]]
            if t > seq_train[idx] - interval and idx < len(seq_train) - 1:
                idx += 1
        return remapped

    # ------------------------------------------------------------------
    def run_test(self):
        a = self.args
        self.set_interval()
        seq_train, _ = train_seq(a.n_train_step, a.t_0, self.t_edit)
        seq_test = uniform_seq(a.n_test_step, a.t_0) if a.n_test_step else list(range(0, a.t_0))
        seq_test_edit = [t for t in seq_test if t >= self.t_edit]
        model = self.load_pretrained()

        n_train_eff = a.n_train_step or a.t_0
        n_test_eff = a.n_test_step or a.t_0
        scaling = n_train_eff / n_test_eff * a.hs_coeff_delta_h

        if getattr(a, "manual_checkpoint_name", None):
            save_names = [os.path.join(self._dir("checkpoint"), a.manual_checkpoint_name)]
        elif getattr(a, "choose_checkpoint_num", None):
            save_names = [self._ckpt_path(a.n_iter - 1, a.choose_checkpoint_num)]
        else:
            save_names = [self._ckpt_path(a.n_iter - 1)]

        if getattr(a, "multiple_attr", None):
            # one checkpoint per attribute; the interval follows the attribute
            # whose prompts CLIP finds closest; each Δ is scaled by 1/sqrt(n)
            attrs = a.multiple_attr.split(" ")
            coeffs = [1.0] * len(attrs)
            if getattr(a, "multiple_hs_coeff", None):
                given = [float(c) for c in a.multiple_hs_coeff.split(" ")]
                coeffs = given + [1.0] * (len(attrs) - len(given))
            save_names = [save_names[0].replace("attribute", attr) for attr in attrs]
            max_cos, max_attr = 0.0, attrs[0]
            if self.clip_ctx is not None:
                for attr in attrs:
                    c = self.clip_ctx.text_cosine(*assets.src_trg_prompts()[attr])
                    if c > max_cos:
                        max_cos, max_attr = c, attr
            self.src_txts, self.trg_txts = assets.src_trg_prompts()[max_attr]
            self.set_interval()
            hs_coeff = tuple([1.0 * a.hs_coeff_origin_h]
                             + [(1.0 / len(attrs) ** 0.5) * scaling * c for c in coeffs])
        else:
            hs_coeff = (1.0 * a.hs_coeff_origin_h, 1.0 * scaling)

        edit = None
        mean_dh_pending = getattr(a, "num_mean_of_delta_hs", 0)
        latent_path = os.path.join(
            self._dir("checkpoint_latent"),
            f"{os.path.split(a.exp)[-1]}_{a.n_test_step}_{mean_dh_pending}.pth")
        if mean_dh_pending and os.path.isfile(latent_path):
            edit = self._edit_from_rows(delta_ckpt.load_delta_checkpoint(latent_path)["delta_rows"],
                                        hs_coeff, seq_test)
            mean_dh_pending = 0
        elif os.path.exists(save_names[0]):
            if a.train_delta_block:
                edit = EditState(
                    blocks=tuple(self._load_blocks(name) for name in save_names),
                    hs_coeff=torch.tensor(hs_coeff, dtype=torch.float32, device=self.device),
                    flavor=self.spec.delta_flavor, ignore_timestep=a.ignore_timesteps)
            elif a.train_delta_h:
                rows_dict = delta_ckpt.load_delta_checkpoint(save_names[0])["delta_rows"]
                if a.ignore_timesteps:
                    rows_dict = {0: rows_dict[0]}
                elif a.n_train_step != a.n_test_step:
                    rows_dict = self._remap_rows(rows_dict, seq_train, seq_test_edit)
                edit = self._edit_from_rows(rows_dict, hs_coeff, seq_test)
            else:
                raise ValueError(f"checkpoint {save_names[0]} exists but neither "
                                 "--train_delta_block nor --train_delta_h was passed: the flag "
                                 "selects how its contents are read")
        elif mean_dh_pending:
            raise FileNotFoundError("mean-of-delta-hs requested but no trained checkpoint "
                                    f"found ({save_names[0]})")
        else:
            raise FileNotFoundError(f"checkpoint({save_names[0]}) does not exist!")

        hs_coeff_list = None
        if getattr(a, "delta_interpolation", False):
            vals = np.linspace(a.min_delta, a.max_delta, a.num_delta).tolist()
            if getattr(a, "multiple_attr", None) and len(hs_coeff) == 3:
                hs_coeff_list = [(1.0, v1 * hs_coeff[1], v2 * hs_coeff[2])
                                 for v1 in vals for v2 in vals]
            else:
                hs_coeff_list = [tuple([1.0] + [v * c for c in hs_coeff[1:]]) for v in vals]

        folder = self._dir(os.path.join(a.exp, "test_images", str(a.n_test_step)))
        target_ids = None
        if a.target_image_id:
            target_ids = [int(i) for i in str(a.target_image_id).split(" ")]
            if a.bs_train != 1:
                raise ValueError("target_image_id is only supported for bs_train == 1")
        # the train split first (where the mean-of-Δh harvest runs), then the test split
        splits = ([("train", a.n_train_img)] if a.do_train else []) + (
            [("test", a.n_test_img)] if a.do_test else [])
        # the harvest: this rank's sum over its rows of the batches, and the
        # images in it; n_done counts the global batch's images
        harvest_sum: Optional[np.ndarray] = None
        n_done = n_local = 0
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
                harvesting = bool(mean_dh_pending) and mode == "train"
                t0 = time.perf_counter()
                h = self.save_grid(model, edit, xb, seq_test,
                                   file_name=f"{mode}_{ofs + a.bs_train - 1}_{a.n_iter - 1}",
                                   folder=folder, hs_coeff_list=hs_coeff_list,
                                   x0=pairs["x0"][ofs:ofs + a.bs_train], collect_delta=harvesting)
                grid_ms.append((time.perf_counter() - t0) * 1e3)
                if not (harvesting and h is not None):
                    continue
                s = h.sum(axis=1)  # [S, h, w, C], summed over the batch
                harvest_sum = s if harvest_sum is None else harvest_sum + s
                n_done += xb.shape[0]
                n_local += h.shape[1]
                if n_done >= mean_dh_pending and ofs + a.bs_train >= n_img:
                    # the reference's loop breaks on the last training image
                    # before its save (diffusion_latent.py:803-828)
                    log.warning("mean-of-delta-hs harvest complete but NOT saved: the harvest "
                                "finished on the last train image and the reference's loop "
                                "breaks before its save; use --num_mean_of_delta_hs < "
                                "--n_train_img")
                    break
                if n_done >= mean_dh_pending:
                    # per-timestep mean over the images, then the global mean as row 0
                    tab = generation_table(seq_test, t_edit=self.t_edit)
                    # the ranks' sums and counts combined over the data axis (the
                    # spatial ranks of one data index hold the same images)
                    per_t = (combine_delta_means(harvest_sum, n_local,
                                                 group=self.mesh.data_group, device=self.device)
                             if self.mesh.data > 1 else harvest_sum / n_local)
                    active = tab.use_delta > 0
                    mean_rows = {int(t): per_t[i] for i, t in enumerate(tab.t) if active[i]}
                    mean_rows[0] = per_t[active].mean(axis=0)
                    if self.mesh.is_writer:
                        delta_ckpt.save_delta_checkpoint(latent_path, delta_rows=mean_rows)
                        log.info("mean-of-delta-h saved: %s", latent_path)
                    mean_dh_pending = 0
                    # the remaining images are edited with the harvested rows
                    edit = self._edit_from_rows(mean_rows, hs_coeff, seq_test)
        if grid_ms:
            # the first grid carries the warm-up; the steady-state p50 is over the rest
            steady = sorted(grid_ms[1:] or grid_ms)
            p50 = steady[len(steady) // 2]
            log.info("serving on %s: %d grids, first %.1f ms; steady p50 %.1f ms/batch = %.1f "
                     "ms/image = %.2f ms/gen-step (%d-step chain, bs %d)", self.device,
                     len(grid_ms), grid_ms[0], p50, p50 / a.bs_train,
                     p50 / a.bs_train / len(seq_test), len(seq_test), a.bs_train)
        return edit

    # ------------------------------------------------------------------
    def run_style_transfer(self) -> None:
        """DiffStyle: each `--content_dir` image inverted once, each
        `--style_dir` image inverted once with its h trajectory, then every
        pair generated; `content{ci}_style{si}.png` under `--save_dir`.
        Under --dp each batch-1 image goes through the padded put (every
        rank runs a copy) and the output is sliced back to the real row, as
        the JAX runner does; under spatial sharding each rank runs its rows,
        with the style's h trajectory gathered whole."""
        from asyrp_official_torch.pipelines.style_transfer import make_style_transfer

        a = self.args
        self.set_interval()
        model = self.load_pretrained()
        size = self.config["data"]["image_size"]
        contents = data.ImageFolderDataset(a.content_dir, size)
        styles = data.ImageFolderDataset(a.style_dir, size)
        out_dir = self._dir(getattr(a, "save_dir", None) or os.path.join(a.exp, "style"))
        st = make_style_transfer(
            self.spec, self.schedule, n_inv_step=a.n_inv_step,
            n_gen_step=getattr(a, "n_gen_step", 0) or a.n_test_step, t_0=a.t_0,
            t_edit=self.t_edit, hs_coeff=getattr(a, "hs_coeff", 0.9),
            use_mask=getattr(a, "use_mask", False), dt_lambda=a.dt_lambda, dt_end=a.dt_end,
            content_replace_step=getattr(a, "content_replace_step", 0),
            compute_dtype=self.compute_dtype)

        def batch(img):
            return self.mesh.put_padded(img[None])[0]

        with self._sharded():
            content_lats = [st.invert_content(model, batch(contents[ci]))
                            for ci in range(len(contents))]
            for si in range(len(styles)):
                h_traj = st.invert_style(model, batch(styles[si]))
                for ci, x_lat in enumerate(content_lats):
                    stylized = self.mesh.fetch(st.generate(model, x_lat, h_traj,
                                                           self._generator()))
                    if self.mesh.is_writer:
                        save_image(stylized[0],
                                   os.path.join(out_dir, f"content{ci}_style{si}.png"), pm1=True)
        log.info("style transfer results in %s", out_dir)

    # ------------------------------------------------------------------
    def run_lpips(self) -> Dict[str, Dict[int, float]]:
        """The LPIPS calibration stage: per-timestep LPIPS(x_t, x0) and
        LPIPS(x0_t, x0) over a 1000-step (--n_inv_step) inversion of the
        training images; the four tsvs go to {work_dir}/utils/, where
        `set_interval` reads them. Under --dp each rank inverts its rows of
        every batch, under spatial sharding its rows of each image (the LPIPS
        net takes the gathered images)."""
        a = self.args
        if self.lpips_net is None:
            raise RuntimeError("LPIPS weights are required for the calibration stage: pass "
                               "--lpips_ckpt (an npz of the lpips package's AlexNet + lin "
                               "weights, converted by losses.lpips.params_from_torch)")
        model = self.load_pretrained()
        train_ds, _ = self._datasets()
        name = getattr(a, "custom_dataset_name", None) or _dataset_key(self.config)
        # the reference processes n_train_img + 1 images: its loop breaks on
        # `step == n_train_img` after processing that step
        # (diffusion_latent.py:1276-1278)
        with self._sharded():
            return compute_lpips_distance(
                self.spec, model, self.schedule, train_ds, self.lpips_net,
                n_img=a.n_train_img + 1, n_inv_step=a.n_inv_step, t_0=a.t_0,
                batch_size=a.bs_train, out_dir=self._dir("utils"), dataset_name=name,
                compute_dtype=self.compute_dtype, mesh=self.mesh)

    def run_fidelity(self) -> Dict[str, Any]:
        """The fidelity runbook: invert→edit every test image
        (`engine.make_invert_edit`, per --bs_train batch) with a trained Δ
        checkpoint, write `{exp}/fidelity/test_{i}.png`, and, given
        --fidelity_ref_dir with the reference's outputs under the same
        names, write the LPIPS report `lpips_report.json` (gate: mean ≤
        0.01). Every missing artefact is reported at once. Under --dp each
        batch is padded to the data axis and its outputs sliced back; under
        spatial sharding each rank runs its rows and the outputs are fetched
        whole."""
        a = self.args
        missing = []
        if not getattr(a, "model_path", None) and not getattr(a, "allow_random_weights", False):
            missing.append("base diffusion ckpt: --model_path <ckpt>")
        elif getattr(a, "model_path", None) and not os.path.exists(a.model_path):
            missing.append(f"base diffusion ckpt: --model_path {a.model_path!r} not found")
        # the precedence of run_test: manual > choose_checkpoint_num > exp name
        if getattr(a, "manual_checkpoint_name", None):
            ckpt = os.path.join(self._dir("checkpoint"), a.manual_checkpoint_name)
        elif getattr(a, "choose_checkpoint_num", None):
            ckpt = self._ckpt_path(a.n_iter - 1, a.choose_checkpoint_num)
        else:
            ckpt = self._ckpt_path(a.n_iter - 1)
        if not os.path.exists(ckpt):
            missing.append(f"trained Δ checkpoint: {ckpt} (the reference's released .pth "
                           "load as they are)")
        ref_dir = getattr(a, "fidelity_ref_dir", None)
        if ref_dir and self.lpips_net is None:
            missing.append("LPIPS weights: --lpips_ckpt (npz converted by "
                           "losses.lpips.params_from_torch from the lpips package's AlexNet "
                           "+ lin heads)")
        if ref_dir and not os.path.isdir(ref_dir):
            missing.append(f"reference outputs: --fidelity_ref_dir {ref_dir!r} not found")
        if missing:
            raise FileNotFoundError("fidelity runbook is missing artifacts:\n  - "
                                    + "\n  - ".join(missing))

        self.set_interval()
        model = self.load_pretrained()
        n_train_eff = a.n_train_step or a.t_0
        n_test_eff = a.n_test_step or a.t_0
        scaling = n_train_eff / n_test_eff * a.hs_coeff_delta_h
        if "blocks" not in delta_ckpt.load_delta_checkpoint(ckpt):
            raise ValueError("the fidelity runbook expects a DeltaBlock checkpoint "
                             "(--train_delta_block, the released format)")
        edit = EditState(
            blocks=(self._load_blocks(ckpt),),
            hs_coeff=torch.tensor([1.0 * a.hs_coeff_origin_h, 1.0 * scaling], device=self.device),
            flavor=self.spec.delta_flavor, ignore_timestep=a.ignore_timesteps)
        run = engine.make_invert_edit(
            self.spec, self.schedule, uniform_seq(a.n_inv_step, a.t_0),
            uniform_seq(a.n_test_step, a.t_0), t_edit=self.t_edit, t_addnoise=self.t_addnoise,
            compute_dtype=self.compute_dtype)
        _, test_ds = self._datasets()
        out_dir = self._dir(os.path.join(a.exp, "fidelity"))
        n = min(a.n_test_img, len(test_ds))
        for ofs in range(0, n, a.bs_train):
            idxs = list(range(ofs, min(ofs + a.bs_train, n)))
            x0 = np.stack([np.asarray(test_ds[i]) for i in idxs])
            x_dev, n_real = self.mesh.put_padded(x0)
            with self._sharded():
                x = run(model, edit, x_dev, *self._noise(
                    (x_dev.shape[0] * self.mesh.data,) + x0.shape[1:], n_real))
            out = self.mesh.fetch(x)[:n_real]
            for k, i in enumerate(idxs):
                # one H x W image, as torchvision's save_image writes a single
                # image (the JAX runbook's one-image grid is 8 columns wide)
                if self.mesh.is_writer:
                    save_image(out[k], os.path.join(out_dir, f"test_{i}.png"), pm1=True)
        log.info("fidelity outputs: %s (%d images)", out_dir, n)
        if not ref_dir:
            return {"out_dir": out_dir, "n": n}

        self.mesh.barrier()  # the writer's outputs are on disk before any rank reads them
        report = compare_output_dirs(out_dir, ref_dir, self.lpips_net)
        report_path = os.path.join(out_dir, "lpips_report.json")
        if self.mesh.is_writer:
            with open(report_path, "w") as f:
                json.dump(report, f, indent=1)
        log.info("fidelity LPIPS mean=%.4f max=%.4f n=%d -> %s (gate: mean <= 0.01)",
                 report["mean"], report["max"], report["n"], report_path)
        return report


def _dataset_key(config) -> str:
    return {
        "CelebA_HQ": "celeba", "CUSTOM": "celeba", "CelebA_HQ_Dialog": "celeba",
        "LSUN_church_outdoor": "church", "LSUN_bedroom": "bedroom", "AFHQ": "afhq",
        "FFHQ": "afhq", "MetFACE": "metface", "CelebA_HQ_P2": "metface", "IMAGENET": "celeba",
    }.get(_route_key(config), "celeba")
