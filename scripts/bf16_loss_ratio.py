#!/usr/bin/env python3
"""bf16 against f32 Δ-training loss, the JAX package against the port, on
the CPU: one `make_train_step` call (8-step sequence, t_edit 500, one image,
CLIP directional term of a tiny random CLIP, with and without the 3x L1
term) on the same random UNet weights and inputs from one numpy seed.

    JAX_PLATFORMS=cpu python3 scripts/bf16_loss_ratio.py tiny
    JAX_PLATFORMS=cpu python3 scripts/bf16_loss_ratio.py custom CH RES

`tiny` is the tiny DDPM++ workspace config; `custom CH RES` is
`configs/custom.yml` (channel multipliers, blocks, attention) with base
width CH and resolution RES. Prints each package's losses per step and the
ratio of the mean bf16 loss to the mean f32 loss. It reuses the step
helpers of `tests/test_torch_train.py`.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path[:0] = [os.path.join(REPO, "tests"), REPO]
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_train as tt
    from asyrp_official_torch.cli.args import load_config
    from asyrp_official_torch.compat.from_jax import ddpmpp_state_dict_from_jax
    from asyrp_official_torch.losses import clip_loss as pl, clip_model as pm, tokenizer as ptok
    from asyrp_official_torch.models.registry import spec_from_config
    from asyrp_official_tpu.core.schedule import train_seq
    from asyrp_official_tpu.losses import clip_loss as jl, clip_model as jm, tokenizer as jtok
    from asyrp_official_tpu.models import ddpmpp as jddpmpp
    from asyrp_official_tpu.models.registry import ModelSpec
    from asyrp_official_tpu.utils import hostrng

    if sys.argv[1:2] == ["tiny"]:
        spec = tt.SPEC
    elif sys.argv[1:2] == ["custom"] and len(sys.argv) == 4:
        base = spec_from_config(load_config("custom.yml"))
        spec = dataclasses.replace(base, config=dataclasses.replace(
            base.config, ch=int(sys.argv[2]), resolution=int(sys.argv[3])))
    else:
        print(__doc__)
        return 2
    cfg = spec.config
    # the test module's step helpers read these globals
    tt.SPEC, tt.CFG = spec, cfg
    tt.JSPEC = ModelSpec("ddpmpp", jddpmpp.DDPMppConfig(**{f: getattr(cfg, f) for f in (
        "ch", "out_ch", "ch_mult", "num_res_blocks", "attn_resolutions", "dropout",
        "in_channels", "resolution", "resamp_with_conv")}), False, "ddpm")
    params = spec.init(hostrng.PRNGKey(0))
    model = spec.build()
    model.load_state_dict(ddpmpp_state_dict_from_jax(params))
    model.eval().requires_grad_(False)
    clip = pm.CLIP(tt.CLIP_CFG, seed=1).eval().requires_grad_(False)
    jclip, jcfg = jm.params_from_torch({k: v.numpy() for k, v in clip.state_dict().items()})
    rng = np.random.RandomState(0)
    res = cfg.resolution
    s = dict(params=jax.tree.map(jnp.asarray, params), model=model,
             pctx=pl.CLIPContext(clip, tt.CLIP_CFG, ptok.HashTokenizer()),
             jctx=jl.CLIPContext(jclip, jcfg, jtok.HashTokenizer()),
             seq=train_seq(8, 999, tt.T_EDIT)[0],
             x_lat=rng.randn(1, res, res, 3).astype(np.float32),
             x0=rng.uniform(-1, 1, (1, res, res, 3)).astype(np.float32))
    n = sum(v.numel() for v in model.state_dict().values())
    print(f"{sys.argv[1]}: {n} UNet parameters, {res}^2", flush=True)
    for l1_w in (3.0, 0.0):
        means = {}
        for name, jd, td in (("f32", jnp.float32, torch.float32),
                             ("bf16", jnp.bfloat16, torch.bfloat16)):
            t0 = time.perf_counter()
            jax_losses = np.asarray(tt._jax_step(s, jd, l1_w)[0])
            port_losses = np.asarray(tt._port_step(s, cached_origin=False, compute_dtype=td,
                                                   l1_w=l1_w)[0]["loss_per_step"])
            means[name] = (jax_losses.mean(), port_losses.mean())
            print(f"l1_w={l1_w:g} {name}: JAX losses {np.round(jax_losses, 5)}, port "
                  f"{np.round(port_losses, 5)} ({time.perf_counter() - t0:.0f} s)", flush=True)
        for i, pkg in enumerate(("JAX", "port")):
            print(f"l1_w={l1_w:g} {pkg}: mean bf16 loss / mean f32 loss = "
                  f"{means['bf16'][i] / means['f32'][i]:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
