"""The attention forward kernel's shape contract (`ops/attention.py`
`_check`), on the CPU: every attention the repo's configs build is taken,
at batch 1 and 8, and what the kernel cannot take raises with a message.

The shapes come from each `configs/*.yml` through `models/registry.py`
(widths, `num_head_channels`, attention resolutions), without building a
model: one head of ch * ch_mult[level] channels at each DDPM++ attention
resolution and in the middle block; for the OpenAI UNets the heads of
`heads_for` at each attention rate and in the middle block, checked against
the attention layers of `build_plan`. `_check` needs no GPU.
"""
import glob
import os

import pytest
import torch

from asyrp_official_torch.cli.args import load_config
from asyrp_official_torch.models.openai_unet import build_plan
from asyrp_official_torch.models.registry import spec_from_config
from asyrp_official_torch.ops import attention as k2

CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(
    os.path.dirname(k2.__file__), "..", "configs", "*.yml")))


def attention_shapes(config: str):
    """{(T, C, heads)} of every attention of the config's UNet."""
    spec = spec_from_config(load_config(config))
    cfg = spec.config
    if spec.family == "ddpmpp":
        levels = len(cfg.ch_mult)
        out = {((cfg.resolution >> lv) ** 2, cfg.ch * m, 1)
               for lv, m in enumerate(cfg.ch_mult) if cfg.resolution >> lv in cfg.attn_resolutions}
        out.add(((cfg.resolution >> (levels - 1)) ** 2, cfg.ch * cfg.ch_mult[-1], 1))
        return out
    mc, levels = cfg.model_channels, len(cfg.channel_mult)
    out = {((cfg.image_size >> lv) ** 2, mc * m, cfg.heads_for(mc * m))
           for lv, m in enumerate(cfg.channel_mult) if 2 ** lv in cfg.attention_ds}
    top = mc * cfg.channel_mult[-1]
    out.add(((cfg.image_size >> (levels - 1)) ** 2, top, cfg.heads_for(top)))
    plan = build_plan(cfg)
    layers = [ly for blk in plan["input"] + [plan["middle"]] + plan["output"] for ly in blk
              if ly["kind"] == "attn"]
    assert {(ly["ch"], ly["heads"]) for ly in layers} == {(c, h) for _, c, h in out}
    return out


def test_every_config_is_enumerated():
    assert len(CONFIGS) >= 10
    assert attention_shapes("custom.yml") == {(256, 512, 1), (64, 512, 1)}
    assert attention_shapes("afhq.yml") == {(256, 512, 8), (64, 512, 8)}
    assert (1024, 512, 8) in attention_shapes("imagenet.yml")


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("config", CONFIGS)
def test_check_takes_every_config_shape(config, batch):
    for t, c, heads in sorted(attention_shapes(config)):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.empty(batch, t, c, dtype=dtype)
            assert k2._check(q, torch.empty_like(q), torch.empty_like(q), heads) == (batch, t, c)
        assert -(-(c // heads) // 64) <= 8  # the cluster of one head's blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_shared_memory_fits_a_block(dtype):
    # independent of T and d: 105 KB in bf16, 118 KB in f32
    assert k2._fwd_smem_bytes(dtype) <= k2._SMEM_LIMIT


def _qkv(shape, dtype=torch.float32):
    return tuple(torch.zeros(shape, dtype=dtype) for _ in range(3))


@pytest.mark.parametrize("shape,heads,match", [
    ((1, 64, 72), 1, "multiple of 16"),    # d = 72
    ((1, 64, 520), 1, "multiple of 16"),   # d = 520
    ((1, 64, 1024), 1, "up to 512"),       # one head of 1024
    ((1, 64, 512), 3, "do not split"),
    ((1, 0, 512), 1, "empty"),
])
def test_check_rejects_head_widths(shape, heads, match):
    with pytest.raises(ValueError, match=match):
        k2._check(*_qkv(shape), heads)


def test_check_rejects_mismatched_inputs():
    q, k, v = _qkv((1, 64, 512))
    with pytest.raises(TypeError, match="one dtype"):
        k2._check(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k2._check(*_qkv((1, 64, 512), torch.float16))
    with pytest.raises(ValueError, match="shape"):
        k2._check(q, k[:, :32], v)
    with pytest.raises(ValueError, match="shape"):
        k2._check(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="contiguous"):
        k2._check(q, k, v.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="different devices"):
        k2._check(q, k, torch.empty(1, 64, 512, device="meta"))
