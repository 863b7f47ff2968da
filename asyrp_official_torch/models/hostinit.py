"""Numpy initialisers that reproduce the JAX package's init draws bit for
bit (the JAX `models/common.py` `conv_init` / `linear_init` / `norm_init`
on a numpy key): every draw goes through the port's `utils/hostrng`
threefry, so a seed gives both packages the same weights. The trees are in
the JAX layout (HWIO convs, [in, out] matrices); `compat/from_jax` turns
them into the port's state dicts."""
from __future__ import annotations

import math

import numpy as np

from asyrp_official_torch.utils import hostrng

__all__ = ["conv_init", "linear_init", "norm_init"]


def _kaiming_uniform(key, shape, fan_in, a=math.sqrt(5)):
    gain = math.sqrt(2.0 / (1 + a * a))
    bound = gain * math.sqrt(3.0 / fan_in)
    return hostrng.uniform(key, shape, np.float32, -bound, bound)


def conv_init(key, kh, kw, cin, cout):
    kw_, kb_ = hostrng.split(key)
    fan_in = cin * kh * kw
    bound = 1.0 / math.sqrt(fan_in)
    return {
        "w": _kaiming_uniform(kw_, (kh, kw, cin, cout), fan_in),
        "b": hostrng.uniform(kb_, (cout,), np.float32, -bound, bound),
    }


def linear_init(key, cin, cout):
    kw_, kb_ = hostrng.split(key)
    bound = 1.0 / math.sqrt(cin)
    return {
        "w": _kaiming_uniform(kw_, (cin, cout), cin),
        "b": hostrng.uniform(kb_, (cout,), np.float32, -bound, bound),
    }


def norm_init(ch):
    return {"scale": np.ones((ch,), np.float32), "bias": np.zeros((ch,), np.float32)}
