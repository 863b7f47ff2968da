"""Host-side (numpy) threefry2x32 PRNG — the port's copy of the numpy path
of the JAX package's `utils/hostrng.py`. It gives the same bits as
`jax.random.split` / `jax.random.uniform` (threefry_partitionable), so a
seed gives the port the same random init as the JAX package.

Keys are `np.ndarray` of shape (2,), dtype uint32.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PRNGKey", "split", "random_bits", "uniform"]

_U32 = np.uint32


def PRNGKey(seed: int) -> np.ndarray:
    """Raw threefry key from an integer seed; the seed is clipped to 32
    bits, so the hi word is always 0."""
    if not np.issubdtype(type(seed), np.integer) and not isinstance(seed, int):
        raise TypeError(f"PRNG key seed must be an integer; got {seed!r}")
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=_U32)


_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _threefry_core(k1, k2, x0, x1, tmp):
    """Threefry-2x32-20 rounds in place on uint32 arrays x0/x1 (5 key
    injections over alternating round quadruples); `tmp` is scratch of the
    same shape."""
    ks = (k1, k2, _U32(k1 ^ k2 ^ _U32(0x1BD11BDA)))
    x0 += ks[0]
    x1 += ks[1]
    rots = (_ROT_A, _ROT_B)
    for i in range(5):
        for r in rots[i % 2]:
            x0 += x1
            np.left_shift(x1, _U32(r), out=tmp)
            np.right_shift(x1, _U32(32 - r), out=x1)
            np.bitwise_or(tmp, x1, out=x1)
            np.bitwise_xor(x0, x1, out=x1)
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += _U32(i + 1)


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32-20 hash of the count pair; returns the output pair."""
    a = np.array(x1, dtype=_U32, copy=True)
    b = np.array(x2, dtype=_U32, copy=True)
    _threefry_core(_U32(k1), _U32(k2), a, b, np.empty_like(b))
    return a, b


# chunks whose four working arrays (~16 bytes per element) stay in L2
_CHUNK = 1 << 18


def _iota_2x32(shape):
    """(hi32, lo32) of the flat row-major position iota."""
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    idx = np.arange(size, dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(_U32), idx.astype(_U32)


def split(key: np.ndarray, num=2) -> np.ndarray:
    """== jax.random.split under threefry_partitionable."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    c1, c2 = _iota_2x32(shape)
    b1, b2 = threefry2x32(key[0], key[1], c1, c2)
    return np.stack([b1, b2], axis=b1.ndim).astype(_U32)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32-bit uniform bits (bits1 ^ bits2 of the position iota's hash),
    computed in L2-sized chunks."""
    shape = tuple(shape)
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    k1, k2 = _U32(key[0]), _U32(key[1])
    out = np.empty(size, _U32)
    b1 = np.empty(_CHUNK, _U32)
    tmp = np.empty(_CHUNK, _U32)
    for s in range(0, size, _CHUNK):
        e = min(size, s + _CHUNK)
        n = e - s
        idx = np.arange(s, e, dtype=np.uint64)
        a = b1[:n]
        a[:] = idx >> np.uint64(32)
        b = out[s:e]
        b[:] = (idx & np.uint64(0xFFFFFFFF))
        _threefry_core(k1, k2, a, b, tmp[:n])
        np.bitwise_xor(a, b, out=b)
    return out.reshape(shape)


def uniform(key: np.ndarray, shape, dtype=np.float32, minval=0.0, maxval=1.0) -> np.ndarray:
    """== jax.random.uniform for float32: random mantissa under exponent 1,
    minus 1, affine to [minval, maxval) as a float64 multiply-add (which
    reproduces XLA's f32 FMA), clamped at minval."""
    if np.dtype(dtype) != np.float32:
        raise NotImplementedError("hostrng.uniform is float32-only")
    bits = random_bits(key, tuple(shape))
    one_bits = np.float32(1.0).view(_U32)
    float_bits = (bits >> _U32(32 - 23)) | one_bits
    floats = float_bits.view(np.float32) - np.float32(1.0)
    minval = np.float32(minval)
    maxval = np.float32(maxval)
    fma = (floats.astype(np.float64) * np.float64(maxval - minval)
           + np.float64(minval)).astype(np.float32)
    return np.maximum(minval, fma)
