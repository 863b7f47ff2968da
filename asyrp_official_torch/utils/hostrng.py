"""Host-side (numpy) threefry2x32 PRNG — the port's copy of the numpy path
of the JAX package's `utils/hostrng.py`. It gives the same bits as
`jax.random.split` / `jax.random.uniform` / `jax.random.normal`
(threefry_partitionable) on the CPU backend, so a seed gives the port the
same random init as the JAX package.

Keys are `np.ndarray` of shape (2,), dtype uint32.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PRNGKey", "split", "random_bits", "uniform", "normal"]

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


def _fma(a, b, c) -> np.ndarray:
    """f32 a·b + c with one rounding (the f64 product of two f32 is exact),
    as XLA:CPU contracts a multiply feeding an add."""
    return (np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32)
            + np.asarray(c, np.float32)).astype(np.float32)


# XLA:CPU's f32 log (Cephes logf): p0..p8, then q1 and q2 of ln 2 = q2 - q1
_LOG_P = tuple(np.float32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)
# XLA's log1p below sqrt(2) - 1: a Cephes rational in x
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA's f32 erf_inv (Giles): coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _log_f32(x: np.ndarray) -> np.ndarray:
    """XLA:CPU's f32 natural log of x > 0."""
    f32 = np.float32
    x = np.maximum(x, np.finfo(f32).tiny).astype(f32)
    bits = x.view(np.int32)
    e = ((bits >> 23).astype(f32) - f32(126)).astype(f32)
    m = ((bits & ~0x7F800000) | f32(0.5).view(np.int32)).view(f32)  # mantissa in [0.5, 1)
    low = m < f32(0.707106781186547524)
    m = ((m - f32(1)) + np.where(low, m, f32(0))).astype(f32)
    e = (e - low.astype(f32)).astype(f32)
    m2 = (m * m).astype(f32)
    m3 = (m2 * m).astype(f32)
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, m3, y1), m3, y2)
    y = _fma(y, m3, (_LOG_Q1 * e).astype(f32))
    m = _fma(-m2, f32(0.5), m)
    return _fma(_LOG_Q2, e, (m + y).astype(f32))


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA:CPU's f32 log1p: a rational for |x| < sqrt(2) - 1, else log(1 + x)."""
    f32 = np.float32
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for cn, cd in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = _fma(num, x, f32(cn))
        den = _fma(den, x, f32(cd))
    x2 = (x * x).astype(f32)
    small = ((x * x2).astype(f32) * (num / den).astype(f32)).astype(f32)
    small = (x + _fma(f32(-0.5), x2, small)).astype(f32)
    with np.errstate(invalid="ignore", divide="ignore"):
        large = _log_f32((x + f32(1)).astype(f32))
    return np.where(np.abs(x) < f32(0.41421356237309504880), small, large)


def _erf_inv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erf_inv on (-1, 1): w = -log1p(-x²), then one of two
    degree-8 polynomials in w - 2.5 or sqrt(w) - 3."""
    f32 = np.float32
    w = -_log1p_f32(-(x * x).astype(f32))
    lt = w < f32(5)
    w = np.where(lt, (w - f32(2.5)).astype(f32), (np.sqrt(w) - f32(3)).astype(f32))
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, f32(c_lt), f32(c_ge)))
    return (p * x).astype(f32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """== jax.random.normal for float32 on the CPU backend: a uniform in
    (nextafter(-1, 0), 1), then sqrt(2)·erf_inv, with XLA:CPU's f32 log1p
    and erf_inv polynomials and its fused multiply-adds."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, np.float32, lo, 1.0)
    return (np.float32(np.sqrt(2)) * _erf_inv_f32(u)).astype(np.float32)
