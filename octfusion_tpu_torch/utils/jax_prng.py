"""JAX's default random-number generator in numpy: threefry-2x32 keys,
``split``, 32-bit ``random_bits`` and float32 ``uniform`` / ``normal``,
drawing what ``jax.random`` draws under its defaults
(``jax_default_prng_impl="threefry2x32"``,
``jax_threefry_partitionable=True``).

The port imports no JAX, yet a few of the reference's fixed weights are
``jax.random`` draws (the stand-in FID network's,
``metrics/fid.standin_weights``); this module draws them again.  Keys,
splits, bits and uniforms are bit for bit JAX's.  ``normal`` follows
XLA's float32 ``erf_inv`` (Giles' single-precision polynomial); XLA:CPU's
own float32 ``log1p`` differs from numpy's by up to 2 ulp, so a normal
draw may differ from JAX's by a few ulp.
"""

from __future__ import annotations

import math

import numpy as np

_U32 = np.uint32
# threefry-2x32 rotations, alternating by group of four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2) -> two uint32 arrays."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(_PARITY))
    x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << _U32(r)) | (x[1] >> _U32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed {seed} must be non-negative")
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def _hash_iota(k: np.ndarray, shape):
    """The hash of the row-major index of every element of ``shape``, as
    a 64-bit counter split into (high, low) words."""
    idx = np.arange(math.prod(shape), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    return threefry2x32(k[0], k[1], hi, lo)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)`` -> [num, 2] uint32 keys."""
    b1, b2 = _hash_iota(k, (num,))
    return np.stack([b1, b2], axis=-1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(k, shape, uint32)``."""
    b1, b2 = _hash_iota(k, tuple(shape))
    return (b1 ^ b2).reshape(shape)


def uniform(k: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: 23 random
    mantissa bits under the exponent of 1.0, minus 1, scaled."""
    bits = random_bits(k, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


# XLA's float32 erf_inv: Giles, "Approximating the erfinv function" (GPU
# Computing Gems), highest power first, for w < 5 and for w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """float32 ``erf_inv`` as XLA computes it: ``w = -log1p(-x^2)`` (here
    in float64, rounded), the degree-8 polynomial in float32 steps with
    fused multiply-adds, ``+-inf`` at ``|x| = 1``."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    w64 = w.astype(np.float64)
    p = np.where(small, np.float32(_ERFINV_SMALL[0]),
                 np.float32(_ERFINV_LARGE[0]))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, np.float32(cs), np.float32(cl))
        # a fused multiply-add: the float32 product is exact in float64
        p = (c.astype(np.float64) + p.astype(np.float64) * w64).astype(
            np.float32)
    out = p * x
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, out)


def normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(k, shape, float32)``: ``sqrt(2) erf_inv(u)``
    of a uniform u on (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, shape, lo, 1.0)
    return np.float32(math.sqrt(2.0)) * erfinv_f32(u)
