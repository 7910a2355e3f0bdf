"""The reference's default random init, reproduced in NumPy.

The JAX package draws a fit's initial factors with
``jax.random.split(jax.random.PRNGKey(seed))`` and ``jax.random.normal``
(``models/als.py::ALS._init_factors_host``). This module computes the same
draws without JAX, for JAX 0.9's default generator: threefry2x32 with
``jax_threefry_partitionable=True`` (the default since JAX 0.5), 32-bit
keys (``jax_enable_x64`` off).

- ``prng_key(seed)`` is ``jax.random.key_data(jax.random.PRNGKey(seed))``,
  ``split(key, n)`` is ``key_data(jax.random.split(key, n))`` and
  ``random_bits`` is ``jax.random.bits``: bit for bit.
- ``normal(key, shape)`` is ``jax.random.normal(key, shape)`` in float32 to
  within a few ulps. Its uniform draw is bit for bit; ``erf_inv`` follows
  XLA's float32 polynomial (``ErfInv32``, two branches at ``w = 5``), but
  NumPy's float32 ``log1p`` and ``sqrt`` and XLA's own differ by an ulp at
  some inputs, and the difference carries through the polynomial
  (measured: at most 3 ulps, tests/test_torch_init.py).

Vectorised over uint32 arrays, the cipher's rounds in place over chunks
that stay in cache (the ML-25M init draws 14.4 M values).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_CHUNK = 1 << 16

# XLA's ErfInv32 coefficients (Giles), highest degree first, for
# w = -log1p(-x^2) < 5 and >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 block cipher (20 rounds) of the counters (x0, x1)
    under ``key`` (two uint32): JAX's ``threefry2x32_p``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    t = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=t)   # x1 = rotl(x1) ^ x0
            x1 >>= np.uint32(32 - r)
            x1 |= t
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _bits(key, start: int, stop: int):
    """threefry2x32 of the flat indices start .. stop - 1, counted as JAX's
    ``iota_2x32_shape`` counts them (high and low 32 bits)."""
    i = np.arange(start, stop, dtype=np.uint64)
    return threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                        i.astype(np.uint32))


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key data: (0, seed mod 2^32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``'s key data, (n, 2) uint32."""
    return np.stack(_bits(key, 0, n), axis=1)


def random_bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32)."""
    n = int(np.prod(shape, dtype=np.int64))
    out = np.empty(n, np.uint32)
    for s in range(0, n, _CHUNK):
        b0, b1 = _bits(key, s, min(s + _CHUNK, n))
        np.bitwise_xor(b0, b1, out=out[s:s + _CHUNK])
    return out.reshape(shape)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's ErfInv32 for |x| < 1 (``normal``'s uniform never reaches 1)."""
    w = -np.log1p(-x * x)
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, np.float32(a), np.float32(b)) + p * w
    return p * x


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: a uniform draw on
    [nextafter(-1, 0), 1) from the top 23 bits, then sqrt(2) erfinv."""
    bits = random_bits(key, shape)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    one = np.float32(1)
    u = (bits >> np.uint32(9) | one.view(np.uint32)).view(np.float32) - one
    u = np.maximum(lo, u * (one - lo) + lo)
    return np.float32(np.sqrt(2)) * _erfinv_f32(u)


__all__ = ["threefry2x32", "prng_key", "split", "random_bits", "normal"]
