"""Threefry-2x32 draws on the host, as JAX computes them for raw uint32 keys.

The device augmentation tail (ops/augment.py) draws five values per sample
from the loader's seed: a flip bit and four jitter factors. The JAX package
draws them inside its jitted step with `jax.random.split(key, 5)`,
`jax.random.uniform` and `jax.random.bernoulli` on raw `[0x6D675F61, seed]`
uint32 key pairs. Here the same draws are made in numpy uint32 arithmetic on
the host, B x 5 scalars a batch, and shipped to the card with the batch.

What JAX (0.9, `jax_threefry_partitionable` on) computes, and this module
reproduces bit for bit (tests/test_torch_augment.py):
  * threefry2x32(key, (x0, x1)): Random123's 20-round Threefry-2x32 with
    the key schedule word 0x1BD11BDA (jax/_src/prng.py `threefry2x32_p`).
  * split(key, n)[i] = threefry2x32(key, (0, i))  (the counter is a 64-bit
    iota split into its high and low words, `_threefry_split_foldlike`).
  * the 32 random bits of a scalar draw: hi ^ lo of threefry2x32(key, (0, 0))
    (`_threefry_random_bits_partitionable`).
  * uniform(key, lo, hi) in f32: bits >> 9 | 0x3F800000 read as a float in
    [1, 2), minus 1, then f * (hi - lo) + lo, then max(lo, .) (`_uniform`).
    XLA on the CPU fuses f * (hi - lo) + lo into one rounding (an FMA);
    two f32 roundings differ in about a third of the draws by one ulp. The
    product of two f32 values is exact in float64, and for the ranges used
    here (|lo| and hi - lo within a factor 2^5 of each other) so is the
    sum, so float64 arithmetic rounded once to f32 is the FMA.
  * bernoulli(key, p) = uniform(key, 0, 1) < p (mode 'low').
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of counters (x0, x1) under keys `key` [..., 2]; all
    uint32, broadcast together. Returns the two output words."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def split(key: np.ndarray, num: int) -> np.ndarray:
    """`jax.random.split(key, num)` for raw keys [..., 2] -> [..., num, 2]."""
    key = np.asarray(key, np.uint32)[..., None, :]
    hi, lo = threefry2x32(key, np.uint32(0), np.arange(num, dtype=np.uint32))
    return np.stack([hi, lo], axis=-1)


def random_bits(key: np.ndarray) -> np.ndarray:
    """The 32 bits of one scalar draw per key [..., 2] -> [...] uint32."""
    hi, lo = threefry2x32(key, np.uint32(0), np.uint32(0))
    return hi ^ lo


def uniform(key: np.ndarray, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, (), float32, lo, hi)` per key [..., 2]."""
    bits = (random_bits(key) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = hi32 - lo32  # f32, as JAX subtracts the converted bounds
    out = (f.astype(np.float64) * np.float64(span) + np.float64(lo32)).astype(np.float32)
    return np.maximum(lo32, out)


def bernoulli(key: np.ndarray, p: float) -> np.ndarray:
    """`jax.random.bernoulli(key, p)` per key [..., 2] -> bool."""
    return uniform(key) < np.float32(p)
