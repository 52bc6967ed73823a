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
  * normal(key, shape) in f32 (`_normal_real`): the bits of the whole shape
    are hi ^ lo of threefry2x32(key, (0, iota)), iota the row-major index;
    the uniform is taken on (nextafter(-1, +inf), 1), where hi - lo rounds
    to 2 and the FMA changes nothing; then sqrt(2) * erf_inv(u) with XLA's
    f32 erf_inv (Giles' single-precision polynomials, Horner steps
    contracted to FMAs). The bits and the uniforms are bit-equal to JAX's.
    XLA's f32 log1p is its own approximation, so the normals are not: here
    log1p is taken in float64 and rounded once, and the normals agree with
    JAX's within NORMAL_ATOL (under 1 % of draws differ, by one ulp).

The normal draw is made in torch on any device (`normal_torch`): threefry
in int64 arithmetic masked to 32 bits, bit-equal to the numpy
`threefry2x32` here; `normal` is the same draw on the host.
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


# |normal - jax.random.normal| over the draws (values up to ~5.5): one ulp
# where XLA's f32 log1p and a correctly rounded one part (module docstring)
NORMAL_ATOL = 1e-6

_SQRT2 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# XLA's ErfInv32 coefficients (f32 values), highest power first: w < 5, then w >= 5
_ERFINV_LT5 = [float(c) for c in np.float32(
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))]
_ERFINV_GE5 = [float(c) for c in np.float32(
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))]
_MASK32 = 0xFFFFFFFF


def threefry2x32_torch(k0, k1, x0, x1):
    """`threefry2x32` on int64 tensors holding uint32 values (masked to 32
    bits after every add), broadcast together, on their own device."""
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) & _MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def normal_bits_torch(keys, shape):
    """The 32 random bits of a normal draw per key: `keys` an int64 tensor
    [B, 2] of uint32 values -> int64 [B, prod(shape)] on its device."""
    import torch

    n = int(np.prod(tuple(shape)))
    iota = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    hi, lo = threefry2x32_torch(keys[:, :1], keys[:, 1:], torch.zeros_like(iota), iota)
    return hi ^ lo


def normal_uniforms_torch(bits):
    """The f32 uniforms on (nextafter(-1, +inf), 1) of `normal_bits_torch`'s
    bits: f in [0, 1) times 2 (hi - lo rounds to 2: exact), plus lo."""
    import torch

    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * 2.0 + _NORMAL_LO, _NORMAL_LO)


def _erfinv_f32_torch(u):
    """XLA's f32 erf_inv (module docstring) without its |u| == 1 case (the
    uniforms never reach it): log1p and the square root in float64 rounded
    once (correctly rounded on every device), each Horner step as an FMA."""
    import torch

    w = (-torch.log1p(-(u * u).double())).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).float()
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (torch.where(lt, c_lt, c_ge).double() + p.double() * w).float()
    return p * u


def normal_torch(keys, shape):
    """`jax.random.normal(key, shape, float32)` for each key of `keys`
    (int64 [B, 2] of uint32 values): f32 [B, *shape] on the keys' device."""
    u = normal_uniforms_torch(normal_bits_torch(keys, shape))
    return (_SQRT2 * _erfinv_f32_torch(u)).reshape((keys.shape[0],) + tuple(int(s) for s in shape))


def normal(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)` for one raw key [2], drawn
    on the host (`normal_torch` on the CPU)."""
    import torch

    keys = torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64)[None])
    return normal_torch(keys, shape)[0].numpy()
