"""The port's corruption ladder (mgproto_tpu_torch/ops/corrupt.py) and its
normal draws (ops/prng.py `normal`, `normal_torch`) against the JAX
package's ops/corrupt.py and jax.random, on the CPU.

Tolerances:
  * the threefry bits and the uniforms of `jax.random.normal` are bit-equal;
    the normals are within `prng.NORMAL_ATOL` (1e-6: XLA's f32 log1p inside
    its erf_inv is its own approximation; measured 4.8e-7, one ulp, in
    under 1 % of draws); a batch of keys draws what each key draws alone;
  * every (kind, severity) cell within CORRUPT_ATOL (1e-6; measured at most
    4.8e-7: the noise draw above, blur's and the mean's summation orders,
    the antialiased resize) at 16 px and at 32 px, where pixelate's factors
    3 and 6 do not divide the size.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mgproto_tpu.ops import corrupt as jcorrupt
from mgproto_tpu_torch.ops import corrupt as tcorrupt
from mgproto_tpu_torch.ops import prng

CORRUPT_ATOL = 1e-6
CELLS = [(k, s) for k in jcorrupt.CORRUPTION_KINDS for s in jcorrupt.SEVERITIES]
KEYS = [(0x6D675F63, 0), (0x6D675F63, 12345), (0x6D675F63, 0xFFFFFFFF), (7, 2**31 + 7)]


def _images(hw, n=3, seed=0):
    return np.random.RandomState(seed).randn(n, hw, hw, 3).astype(np.float32)


@pytest.mark.parametrize("key", KEYS)
def test_normal_bits_and_uniforms_bit_equal_to_jax(key):
    key = np.asarray(key, np.uint32)
    shape = (24, 24, 3)
    jkey = jnp.asarray(key)
    want_bits = np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).ravel()
    hi, lo = prng.threefry2x32(key, np.uint32(0), np.arange(want_bits.size, dtype=np.uint32))
    np.testing.assert_array_equal(hi ^ lo, want_bits)
    got_bits = prng.normal_bits_torch(torch.from_numpy(key.astype(np.int64))[None], shape)
    np.testing.assert_array_equal(got_bits[0].numpy().astype(np.uint32), want_bits)
    lo_bound = np.nextafter(np.float32(-1.0), np.float32(0.0))
    want_u = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo_bound, 1.0))
    np.testing.assert_array_equal(prng.normal_uniforms_torch(got_bits)[0].numpy(), want_u.ravel())


@pytest.mark.parametrize("key", KEYS)
def test_normals_within_tolerance_of_jax_and_batched_alike(key):
    key = np.asarray(key, np.uint32)
    shape = (48, 48, 3)
    want = np.asarray(jax.random.normal(jnp.asarray(key), shape, jnp.float32))
    got = prng.normal(key, shape)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=prng.NORMAL_ATOL)
    assert (got != want).mean() < 0.02
    both = prng.normal_torch(torch.from_numpy(np.stack([key, key[::-1]]).astype(np.int64)), shape)
    np.testing.assert_array_equal(both[0].numpy(), got)
    np.testing.assert_array_equal(both[1].numpy(), prng.normal(key[::-1], shape))
    # the f32 erf_inv against XLA's on the same uniforms: one ulp at most
    u = prng.normal_uniforms_torch(prng.normal_bits_torch(
        torch.from_numpy(key.astype(np.int64))[None], shape))[0]
    want_e = np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy())))
    got_e = prng._erfinv_f32_torch(u).numpy()
    np.testing.assert_allclose(got_e, want_e, rtol=0, atol=prng.NORMAL_ATOL)


def test_per_sample_seeds_equal_jax():
    for seed, count, offset in ((0, 5, 0), (3, 8, 16), (2**40 + 9, 4, 2**32 - 2)):
        np.testing.assert_array_equal(tcorrupt.per_sample_seeds(seed, count, offset),
                                      jcorrupt.per_sample_seeds(seed, count, offset))
    assert tcorrupt.CORRUPTION_KINDS == jcorrupt.CORRUPTION_KINDS
    assert tcorrupt.SEVERITIES == jcorrupt.SEVERITIES
    assert tcorrupt._KEY_TAG == jcorrupt._KEY_TAG


@pytest.mark.parametrize("hw", [16, 32])
@pytest.mark.parametrize("kind,severity", CELLS)
def test_ladder_cell_matches_jax(kind, severity, hw):
    x = _images(hw, seed=hw)
    want = jcorrupt.corrupt_numpy(x, kind, severity, seed=5)
    got = tcorrupt.corrupt_numpy(x, kind, severity, seed=5, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=CORRUPT_ATOL)


def test_pixelate_upsample_is_nearest_exact_not_nearest():
    """At 32 px and factor 3 (severity 2) the plain "nearest" upsample
    would pick other source pixels; the port's cell matches JAX's."""
    x = _images(32, n=1, seed=1)
    want = jcorrupt.corrupt_numpy(x, "pixelate", 2)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    down = torch.nn.functional.interpolate(t, size=(10, 10), mode="bilinear",
                                           align_corners=False, antialias=True)
    plain = torch.nn.functional.interpolate(down, size=(32, 32), mode="nearest")
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 0.1
    np.testing.assert_allclose(tcorrupt.corrupt_numpy(x, "pixelate", 2, device="cpu"), want,
                               rtol=0, atol=CORRUPT_ATOL)


def test_corrupt_ladder_shapes_finite_deterministic():
    """tests/test_trust.py's ladder case on the port: every rung perturbs,
    at least as much as the rung before; noise is seeded; unknown kinds and
    severities raise ValueError."""
    x = np.random.RandomState(0).randn(4, 16, 16, 3).astype(np.float32)
    for kind in tcorrupt.CORRUPTION_KINDS:
        deltas = []
        for s in tcorrupt.SEVERITIES:
            y = tcorrupt.corrupt_numpy(x, kind, s, seed=3, device="cpu")
            assert y.shape == x.shape and np.isfinite(y).all(), (kind, s)
            assert not np.array_equal(y, x), (kind, s)
            deltas.append(float(np.abs(y - x).mean()))
        assert all(b >= a - 1e-6 for a, b in zip(deltas, deltas[1:])), (kind, deltas)
    a = tcorrupt.corrupt_numpy(x, "noise", 3, seed=7, device="cpu")
    assert np.array_equal(a, tcorrupt.corrupt_numpy(x, "noise", 3, seed=7, device="cpu"))
    assert not np.array_equal(a, tcorrupt.corrupt_numpy(x, "noise", 3, seed=8, device="cpu"))
    with pytest.raises(ValueError):
        tcorrupt.make_corrupt_fn("fog", 1)
    with pytest.raises(ValueError):
        tcorrupt.make_corrupt_fn("noise", 0)


def test_corrupt_fn_takes_tensor_seeds_and_keeps_the_device():
    x = torch.from_numpy(_images(16))
    seeds = tcorrupt.per_sample_seeds(2, 3, offset=8)
    fn = tcorrupt.make_corrupt_fn("noise", 4)
    a = fn(x, seeds)
    b = fn(x, torch.from_numpy(seeds.astype(np.int64)))
    assert a.device == x.device and a.dtype == torch.float32
    assert torch.equal(a, b)
    want = jcorrupt.make_corrupt_fn("noise", 4)(jnp.asarray(x.numpy()), jnp.asarray(seeds))
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=0, atol=CORRUPT_ATOL)
