"""The port's augmentation draws and tail (ops/prng.py, ops/augment.py)
against the JAX package's (mgproto_tpu/ops/augment.py), on the CPU.

Tolerances:
  * draws (`split`, `uniform` over the two jitter ranges and [0, 1),
    `bernoulli`): bit for bit with `jax.random` on 2048 seeded keys.
  * each `adjust_*` op and `normalize_u8` at fixed factors, and the whole
    `augment_tail` from loader seeds on 224 px uint8 batches of noise and of
    smooth blocks: bit for bit with the JAX functions run op by op (every
    jnp op its own XLA computation), reported within 1e-6 absolute in
    normalized units. The contrast op's rounded mean luma is asserted equal
    image by image; a .5 tie that the two reductions round apart fails the
    test with the image's unrounded means.
  * the same tail under `jax.jit`, as the JAX train step runs it: XLA on the
    CPU fuses the tail and contracts a * b + c into one rounding, so it
    differs from both op-by-op paths by a few f32 ulps of the 0..255 values
    before normalization: within 2e-5 absolute in normalized units (one ulp
    at 255 is 1.5e-5 u8 units, 2.7e-7 normalized).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgproto_tpu.ops import augment as ja
from mgproto_tpu_torch.data.loader import augment_seeds
from mgproto_tpu_torch.ops import augment as ta
from mgproto_tpu_torch.ops import prng

N_KEYS = 2048
ATOL = 1e-6
JIT_ATOL = 2e-5


def _keys(seed):
    seeds = np.random.default_rng(seed).integers(0, 2 ** 32, size=N_KEYS, dtype=np.uint64)
    seeds = seeds.astype(np.uint32)
    return np.stack([np.full_like(seeds, ta.KEY_TAG), seeds], axis=-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_matches_jax(seed):
    keys = _keys(seed)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 5))(jnp.asarray(keys)))
    np.testing.assert_array_equal(prng.split(keys, 5), want)


@pytest.mark.parametrize("lo,hi", [(0.6, 1.4), (-0.02, 0.02), (0.0, 1.0)])
def test_uniform_matches_jax(lo, hi):
    keys = prng.split(_keys(2), 5)[:, 1]
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (), jnp.float32, lo, hi))(jnp.asarray(keys)))
    got = prng.uniform(keys, lo, hi)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_uniform_scale_needs_one_rounding():
    """f * (hi - lo) + lo rounded once (as the port does) matches JAX; the
    same expression with two f32 roundings does not."""
    keys = prng.split(_keys(3), 5)[:, 1]
    lo, hi = np.float32(0.6), np.float32(1.4)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (), jnp.float32, lo, hi))(jnp.asarray(keys)))
    bits = (prng.random_bits(keys) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    twice = np.maximum(lo, f * (hi - lo) + lo)  # two f32 roundings
    assert (twice != want).sum() > N_KEYS // 10
    np.testing.assert_array_equal(prng.uniform(keys, lo, hi), want)


def test_bernoulli_matches_jax():
    keys = prng.split(_keys(4), 5)[:, 0]
    want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, 0.5))(jnp.asarray(keys)))
    got = prng.bernoulli(keys, 0.5)
    np.testing.assert_array_equal(got, want)
    assert 0.4 < got.mean() < 0.6


def test_augment_draws_match_jax_draws():
    """The [B, 5] draws are the values JAX's augment_tail draws."""
    seeds = augment_seeds(7, 1, np.arange(64))
    keys = ja._keys_from_seeds(jnp.asarray(seeds))
    sub = jax.vmap(lambda k: jax.random.split(k, 5))(keys)
    want = [np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, ja.FLIP_P))(sub[:, 0]))]
    for col, (lo, hi) in enumerate((ja.BRIGHTNESS, ja.CONTRAST, ja.SATURATION, ja.HUE), 1):
        want.append(np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (), jnp.float32, lo, hi))(sub[:, col])))
    got = ta.augment_draws(seeds)
    assert got.shape == (64, 5) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0], want[0].astype(np.float32))
    for col in range(1, 5):
        np.testing.assert_array_equal(got[:, col], want[col])


def _pixels(seed, b=4, hw=32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(b, hw, hw, 3)).astype(np.float32)


@pytest.mark.parametrize("op", ["adjust_brightness", "adjust_contrast", "adjust_saturation"])
def test_blend_ops_match_jax(op):
    x = _pixels(5)
    f = np.array([0.6, 0.93, 1.0, 1.4], np.float32)[:, None, None, None]
    want = np.asarray(getattr(ja, op)(jnp.asarray(x), jnp.asarray(f)))
    got = getattr(ta, op)(torch.from_numpy(x), torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got, want)


def test_hue_matches_jax():
    x = np.concatenate([_pixels(6), np.repeat(_pixels(7)[..., :1], 3, -1)])  # + grey pixels
    f = np.linspace(-0.02, 0.02, len(x), dtype=np.float32)[:, None, None]
    want = np.asarray(ja.adjust_hue(jnp.asarray(x), jnp.asarray(f)))
    got = ta.adjust_hue(torch.from_numpy(x), torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got, want)


def test_normalize_u8_matches_jax():
    u8 = np.random.default_rng(8).integers(0, 256, size=(2, 16, 16, 3), dtype=np.uint8)
    want = np.asarray(ja.normalize_u8(jnp.asarray(u8)))
    np.testing.assert_array_equal(ta.normalize_u8(torch.from_numpy(u8)).numpy(), want)


def _batch(kind):
    rng = np.random.default_rng(9)
    if kind == "noise":
        return rng.integers(0, 256, size=(16, 224, 224, 3), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(16, 28, 28, 3), dtype=np.uint8)
    return np.repeat(np.repeat(blocks, 8, axis=1), 8, axis=2)  # smooth 8x8 blocks


def _contrast_input(images, draws):
    """The tail's input to the contrast op: the brightness-jittered batch."""
    return np.clip(draws[:, 1, None, None, None] * images.astype(np.float32), 0.0, 255.0)


@pytest.mark.parametrize("kind", ["noise", "blocks"])
def test_augment_tail_matches_jax(kind):
    images = _batch(kind)
    seeds = augment_seeds(0, 3, np.arange(len(images)))
    draws = ta.augment_draws(seeds)

    # the contrast op's rounded mean luma, image by image
    x = _contrast_input(images, draws)
    jlum = np.asarray(jnp.mean(ja._luma(jnp.asarray(x)), axis=(-2, -1)))
    tlum = ta._luma(torch.from_numpy(x)).mean(dim=(-2, -1)).numpy()
    jdeg, tdeg = np.round(jlum), ta.contrast_degenerate(torch.from_numpy(x)).numpy().reshape(-1)
    differ = np.nonzero(jdeg != tdeg)[0]
    assert differ.size == 0, (
        f"rounded mean luma differs at images {differ.tolist()}: JAX means "
        f"{jlum[differ].tolist()}, port means {tlum[differ].tolist()}")

    want = np.asarray(ja.augment_tail(jnp.asarray(images), jnp.asarray(seeds)))
    got = ta.augment_tail(torch.from_numpy(images), torch.from_numpy(draws)).numpy()
    assert got.shape == images.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got, want)
    # half the batch flipped, and the flip is the mirror of the unflipped
    flipped = draws[:, 0] != 0
    assert 0 < flipped.sum() < len(images)
    noflip = ta.augment_tail(torch.from_numpy(images),
                             torch.from_numpy(np.where(np.arange(5) == 0, 0.0, draws)))
    np.testing.assert_array_equal(got[flipped], noflip.numpy()[flipped][:, :, ::-1])

    jitted = np.asarray(jax.jit(ja.augment_tail)(jnp.asarray(images), jnp.asarray(seeds)))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=JIT_ATOL)


def test_resolve_device_augment():
    assert ta.resolve_device_augment(None, torch.device("cuda")) is True
    assert ta.resolve_device_augment(None, torch.device("cpu")) is False
    assert ta.resolve_device_augment(True, torch.device("cpu")) is True
    assert ta.resolve_device_augment(False, torch.device("cuda")) is False
