"""The port's host C++ (mgproto_tpu_torch/native) against its numpy plain
versions and against the JAX package's native library, on the CPU.

Tolerance: none. Every op is integer or f32 arithmetic in a fixed order
(built with -ffp-contract=off), so the port's library, its numpy plain
versions and the JAX package's library agree bit for bit on seeded images,
factors and shifts. A failed build raises; nothing falls back.
"""

import os

import numpy as np
import pytest

from mgproto_tpu import native as jax_native
from mgproto_tpu_torch import native
from mgproto_tpu_torch.data import transforms as T
from mgproto_tpu_torch.utils.images import IMAGENET_MEAN, IMAGENET_STD

FACTORS = (0.6, 0.83, 1.0, 1.17, 1.4)


def _images(seed):
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    grey = np.repeat(rng.integers(0, 256, size=(20, 31, 1), dtype=np.uint8), 3, axis=-1)
    blocks = np.kron(rng.integers(0, 256, size=(6, 5, 3), dtype=np.uint8),
                     np.ones((7, 9, 1), np.uint8))
    return [noise, grey, blocks]


def test_library_builds_into_the_build_directory():
    native.load()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("build", "host_native"))


@pytest.mark.parametrize("seed", [0, 1])
def test_u8_to_f32_ops_match_plain_and_jax(seed):
    for img in _images(seed):
        got = native.u8_to_f32_norm(img, IMAGENET_MEAN, IMAGENET_STD)
        np.testing.assert_array_equal(got, native.u8_to_f32_norm_plain(
            img, IMAGENET_MEAN, IMAGENET_STD))
        np.testing.assert_array_equal(got, jax_native.u8_to_f32_norm(
            img, IMAGENET_MEAN, IMAGENET_STD))
        got = native.u8_to_f32(img)
        np.testing.assert_array_equal(got, native.u8_to_f32_plain(img))
        np.testing.assert_array_equal(got, jax_native.u8_to_f32(img))


@pytest.mark.parametrize("factor", FACTORS)
def test_jitter_ops_match_plain_and_jax(factor):
    for img in _images(2):
        f32 = img.astype(np.float32)
        lum = T._luma_u8(img).astype(np.float32)[..., None]
        mean = np.float32(int(T._luma_u8(img).mean() + 0.5))
        cases = (
            (native.jitter_brightness, jax_native.jitter_brightness,
             T._blend_u8(np.float32(0), f32, factor)),
            (native.jitter_contrast, jax_native.jitter_contrast, T._blend_u8(mean, f32, factor)),
            (native.jitter_saturation, jax_native.jitter_saturation,
             T._blend_u8(lum, f32, factor)),
        )
        for port_op, jax_op, plain in cases:
            got = port_op(img, factor)
            np.testing.assert_array_equal(got, plain, err_msg=port_op.__name__)
            np.testing.assert_array_equal(got, jax_op(img, factor), err_msg=port_op.__name__)


@pytest.mark.parametrize("shift", [0, 1, 5, 128, 250, 255])
def test_hue_shift_matches_plain_and_jax(shift):
    for img in _images(3):
        got = native.hue_shift(img, shift)
        np.testing.assert_array_equal(got, T._adjust_hue_array(img, 0.0, shift_u8=shift))
        np.testing.assert_array_equal(got, jax_native.hue_shift(img, shift))


def test_bad_images_are_refused_before_native_code():
    with pytest.raises(ValueError, match="empty image"):
        native.jitter_contrast(np.zeros((0, 4, 3), np.uint8), 1.2)
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        native.hue_shift(np.zeros((4, 4), np.uint8), 3)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a source g++ refuses raises NativeBuildError."""
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(native.NativeBuildError, match="g.. exit"):
        native.build(str(tmp_path / "out" / "lib.so"))
    assert not any(p.name.endswith(".tmp") for p in (tmp_path / "out").iterdir())


def test_load_raises_when_the_library_cannot_be_made(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cc"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(native.NativeBuildError, match="unreadable"):
        native.load()
