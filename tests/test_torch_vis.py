"""The port's prototype visualization (mgproto_tpu_torch/utils/vis.py, no cv2
or matplotlib) against the JAX package's (mgproto_tpu/utils/vis.py, cv2 and
matplotlib), on the CPU, on seeded log-normal activation maps.

Tolerances:
  * the bicubic upsample: within 1e-5 of the map's maximum (torch's and
    cv2's kernels round differently), at 14 -> 224x224 and
    14 -> 375x500, one map and a batch;
  * `find_high_activation_crop` on the same upsampled map: the same box;
  * the jet table: equal to `cv2.applyColorMap(arange(256), COLORMAP_JET)`;
  * `heatmap_overlay`: within 1e-6;
  * `rectangle_mask`: equal to what `cv2.rectangle(thickness=2)` paints, on
    seeded boxes, boxes that touch each border and one-pixel boxes;
  * the writers: the uint8 array each encodes equal to what matplotlib
    derives from the float image the JAX path hands to
    `matplotlib.pyplot.imsave` (captured by monkeypatching `imsave` in the
    test only), and the JPEG files equal byte for byte.
"""

import importlib

import cv2
import matplotlib.pyplot as plt
import numpy as np
import pytest
from matplotlib import colorizer

from mgproto_tpu_torch.utils import vis as tvis

jvis = importlib.import_module("mgproto_tpu.utils.vis")


def _maps(n, seed, hw=(14, 14)):
    return np.random.default_rng(seed).lognormal(size=(n, *hw)).astype(np.float32)


@pytest.mark.parametrize("size", [(224, 224), (375, 500)])
def test_upsample_matches_cv2(size):
    maps = _maps(20, 1)
    batch = tvis.upsample_activation(maps, size)
    assert batch.shape == (20, *size) and batch.dtype == np.float32
    for m, got in zip(maps, batch):
        want = jvis.upsample_activation(m, size)
        assert np.abs(tvis.upsample_activation(m, size) - want).max() <= 1e-5 * want.max()
        assert np.abs(got - want).max() <= 1e-5 * want.max()
    # a tensor stays a tensor
    import torch

    t = tvis.upsample_activation(torch.from_numpy(maps[:2]), size)
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), batch[:2])


@pytest.mark.parametrize("seed", range(4))
def test_high_activation_crop_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    for m in _maps(25, 10 + seed, hw=(7, 7)):
        up = jvis.upsample_activation(m, (224, 224))
        assert tvis.find_high_activation_crop(up) == jvis.find_high_activation_crop(up)
    # several above-percentile islands: the peak's component alone
    spiky = np.zeros((60, 60), np.float32)
    for y, x in rng.integers(0, 60, size=(12, 2)):
        spiky[y, x] = rng.uniform(1, 2)
    spiky[rng.integers(0, 60), rng.integers(0, 60)] = 3.0
    assert tvis.find_high_activation_crop(spiky) == jvis.find_high_activation_crop(spiky)


def test_jet_table_is_cv2s():
    bgr = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)[:, 0]
    np.testing.assert_array_equal(tvis.JET_RGB, bgr[:, ::-1])


def test_heatmap_overlay_matches_cv2():
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(224, 224, 3)).astype(np.float32)
    for m in _maps(5, 4):
        act = jvis.upsample_activation(m, (224, 224))
        got, want = tvis.heatmap_overlay(img, act), jvis.heatmap_overlay(img, act)
        assert got.dtype == want.dtype
        assert np.abs(got - want).max() <= 1e-6
    flat = np.ones((224, 224), np.float32)  # hi == lo
    assert np.abs(tvis.heatmap_overlay(img, flat) - jvis.heatmap_overlay(img, flat)).max() <= 1e-6


def _boxes():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        y0 = int(rng.integers(0, h))
        x0 = int(rng.integers(0, w))
        out.append((h, w, y0, int(rng.integers(y0 + 1, h + 1)), x0,
                    int(rng.integers(x0 + 1, w + 1))))
    h, w = 30, 24
    out += [(h, w, 0, h, 0, w), (h, w, 0, 5, 3, 9), (h, w, 20, h, 3, 9), (h, w, 4, 9, 0, 6),
            (h, w, 4, 9, 17, w), (h, w, 7, 8, 7, 8), (h, w, 0, 1, 0, 1), (h, w, h - 1, h, w - 1, w),
            (h, w, 1, 3, 1, 3)]
    return out


def test_rectangle_mask_matches_cv2():
    for h, w, y0, y1, x0, x1 in _boxes():
        img = np.zeros((h, w, 3), np.uint8)
        cv2.rectangle(img, (x0, y0), (x1 - 1, y1 - 1), (0, 255, 255), thickness=2)
        np.testing.assert_array_equal(tvis.rectangle_mask(h, w, y0, y1, x0, x1), img[..., 1] > 0,
                                      err_msg=str((h, w, y0, y1, x0, x1)))


def _capture(monkeypatch, module, name):
    seen = []
    real = getattr(module, name)

    def keep(fname, arr, *a, **kw):
        seen.append(np.array(arr))
        return real(fname, arr, *a, **kw)

    monkeypatch.setattr(module, name, keep)
    return seen


@pytest.mark.parametrize("box", [(10, 50, 20, 80), (0, 224, 0, 224), (100, 101, 223, 224)])
def test_writers_encode_what_matplotlib_writes(box, tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    img = rng.uniform(size=(224, 224, 3)).astype(np.float32)
    img[:3] = rng.choice([0.0, 1.0], size=(3, 224, 3))  # the ends of [0, 1]
    over = jvis.heatmap_overlay(img, jvis.upsample_activation(_maps(1, 7)[0], (224, 224)))
    y0, y1, x0, x1 = box
    handed = _capture(monkeypatch, plt, "imsave")
    encoded = _capture(monkeypatch, tvis, "write_jpeg")
    for pic in (img, over):
        jvis.imsave_with_bbox(str(tmp_path / "j.jpg"), pic, y0, y1, x0, x1)
        tvis.imsave_with_bbox(str(tmp_path / "t.jpg"), pic, y0, y1, x0, x1)
        assert (tmp_path / "j.jpg").read_bytes() == (tmp_path / "t.jpg").read_bytes()
    jvis.imsave(str(tmp_path / "j.jpg"), img[y0:y1, x0:x1])
    tvis.imsave(str(tmp_path / "t.jpg"), img[y0:y1, x0:x1])
    assert (tmp_path / "j.jpg").read_bytes() == (tmp_path / "t.jpg").read_bytes()
    assert len(handed) == len(encoded) == 3
    for arr, pixels in zip(handed, encoded):
        want = colorizer.Colorizer().to_rgba(arr, bytes=True)[..., :3]
        assert pixels.dtype == np.uint8
        np.testing.assert_array_equal(pixels, want)
        np.testing.assert_array_equal(tvis.imsave_pixels(arr), want)


def test_imsave_pixels_refuses_what_matplotlib_refuses():
    with pytest.raises(ValueError):
        tvis.imsave_pixels(np.full((2, 2, 3), 1.5, np.float32))
    with pytest.raises(ValueError):
        tvis.imsave_pixels(np.full((2, 2, 3), np.nan, np.float32))


def test_writers_without_pillow_raise_a_clear_import_error(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        tvis.imsave(str(tmp_path / "x.jpg"), np.zeros((4, 4, 3), np.float32))
