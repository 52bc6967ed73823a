"""Prototype visualization (counterpart of mgproto_tpu/utils/vis.py), without
cv2 or matplotlib.

Behaviour-parity with the reference's utils/helpers.py:38-74 (the
95th-percentile connected-component crop) and push.py:202-226 (heatmap
overlay and box rendering), which the JAX package computes with cv2 and
writes with matplotlib. Here:
  * the bicubic upsample is torch's (`align_corners=False`, a = -0.75, as
    cv2's INTER_CUBIC), on the device of the tensor it is given;
  * the 8-connected components are scipy's `ndimage.label`;
  * the colormap is cv2's COLORMAP_JET, stored as a table (it is not
    matplotlib's jet);
  * the box is painted as `cv2.rectangle(..., thickness=2)` paints it;
  * the writers encode with Pillow the uint8 pixels that
    `matplotlib.pyplot.imsave(..., vmin=0, vmax=1)` derives from a float
    RGB image (truncation of x * 255 in the image's dtype), as a JPEG at
    Pillow's default quality with 100 dpi, as matplotlib saves one.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

# cv2.applyColorMap(arange(256), COLORMAP_JET) as RGB bytes, 11 entries a line
_JET_RGB_HEX = (
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a8"
    "0000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d4"
    "0000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc0000ff"
    "0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff"
    "0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff0054ff0058ff"
    "005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff0080ff0084ff"
    "0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8ff00acff00b0ff"
    "00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00d4ff00d8ff00dcff"
    "00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff02fffe06fffa0afff6"
    "0efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd232ffce36ffca"
    "3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa262ff9e"
    "66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff72"
    "92ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46"
    "beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1a"
    "eaff16eeff12f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00"
    "ffe800ffe400ffe000ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000"
    "ffbc00ffb800ffb400ffb000ffac00ffa800ffa400ffa000ff9c00ff9800ff9400"
    "ff9000ff8c00ff8800ff8400ff8000ff7c00ff7800ff7400ff7000ff6c00ff6800"
    "ff6400ff6000ff5c00ff5800ff5400ff5000ff4c00ff4800ff4400ff4000ff3c00"
    "ff3800ff3400ff3000ff2c00ff2800ff2400ff2000ff1c00ff1800ff1400ff1000"
    "ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000ec0000e80000e40000"
    "e00000dc0000d80000d40000d00000cc0000c80000c40000c00000bc0000b80000"
    "b40000b00000ac0000a80000a40000a000009c00009800009400009000008c0000"
    "880000840000800000"
)
JET_RGB = np.frombuffer(bytes.fromhex("".join(_JET_RGB_HEX)), np.uint8).reshape(256, 3)


def makedir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def upsample_activation(act, size_hw: Tuple[int, int]):
    """Bicubic latent-grid -> pixel-grid upsample (reference push.py:208):
    [h, w] -> [H, W], or a batch [N, h, w] -> [N, H, W]. A torch tensor is
    resampled on its device and comes back as a tensor; a numpy array is
    resampled on the CPU and comes back as float32 numpy."""
    import torch
    import torch.nn.functional as F

    is_numpy = isinstance(act, np.ndarray)
    x = torch.from_numpy(np.ascontiguousarray(act, np.float32)) if is_numpy else act.float()
    lead = x.shape[:-2]
    up = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=tuple(size_hw), mode="bicubic",
                       align_corners=False)
    up = up.reshape(*lead, *up.shape[-2:])
    return up.numpy() if is_numpy else up


def find_high_activation_crop(
    activation_map: np.ndarray, percentile: float = 95
) -> Tuple[int, int, int, int]:
    """Bounding box (y0, y1, x0, x1) of the 8-connected component of
    above-percentile activation that contains the activation peak
    (reference utils/helpers.py:38-74)."""
    from scipy import ndimage

    threshold = np.percentile(activation_map, percentile)
    mask = (activation_map >= threshold).astype(np.uint8)
    peak_y, peak_x = np.unravel_index(np.argmax(activation_map), activation_map.shape)
    labeled, _ = ndimage.label(mask, structure=np.ones((3, 3), int))
    peak_label = labeled[peak_y, peak_x]
    if peak_label != 0:
        mask = (labeled == peak_label).astype(np.uint8)

    ys = np.where(mask.max(axis=1) > 0)[0]
    xs = np.where(mask.max(axis=0) > 0)[0]
    y0 = int(ys[0]) if ys.size else 0
    y1 = int(ys[-1]) if ys.size else 0
    x0 = int(xs[0]) if xs.size else 0
    x1 = int(xs[-1]) if xs.size else 0
    return (y0, y1 + 1, x0, x1 + 1)


def heatmap_overlay(img_rgb01: np.ndarray, act: np.ndarray) -> np.ndarray:
    """0.5*img + 0.3*jet(normalized act) (reference push.py:216-221)."""
    lo, hi = act.min(), act.max()
    rescaled = np.clip((act - lo) / max(hi - lo, 1e-12), 0, 1)
    heatmap = np.float32(JET_RGB[np.uint8(255 * rescaled)]) / 255
    return 0.5 * img_rgb01 + 0.3 * heatmap


def rectangle_mask(h: int, w: int, y0: int, y1: int, x0: int, x1: int) -> np.ndarray:
    """[h, w] bool: the pixels `cv2.rectangle(img, (x0, y0), (x1 - 1,
    y1 - 1), color, thickness=2)` paints. Each edge is a 3-px band centred
    on it, from one pixel outside the box to one inside; the four outermost
    corner pixels stay unpainted; whatever falls outside the image is
    clipped."""
    ye, xe = y1 - 1, x1 - 1
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    outer = (yy >= y0 - 1) & (yy <= ye + 1) & (xx >= x0 - 1) & (xx <= xe + 1)
    inner = (yy >= y0 + 2) & (yy <= ye - 2) & (xx >= x0 + 2) & (xx <= xe - 2)
    corner = ((yy == y0 - 1) | (yy == ye + 1)) & ((xx == x0 - 1) | (xx == xe + 1))
    return outer & ~inner & ~corner


def imsave_pixels(img_rgb01: np.ndarray) -> np.ndarray:
    """The uint8 RGB pixels matplotlib's `imsave(..., vmin=0, vmax=1)`
    writes for a finite float RGB image in [0, 1]: (x * 255).astype(uint8)
    in the image's own dtype (matplotlib/colorizer.py `_pass_image_data`;
    vmin and vmax do not apply to RGB). Values outside [0, 1] raise, as
    there; so does NaN, which matplotlib would paint as the background."""
    x = np.asarray(img_rgb01)
    if not np.isfinite(x).all() or x.max() > 1 or x.min() < 0:
        raise ValueError("float RGB values must be finite and in the 0..1 range")
    return (x * 255).astype(np.uint8)


def write_jpeg(fname: str, pixels: np.ndarray) -> None:
    """Encode [H, W, 3] uint8 RGB with Pillow as matplotlib's imsave does
    for a .jpg name (format JPEG, Pillow's default quality, 100 dpi)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "writing prototype images needs Pillow (the PIL package); "
            "push without save_dir to skip rendering") from e
    Image.fromarray(np.ascontiguousarray(pixels), "RGB").save(fname, format="jpeg",
                                                              dpi=(100, 100))


def imsave_with_bbox(
    fname: str,
    img_rgb01: np.ndarray,
    y0: int,
    y1: int,
    x0: int,
    x1: int,
    color=(0, 255, 255),
) -> None:
    """Save with a 2px rectangle (reference push.py:234-239). `color` is
    BGR, as the reference hands it to cv2."""
    img = np.uint8(255 * np.clip(img_rgb01, 0, 1))
    img[rectangle_mask(img.shape[0], img.shape[1], y0, y1, x0, x1)] = color[::-1]
    write_jpeg(fname, imsave_pixels(np.float32(img) / 255))


def imsave(fname: str, img_rgb01: np.ndarray) -> None:
    write_jpeg(fname, imsave_pixels(np.clip(img_rgb01, 0, 1)))
