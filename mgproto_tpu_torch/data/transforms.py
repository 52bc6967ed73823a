"""Host-side image transforms, PIL/numpy implementations (the port's copy
of mgproto_tpu/data/transforms.py, same arithmetic).

torchvision is not a dependency of this framework; these reproduce the exact
transform semantics the reference uses (reference main.py:96-163):

  train: RandomPerspective(0.2, p=.5) -> ColorJitter((.6,1.4)x3, hue .02)
         -> RandomHorizontalFlip -> RandomAffine(25deg, shear +-15,
         translate .05) -> RandomResizedCrop(img, scale=(.6,1)) -> normalize
  push:  Resize((img,img))                      [unnormalized]
  test:  Resize(img+32 shorter side) -> CenterCrop(img) -> normalize
  ood:   Resize((img,img)) -> normalize

Each random transform takes a `numpy.random.Generator` so the pipeline is
deterministic per (seed, epoch, sample) — the reference's loader is only as
deterministic as torch's global RNG.

PIL is imported inside the functions that use it, and torch nowhere: spawn
loader workers unpickle these transform classes, and the module imports on
a host without Pillow.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from mgproto_tpu_torch import native
from mgproto_tpu_torch.utils.images import IMAGENET_MEAN, IMAGENET_STD

if TYPE_CHECKING:
    from PIL import Image


def _bilinear() -> int:
    from PIL import Image as _Image

    return _Image.BILINEAR


# --------------------------------------------------------------- deterministic
def resize(img: "Image.Image", size) -> "Image.Image":
    """torchvision Resize: int = shorter side to `size` keeping aspect;
    (h, w) = exact."""
    if isinstance(size, int):
        w, h = img.size
        if w <= h:
            ow, oh = size, max(1, round(size * h / w))
        else:
            oh, ow = size, max(1, round(size * w / h))
        return img.resize((ow, oh), _bilinear())
    h, w = size
    return img.resize((w, h), _bilinear())


def center_crop(img: "Image.Image", size: int) -> "Image.Image":
    w, h = img.size
    if w < size or h < size:
        img = resize(img, size)
        w, h = img.size
    x0 = int(round((w - size) / 2.0))
    y0 = int(round((h - size) / 2.0))
    return img.crop((x0, y0, x0 + size, y0 + size))


def to_array(img: "Image.Image") -> np.ndarray:
    """PIL -> float32 [H, W, 3] in [0, 1] (torchvision ToTensor, NHWC)."""
    return np.asarray(img.convert("RGB"), np.float32) / 255.0


def normalize(x: np.ndarray) -> np.ndarray:
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def _to_norm_f32(img: "Image.Image") -> np.ndarray:
    """PIL -> normalized f32 HWC: the fused native LUT pass
    (mgproto_tpu_torch/native)."""
    a = np.asarray(img.convert("RGB"), np.uint8)
    return native.u8_to_f32_norm(a, IMAGENET_MEAN, IMAGENET_STD)


def _to_f32(img: "Image.Image") -> np.ndarray:
    """PIL -> f32 HWC in [0, 1] (push pipeline stays unnormalized)."""
    a = np.asarray(img.convert("RGB"), np.uint8)
    return native.u8_to_f32(a)


# ------------------------------------------------------------------- random
def random_horizontal_flip(
    img: "Image.Image", rng: np.random.Generator, p: float = 0.5
) -> "Image.Image":
    from PIL import Image as _Image

    if rng.random() < p:
        return img.transpose(_Image.FLIP_LEFT_RIGHT)
    return img


def _perspective_coeffs(
    startpoints: Sequence[Tuple[float, float]],
    endpoints: Sequence[Tuple[float, float]],
) -> List[float]:
    """8-param homography mapping OUTPUT (start) -> INPUT (end) coords, the
    direction PIL's PERSPECTIVE transform wants."""
    a = []
    b = []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        a.append([sx, sy, 1, 0, 0, 0, -ex * sx, -ex * sy])
        a.append([0, 0, 0, sx, sy, 1, -ey * sx, -ey * sy])
        b.extend([ex, ey])
    coeffs, *_ = np.linalg.lstsq(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rcond=None
    )
    return coeffs.tolist()


def random_perspective(
    img: "Image.Image",
    rng: np.random.Generator,
    distortion_scale: float = 0.2,
    p: float = 0.5,
) -> "Image.Image":
    """torchvision RandomPerspective: each corner jitters inward by up to
    distortion_scale * half-extent."""
    if rng.random() >= p:
        return img
    w, h = img.size
    dx = distortion_scale * w / 2
    dy = distortion_scale * h / 2

    def jitter(lo_x, lo_y):
        return (
            float(rng.integers(0, int(dx) + 1)),
            float(rng.integers(0, int(dy) + 1)),
        )

    jx0, jy0 = jitter(0, 0)
    jx1, jy1 = jitter(0, 0)
    jx2, jy2 = jitter(0, 0)
    jx3, jy3 = jitter(0, 0)
    startpoints = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
    endpoints = [
        (jx0, jy0),
        (w - 1 - jx1, jy1),
        (w - 1 - jx2, h - 1 - jy2),
        (jx3, h - 1 - jy3),
    ]
    # PIL wants output->input; torchvision's F.perspective(start, end) solves
    # the homography H with H(endpoint) = startpoint, so content SHRINKS into
    # the jittered quad (borders filled), not zoom-in
    coeffs = _perspective_coeffs(endpoints, startpoints)
    from PIL import Image as _Image

    return img.transform((w, h), _Image.PERSPECTIVE, coeffs, _bilinear())


def _adjust_hue(img: "Image.Image", factor: float) -> "Image.Image":
    """Shift hue by `factor` (in turns, [-0.5, 0.5])."""
    from PIL import Image as _Image

    if abs(factor) < 1e-8:
        return img
    hsv = np.asarray(img.convert("HSV"), np.uint8).copy()
    shift = np.uint8(int(factor * 255) % 256)
    hsv[..., 0] = hsv[..., 0] + shift  # uint8 wraparound is the hue circle
    return _Image.fromarray(hsv, "HSV").convert("RGB")


# -------------------------- vectorized color jitter (bit-exact with PIL)
# The PIL jitter stack was the profiled hot spot of the whole train pipeline
# (~42 of ~54 ms/sample at CUB source sizes, the HSV hue round-trip alone
# ~25 ms). The numpy path below reproduces Pillow's
# integer/float semantics BIT-EXACTLY (pinned against the PIL oracle
# `_color_jitter_pil` and the native library by tests/test_torch_data.py and
# tests/test_torch_native.py), so it is simply the default implementation,
# not an approximation. The per-op rounding contracts, established empirically
# against Pillow 12 (mixed f32 storage with f64 expression arithmetic, i.e.
# C `float` variables in `double` expressions):
#
#   * convert("L"):  (19595 R + 38470 G + 7471 B + 0x8000) >> 16
#   * Image.blend:   f32(deg + factor * (img - deg)), clip, TRUNCATE
#   * convert("HSV") H: f32 chain with f64 expression arithmetic, trunc;
#     S: trunc(255 cr / maxc); V: maxc
#   * convert("RGB") from HSV: classic sextant formula, p/q/t rounded
#     half-up, truncated sector index
def _blend_u8(deg, img_f32, factor: float):
    """PIL Image.blend on uint8 planes: f32 math, clip, truncate."""
    out = deg + np.float32(factor) * (img_f32 - deg)
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def _luma_u8(arr: np.ndarray) -> np.ndarray:
    """PIL convert("L") — exact integer rounding."""
    r = arr[..., 0].astype(np.uint32)
    g = arr[..., 1].astype(np.uint32)
    b = arr[..., 2].astype(np.uint32)
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(
        np.uint8
    )


def _adjust_hue_array(
    arr: np.ndarray, factor: float, shift_u8: Optional[int] = None
) -> np.ndarray:
    """uint8 RGB -> PIL-exact HSV -> uint8 hue shift -> PIL-exact RGB.
    `shift_u8` overrides the factor-derived shift (native.hue_shift's
    fallback passes the shift it was handed)."""
    f32, f64 = np.float32, np.float64
    r = arr[..., 0].astype(f32)
    g = arr[..., 1].astype(f32)
    b = arr[..., 2].astype(f32)
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    cr = maxc - minc
    achrom = cr == 0
    safe_cr = np.where(achrom, f32(1), cr)
    safe_max = np.where(maxc == 0, f32(1), maxc)
    # C float variables, double expression arithmetic (see contract above)
    rc = ((maxc - r) / safe_cr).astype(f64)
    gc = ((maxc - g) / safe_cr).astype(f64)
    bc = ((maxc - b) / safe_cr).astype(f64)
    h = np.where(
        r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc)
    ).astype(f32)
    h = (h.astype(f64) / 6.0).astype(f32)
    h = np.where(h < 0, (h.astype(f64) + 1.0).astype(f32), h)
    hue = (h.astype(f64) * 255.0).astype(np.uint8)
    hue = np.where(achrom, np.uint8(0), hue)
    sat = (cr.astype(f64) * 255.0 / safe_max.astype(f64)).astype(np.uint8)
    sat = np.where(achrom | (maxc == 0), np.uint8(0), sat)

    if shift_u8 is None:
        shift_u8 = int(factor * 255) % 256
    hue = hue + np.uint8(shift_u8 % 256)  # uint8 wrap = hue circle

    # hsv2rgb: PURE float32 arithmetic (verified exhaustively against PIL
    # over all 2^24 HSV values — the mixed-f64 variant diverges ~1/10^6);
    # sector index truncates, p/q/t round half-up
    fh = (hue.astype(f32) * f32(6.0) / f32(255.0)).astype(f32)
    sector = fh.astype(np.int32)
    f = (fh - sector.astype(f32)).astype(f32)
    fs = (sat.astype(f32) / f32(255.0)).astype(f32)
    v32 = maxc.astype(f32)
    p = (v32 * (f32(1.0) - fs) + f32(0.5)).astype(np.int32)
    q = (v32 * (f32(1.0) - fs * f) + f32(0.5)).astype(np.int32)
    t = (v32 * (f32(1.0) - fs * (f32(1.0) - f)) + f32(0.5)).astype(np.int32)
    v = maxc.astype(np.int32)
    s6 = np.mod(sector, 6)
    conds = [s6 == i for i in range(6)]
    out = np.stack(
        [
            np.select(conds, [v, q, p, p, t, v]),
            np.select(conds, [t, v, v, q, p, p]),
            np.select(conds, [p, p, t, v, v, q]),
        ],
        axis=-1,
    )
    gray = (sat == 0)[..., None]
    return np.where(gray, maxc.astype(np.int32)[..., None], out).astype(
        np.uint8
    )


def _color_jitter_pil(img, rng, brightness, contrast, saturation, hue):
    """The original PIL implementation — retained as the oracle for the
    bit-exactness test of the vectorized default below."""
    from PIL import ImageEnhance
    factors = {
        0: rng.uniform(*brightness),
        1: rng.uniform(*contrast),
        2: rng.uniform(*saturation),
        3: rng.uniform(*hue),
    }
    order = rng.permutation(4)
    img = img.convert("RGB")
    for t in order:
        if t == 0:
            img = ImageEnhance.Brightness(img).enhance(factors[0])
        elif t == 1:
            img = ImageEnhance.Contrast(img).enhance(factors[1])
        elif t == 2:
            img = ImageEnhance.Color(img).enhance(factors[2])
        else:
            img = _adjust_hue(img, factors[3])
    return img


def color_jitter(
    img: "Image.Image",
    rng: np.random.Generator,
    brightness: Tuple[float, float] = (0.6, 1.4),
    contrast: Tuple[float, float] = (0.6, 1.4),
    saturation: Tuple[float, float] = (0.6, 1.4),
    hue: Tuple[float, float] = (-0.02, 0.02),
) -> "Image.Image":
    """torchvision ColorJitter: uniform factor per property, applied in a
    random order (reference main.py:100's exact ranges are the defaults).
    Vectorized numpy implementation, bit-exact with the PIL stack it
    replaced (same RNG draw order, so identical across the swap)."""
    factors = {
        0: rng.uniform(*brightness),
        1: rng.uniform(*contrast),
        2: rng.uniform(*saturation),
        3: rng.uniform(*hue),
    }
    order = rng.permutation(4)
    arr = np.asarray(img.convert("RGB"), np.uint8)
    # the native entry points are bit-exact with this module's numpy plain
    # versions (_blend_u8/_luma_u8/_adjust_hue_array), which the tests hold
    # them to
    for t in order:
        if t == 0:
            arr = native.jitter_brightness(arr, factors[0])
        elif t == 1:
            arr = native.jitter_contrast(arr, factors[1])
        elif t == 2:
            arr = native.jitter_saturation(arr, factors[2])
        elif abs(factors[3]) >= 1e-8:
            # NB: the HSV round-trip is lossy, so it applies whenever the
            # PIL path would have (even when the uint8 shift lands on 0)
            arr = native.hue_shift(arr, int(factors[3] * 255) % 256)
    from PIL import Image as _Image

    return _Image.fromarray(arr)


def _inverse_affine_matrix(
    center: Tuple[float, float],
    angle_deg: float,
    translate: Tuple[float, float],
    scale: float,
    shear_deg: Tuple[float, float],
) -> List[float]:
    """Inverse of the torchvision affine (output->input, for PIL AFFINE).

    Follows the matrix convention of torchvision.transforms.functional:
    M = T(center) R(angle) S(scale) Sh(shear) T(-center) T(translate)^-1 ...
    computed directly as the inverse map."""
    rot = math.radians(angle_deg)
    sx, sy = (math.radians(s) for s in shear_deg)
    cx, cy = center
    tx, ty = translate

    # RSS: rotation * shear * scale (forward), per torchvision
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)

    # inverse of scale * RSS
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    ia, ib, ic, id_ = (v / scale for v in (ia, ib, ic, id_))

    # inverse translation: x_in = inv(RSS) @ (x_out - center - translate) + center
    m02 = ia * (-cx - tx) + ib * (-cy - ty) + cx
    m12 = ic * (-cx - tx) + id_ * (-cy - ty) + cy
    return [ia, ib, m02, ic, id_, m12]


def random_affine(
    img: "Image.Image",
    rng: np.random.Generator,
    degrees: float = 25.0,
    translate: Tuple[float, float] = (0.05, 0.05),
    shear: Tuple[float, float] = (-15.0, 15.0),
) -> "Image.Image":
    """torchvision RandomAffine(degrees=25, shear=(-15,15),
    translate=[.05,.05]) — reference main.py:102. A 2-tuple shear range
    shears the x axis only."""
    w, h = img.size
    angle = rng.uniform(-degrees, degrees)
    max_dx = translate[0] * w
    max_dy = translate[1] * h
    tx = float(np.round(rng.uniform(-max_dx, max_dx)))
    ty = float(np.round(rng.uniform(-max_dy, max_dy)))
    shear_x = rng.uniform(shear[0], shear[1])
    matrix = _inverse_affine_matrix(
        ((w - 1) * 0.5, (h - 1) * 0.5), angle, (tx, ty), 1.0, (shear_x, 0.0)
    )
    from PIL import Image as _Image

    return img.transform((w, h), _Image.AFFINE, matrix, _bilinear())


def random_resized_crop(
    img: "Image.Image",
    rng: np.random.Generator,
    size: int,
    scale: Tuple[float, float] = (0.6, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> "Image.Image":
    """torchvision RandomResizedCrop(size, scale=(0.6, 1.0)) — reference
    main.py:103. 10 attempts, then center-crop fallback."""
    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return img.resize(
                (size, size), _bilinear(), box=(x0, y0, x0 + cw, y0 + ch)
            )
    # fallback: largest valid center crop
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    x0 = (w - cw) // 2
    y0 = (h - ch) // 2
    return img.resize((size, size), _bilinear(), box=(x0, y0, x0 + cw, y0 + ch))


# ---------------------------------------------------------------- pipelines
Transform = Callable[[Any, Optional[np.random.Generator]], np.ndarray]

# The pipelines are CLASSES, not closures: datasets holding a transform must
# be picklable so the loader's spawn-based process workers can receive them
# (data/loader.py; closures can't cross a spawn boundary). The
# factory functions below keep the call-site API unchanged.


class TrainTransform:
    """The reference's training augmentation stack (main.py:98-106).

    `device_augment=True` is the host half of the uint8 wire format
    (ops/augment.py): only the geometry ops that need PIL resampling —
    perspective, affine, resized-crop — run here, and the output stays
    uint8 [H, W, 3]. Flip + the whole color jitter (brightness/contrast/
    saturation/hue) + normalize then run in the train step on the batch's
    device (ops/augment.py), seeded per sample. The wire carries 4x fewer bytes at every hop
    (worker -> parent IPC, host -> device copy), and the host sheds the
    jitter math — including the HSV hue round trip, the profiled hot spot
    of the whole stack at flagship sizes."""

    def __init__(self, img_size: int, device_augment: bool = False):
        self.img_size = img_size
        self.device_augment = device_augment

    def __call__(self, img: "Image.Image", rng: np.random.Generator) -> np.ndarray:
        img = img.convert("RGB")
        img = random_perspective(img, rng)
        if self.device_augment:
            img = random_affine(img, rng)
            img = random_resized_crop(img, rng, self.img_size)
            return np.asarray(img.convert("RGB"), np.uint8)
        img = color_jitter(img, rng)
        img = random_horizontal_flip(img, rng)
        img = random_affine(img, rng)
        img = random_resized_crop(img, rng, self.img_size)
        return _to_norm_f32(img)


class PushTransform:
    """Resize-only, UNNORMALIZED (main.py:111-116)."""

    def __init__(self, img_size: int):
        self.img_size = img_size

    def __call__(self, img: "Image.Image", rng=None) -> np.ndarray:
        return _to_f32(resize(img, (self.img_size, self.img_size)))


class TestTransform:
    """Resize(shorter=img+32) + CenterCrop (main.py:128-135)."""

    def __init__(self, img_size: int):
        self.img_size = img_size

    def __call__(self, img: "Image.Image", rng=None) -> np.ndarray:
        return _to_norm_f32(
            center_crop(resize(img, self.img_size + 32), self.img_size)
        )


class OodTransform:
    """Exact-resize + normalize (main.py:141-163)."""

    def __init__(self, img_size: int):
        self.img_size = img_size

    def __call__(self, img: "Image.Image", rng=None) -> np.ndarray:
        return _to_norm_f32(resize(img, (self.img_size, self.img_size)))


def train_transform(img_size: int, device_augment: bool = False) -> Transform:
    return TrainTransform(img_size, device_augment=device_augment)


def push_transform(img_size: int) -> Transform:
    return PushTransform(img_size)


def test_transform(img_size: int) -> Transform:
    return TestTransform(img_size)


def ood_transform(img_size: int) -> Transform:
    return OodTransform(img_size)
