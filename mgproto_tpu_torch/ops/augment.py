"""Device-side augmentation tail: flip + colour jitter + normalize in the step.

Counterpart of mgproto_tpu/ops/augment.py. With the uint8 wire on, the host
train pipeline stops at geometry (perspective, affine, resized crop) and
ships uint8 [B, H, W, 3] batches; the per-pixel tail (brightness, contrast,
saturation and hue jitter, horizontal flip, u8 -> normalized f32) runs here,
on the batch's device, before the trunk.

The per-sample draws are made on the host (`augment_draws`, threefry in
numpy, ops/prng.py) from the loader's seeds, exactly as the JAX package
draws them in its step, and travel with the batch as one [B, 5] f32 tensor:
column 0 the flip bit, 1-4 the brightness, contrast, saturation and hue
factors. `augment_tail` is plain PyTorch in the JAX package's op order
(brightness -> contrast -> saturation -> hue -> flip -> normalize), so on
the CPU it gives the JAX package's bits, and on the card the same function
within f32 rounding (tests/test_torch_augment.py; `chip_smoke.py`'s input
phase). The JAX package computes this tail as an XLA fusion, not as a Pallas
kernel; here it is a chain of elementwise PyTorch ops on the card.

Each op mirrors PIL's semantics in f32 without PIL's uint8 truncation
between ops (see the JAX module's docstring for the tolerance against the
host path).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from mgproto_tpu_torch.ops import prng
from mgproto_tpu_torch.utils.images import IMAGENET_MEAN, IMAGENET_STD

# ColorJitter ranges of the reference train stack (main.py:100)
BRIGHTNESS: Tuple[float, float] = (0.6, 1.4)
CONTRAST: Tuple[float, float] = (0.6, 1.4)
SATURATION: Tuple[float, float] = (0.6, 1.4)
HUE: Tuple[float, float] = (-0.02, 0.02)
FLIP_P: float = 0.5

# the first word of the raw threefry key built from a loader seed ("mg_a")
KEY_TAG = 0x6D675F61


def resolve_device_augment(flag: Optional[bool], device: torch.device) -> bool:
    """None = on for a CUDA device, off for the CPU; True/False force it."""
    if flag is not None:
        return bool(flag)
    return torch.device(device).type == "cuda"


def augment_draws(
    seeds: np.ndarray,
    brightness: Tuple[float, float] = BRIGHTNESS,
    contrast: Tuple[float, float] = CONTRAST,
    saturation: Tuple[float, float] = SATURATION,
    hue: Tuple[float, float] = HUE,
    flip_p: float = FLIP_P,
) -> np.ndarray:
    """[B] uint32 loader seeds -> [B, 5] f32 draws (flip, brightness,
    contrast, saturation, hue): the values the JAX package's `augment_tail`
    draws with `jax.random` from the same seeds."""
    seeds = np.asarray(seeds).astype(np.uint32)
    keys = np.stack([np.full_like(seeds, KEY_TAG), seeds], axis=-1)
    sub = prng.split(keys, 5)  # [B, 5, 2]
    return np.stack([
        prng.bernoulli(sub[:, 0], flip_p).astype(np.float32),
        prng.uniform(sub[:, 1], *brightness),
        prng.uniform(sub[:, 2], *contrast),
        prng.uniform(sub[:, 3], *saturation),
        prng.uniform(sub[:, 4], *hue),
    ], axis=-1)


def _luma(x: torch.Tensor) -> torch.Tensor:
    """PIL convert("L") luminance in float, without the final rounding."""
    return (19595.0 * x[..., 0] + 38470.0 * x[..., 1] + 7471.0 * x[..., 2]) / 65536.0


def adjust_brightness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL ImageEnhance.Brightness in f32: blend toward black."""
    return torch.clamp(factor * x, 0.0, 255.0)


def contrast_degenerate(x: torch.Tensor) -> torch.Tensor:
    """The grey level contrast blends toward: the rounded (half to even)
    mean luma of each image, [..., 1, 1, 1]."""
    return torch.round(_luma(x).mean(dim=(-2, -1), keepdim=True))[..., None]


def adjust_contrast(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL ImageEnhance.Contrast in f32: blend toward the rounded mean luma."""
    deg = contrast_degenerate(x)
    return torch.clamp(deg + factor * (x - deg), 0.0, 255.0)


def adjust_saturation(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL ImageEnhance.Color in f32: blend toward the per-pixel luma."""
    lum = _luma(x)[..., None]
    return torch.clamp(lum + factor * (x - lum), 0.0, 255.0)


def adjust_hue(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Hue shift by `factor` turns ([B, 1, 1]): RGB -> HSV -> (H + shift) ->
    RGB in continuous f32, the shift quantized as the host path quantizes
    it (trunc(f * 255) mod 256)."""
    shift = torch.remainder(torch.trunc(factor * 255.0), 256.0) / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    grey = c == 0
    safe_c = torch.where(grey, torch.ones_like(c), c)
    h6 = torch.where(
        mx == r, torch.remainder((g - b) / safe_c, 6.0),
        torch.where(mx == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0),
    )
    h = torch.where(grey, torch.zeros_like(h6), h6 / 6.0)
    h = torch.remainder(h + shift, 1.0)
    black = mx == 0
    s = torch.where(black, torch.zeros_like(c), c / torch.where(black, torch.ones_like(mx), mx))
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = mx * (1.0 - s)
    q = mx * (1.0 - s * f)
    t = mx * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def select(*vals):  # jnp.select over the six sectors
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    out = torch.stack([select(mx, q, p, p, t, mx), select(t, mx, mx, q, p, p),
                       select(p, p, t, mx, mx, q)], dim=-1)
    return torch.where(grey[..., None], x, out)


@functools.lru_cache(maxsize=8)
def _scale_bias(device: torch.device, mean: Tuple[float, ...], std: Tuple[float, ...]):
    """1/(255 std) and -mean/std in f32 on `device`, made once: a host
    array copied to the card on every call would synchronize the stream."""
    std32 = np.asarray(std, np.float32)
    scale = 1.0 / (255.0 * std32)
    bias = -np.asarray(mean, np.float32) / std32
    return torch.from_numpy(scale).to(device), torch.from_numpy(bias).to(device)


def normalize_u8(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """u8-domain values (0..255) -> normalized f32 as x * 1/(255 std) -
    mean/std, the host native pass's scale/bias form."""
    scale, bias = _scale_bias(x.device, tuple(np.asarray(mean, np.float32).tolist()),
                              tuple(np.asarray(std, np.float32).tolist()))
    return x.to(torch.float32) * scale + bias


def augment_tail(images: torch.Tensor, draws: torch.Tensor, mean=IMAGENET_MEAN,
                 std=IMAGENET_STD) -> torch.Tensor:
    """[B, H, W, 3] uint8 wire batch + [B, 5] f32 draws (`augment_draws`)
    -> augmented, normalized f32 [B, H, W, 3], on the images' device."""
    x = images.to(torch.float32)
    d = draws.to(device=x.device, dtype=torch.float32)[:, :, None, None, None]
    x = adjust_brightness(x, d[:, 1])
    x = adjust_contrast(x, d[:, 2])
    x = adjust_saturation(x, d[:, 3])
    x = adjust_hue(x, d[:, 4, ..., 0])
    x = torch.where(d[:, 0] != 0, x.flip(2), x)
    return normalize_u8(x, mean, std)
