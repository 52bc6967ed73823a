"""The corruption ladder: seeded distribution-shift probes on the device
(counterpart of mgproto_tpu/ops/corrupt.py).

The trust matrix (trust/matrix.py) proves graceful degradation: as inputs
drift off the training manifold, the calibrated serving path must abstain
more and stay accurate on what it still answers. Its shift axis is the
common-corruption families (the ImageNet-C recipe: noise, blur, contrast,
pixelate) at five severities, run in plain PyTorch on the device the batch
lives on, one chunk at a time. They are XLA programs in the JAX package,
not Pallas kernels, so no CUDA kernel of this repo stands behind them.

Domain: the NORMALIZED f32 images the serving path accepts
(serving/validate.py), [B, H, W, 3]; the severity tables are in normalized
units. Every corruption is deterministic given (kind, severity, per-sample
seeds): noise draws `ops/prng.py::normal_torch` from raw
`[0x6D675F63, seed]` threefry keys on the batch's device (bit-equal bits
and uniforms to `jax.random.normal`, the normals within
`prng.NORMAL_ATOL`); the other families depend on their parameters only.

How each family meets the JAX one (tests/test_torch_corrupt.py):
  * noise: img + std * n, as one rounding (XLA contracts it to an FMA);
  * blur: the odd-width Gaussian, edge-replicate padding, separable, taps
    summed in order (XLA's tensordot orders its sum its own way);
  * contrast: mean + f * (x - mean) about the per-image mean, one rounding;
  * pixelate: `jax.image.resize(method="linear")` antialiases when it
    shrinks; the port contracts with JAX's own weight matrices (f32, one per
    axis, on the device once per shape), since F.interpolate's antialiased
    bilinear computes its weights in another precision on the card than on
    the CPU. The "nearest" upsample is F.interpolate's `nearest-exact`:
    plain "nearest" differs wherever the factor does not divide the size.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mgproto_tpu_torch.ops import prng

CORRUPTION_KINDS: Tuple[str, ...] = ("noise", "blur", "contrast", "pixelate")
SEVERITIES: Tuple[int, ...] = (1, 2, 3, 4, 5)

# severity -> parameter, index 0 unused so tables read naturally at [s]
_NOISE_STD = (None, 0.12, 0.25, 0.45, 0.70, 1.00)  # additive gaussian std
_BLUR_SIGMA = (None, 0.6, 1.0, 1.6, 2.4, 3.5)  # gaussian blur std (px)
_CONTRAST_F = (None, 0.70, 0.55, 0.40, 0.25, 0.12)  # contrast retain factor
_PIXELATE_F = (None, 2, 3, 4, 6, 8)  # pixelation block factor

# distinguishes corruption key data from augment's ("mg_c" vs "mg_a")
_KEY_TAG = np.uint32(0x6D675F63)


def _per_sample_keys(seeds: torch.Tensor) -> torch.Tensor:
    """[B] int64 seeds (uint32 values) -> [B, 2] raw threefry key data."""
    return torch.stack([torch.full_like(seeds, int(_KEY_TAG)), seeds], dim=-1)


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32 with one rounding (f32 * f32 is exact in float64)."""
    return (a.double() * float(np.float32(b)) + c.double()).float()


def _noise(x: torch.Tensor, seeds: torch.Tensor, severity: int) -> torch.Tensor:
    draws = prng.normal_torch(_per_sample_keys(seeds), x.shape[1:])
    return _fma(draws, _NOISE_STD[severity], x)


def _gauss_kernel(sigma: float) -> np.ndarray:
    """Odd-width 1D gaussian, radius 3*sigma, normalized in float64."""
    radius = max(1, int(np.ceil(3.0 * sigma)))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(x: torch.Tensor, seeds: torch.Tensor, severity: int) -> torch.Tensor:
    """Separable gaussian blur with edge-replicate padding (a zero pad
    would darken borders in the normalized domain and read as a contrast
    shift)."""
    del seeds  # deterministic family
    k = _gauss_kernel(_BLUR_SIGMA[severity])
    r = (k.shape[0] - 1) // 2

    def conv_axis(img: torch.Tensor, axis: int) -> torch.Tensor:
        n = img.shape[axis]
        idx = torch.arange(-r, n + r, device=img.device).clamp_(0, n - 1)
        padded = img.index_select(axis, idx)
        out = float(k[0]) * padded.narrow(axis, 0, n)
        for i in range(1, 2 * r + 1):
            out = out + float(k[i]) * padded.narrow(axis, i, n)
        return out

    return conv_axis(conv_axis(x, 1), 2)


def _contrast(x: torch.Tensor, seeds: torch.Tensor, severity: int) -> torch.Tensor:
    del seeds  # deterministic family
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return _fma(x - mean, _CONTRAST_F[severity], mean.expand_as(x))


def _linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of `jax.image.resize(method="linear")`
    along one axis (jax/_src/image/scale.py `compute_weight_mat`): the
    triangle kernel, widened by the shrink factor (antialiasing), columns
    normalized; computed in f32 as JAX computes them."""
    f32 = np.float32
    scale = f32(n_out) / f32(n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0) * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


_RESIZE_CACHE: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """`_linear_resize_weights` on `device`, copied there once per shape (a
    later call queues no host-to-device copy)."""
    key = (n_in, n_out, str(device))
    w = _RESIZE_CACHE.get(key)
    if w is None:
        w = _RESIZE_CACHE[key] = torch.from_numpy(_linear_resize_weights(n_in, n_out)).to(device)
    return w


def _pixelate(x: torch.Tensor, seeds: torch.Tensor, severity: int) -> torch.Tensor:
    """Downsample by the block factor (antialiased linear, as two
    contractions with JAX's weight matrices), then nearest back up
    (module docstring)."""
    del seeds  # deterministic family
    f = _PIXELATE_F[severity]
    _, h, w, _ = x.shape
    hs, ws = max(1, h // f), max(1, w // f)
    down = torch.einsum("bhwc,hp->bpwc", x, _resize_weights(h, hs, x.device))
    down = torch.einsum("bpwc,wq->bpqc", down, _resize_weights(w, ws, x.device))
    up = F.interpolate(down.permute(0, 3, 1, 2), size=(h, w), mode="nearest-exact")
    return up.permute(0, 2, 3, 1).contiguous()


_FAMILIES: Dict[str, Callable] = {
    "noise": _noise,
    "blur": _blur,
    "contrast": _contrast,
    "pixelate": _pixelate,
}


def make_corrupt_fn(kind: str, severity: int) -> Callable:
    """`(images [B, H, W, 3] f32 tensor, seeds [B] uint32) -> images` for a
    ladder cell, on the images' device. `seeds`: a numpy array or an int64
    tensor (already on that device, for a caller that must not copy)."""
    if kind not in _FAMILIES:
        raise ValueError(f"unknown corruption kind {kind!r}; options: {CORRUPTION_KINDS}")
    if severity not in SEVERITIES:
        raise ValueError(f"severity must be in {SEVERITIES}, got {severity}")
    family = _FAMILIES[kind]

    def fn(images: torch.Tensor, seeds) -> torch.Tensor:
        if not isinstance(seeds, torch.Tensor):
            seeds = torch.from_numpy(np.asarray(seeds, np.uint32).astype(np.int64))
        seeds = seeds.to(device=images.device, dtype=torch.int64)
        return family(images.to(torch.float32), seeds, severity)

    return fn


def per_sample_seeds(seed: int, count: int, offset: int = 0) -> np.ndarray:
    """The one per-sample uint32 seed recipe of the ladder: the Knuth hash
    of the run seed, offset by the global row index."""
    mixed = (int(seed) * 2654435761) & 0xFFFFFFFF  # knuth hash, mod 2^32
    return np.uint32(mixed) + np.arange(offset, offset + count, dtype=np.uint32)


def corrupt_numpy(images: np.ndarray, kind: str, severity: int, seed: int = 0,
                  device=None) -> np.ndarray:
    """Host wrapper: per-sample seeds from (seed, row index), the cell run
    on `device` (CUDA unless named), a host f32 array back."""
    from mgproto_tpu_torch.numerics import resolve_device

    dev = resolve_device(device)
    seeds = per_sample_seeds(seed, images.shape[0])
    fn = make_corrupt_fn(kind, severity)
    x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(dev)
    return fn(x, seeds).cpu().numpy()
