"""ctypes bindings for the host C++ of the input pipeline
(mgproto_tpu_torch/csrc/host/mgproto_native.cc; counterpart of
mgproto_tpu/native).

The library is built with g++ at first use into `build/host_native/` at the
repository root (listed in .gitignore), named by a hash of its source and
flags and by the host's ISA (it is built -march=native), compiled to a
pid-suffixed file and renamed into place, so concurrent first uses (loader
workers, test workers) never load a half-written library. If it cannot be
built or loaded, every entry point raises `NativeBuildError`: the port has
no silent numpy fallback. The numpy plain versions (`*_plain` here and the
helpers in data/transforms.py) are what the tests hold the library to.

This module imports neither torch nor PIL: spawn loader workers import it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host", "mgproto_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host_native")
# -ffp-contract=off is required for bit-exactness: an FMA would skip the
# intermediate f32 rounding of PIL's two-step blend
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-march=native", "-funroll-loops", "-shared",
             "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the source, or the library did not load."""


def _cpu_flags() -> str:
    """The host's CPU feature flags: the library is built -march=native, so
    a checkout shared between hosts keeps one library per ISA."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return ""


def library_path() -> str:
    h = hashlib.sha256()
    try:
        with open(SOURCE, "rb") as f:
            h.update(f.read())
    except OSError as e:
        raise NativeBuildError(f"host native source unreadable: {e}") from e
    h.update(" ".join(CXX_FLAGS).encode())
    h.update((platform.machine() + ":" + _cpu_flags()).encode())
    return os.path.join(BUILD_DIR, f"libmgproto_native-{h.hexdigest()[:16]}.so")


def build(path: str) -> None:
    """Compile the source into `path` (pid-suffixed temp, atomic rename)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"host native build failed to run {cmd[0]}: {e!r}") from e
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise NativeBuildError(
            f"host native build failed (g++ exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises NativeBuildError."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            build(path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NativeBuildError(f"host native library {path} did not load: {e}") from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.mg_u8hwc_to_f32_norm.argtypes = [u8p, ctypes.c_int64, f32p, f32p, f32p]
        lib.mg_u8hwc_to_f32.argtypes = [u8p, ctypes.c_int64, f32p]
        for name in ("mg_jitter_brightness", "mg_jitter_contrast", "mg_jitter_saturation"):
            getattr(lib, name).argtypes = [u8p, ctypes.c_int64, ctypes.c_float, u8p]
        lib.mg_hue_shift.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32, u8p]
        for name in ("mg_u8hwc_to_f32_norm", "mg_u8hwc_to_f32", "mg_jitter_brightness",
                     "mg_jitter_contrast", "mg_jitter_saturation", "mg_hue_shift"):
            getattr(lib, name).restype = None
        _lib = lib
        return lib


def _scale_bias(mean, std):
    mean = np.asarray(mean, np.float32).reshape(3)
    std = np.asarray(std, np.float32).reshape(3)
    return (1.0 / (255.0 * std)).astype(np.float32), (-mean / std).astype(np.float32)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _hwc3(img, op: str) -> np.ndarray:
    """A contiguous [H, W, 3] uint8 image with at least one pixel, checked
    before a pointer to it reaches native code."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"{op}: expected [H, W, 3] uint8, got shape {img.shape}")
    if img.size == 0:
        raise ValueError(f"{op}: empty image (zero pixels)")
    return img


# ------------------------------------------------------------ u8 -> f32
def u8_to_f32_norm_plain(img: np.ndarray, mean, std) -> np.ndarray:
    """numpy plain version of `u8_to_f32_norm`: the same per-channel
    v * 1/(255 std) - mean/std, one f32 rounding each."""
    scale, bias = _scale_bias(mean, std)
    return np.asarray(img, np.uint8).astype(np.float32) * scale + bias


def u8_to_f32_norm(img: np.ndarray, mean, std) -> np.ndarray:
    """[H, W, 3] u8 -> (x/255 - mean)/std f32, one fused native pass."""
    lib = load()
    img = _hwc3(img, "u8_to_f32_norm")
    scale, bias = _scale_bias(mean, std)
    out = np.empty(img.shape, np.float32)
    lib.mg_u8hwc_to_f32_norm(_u8p(img), img.shape[0] * img.shape[1], _f32p(scale),
                             _f32p(bias), _f32p(out))
    return out


def u8_to_f32_plain(img: np.ndarray) -> np.ndarray:
    """numpy plain version of `u8_to_f32`: v * f32(1/255)."""
    return np.asarray(img, np.uint8).astype(np.float32) * np.float32(1.0 / 255.0)


def u8_to_f32(img: np.ndarray) -> np.ndarray:
    """[...] u8 -> f32 in [0, 1]."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape, np.float32)
    lib.mg_u8hwc_to_f32(_u8p(img), img.size, _f32p(out))
    return out


# ------------------------------------------------------- colour jitter
def _jitter(name: str, img, factor: float) -> np.ndarray:
    lib = load()
    img = _hwc3(img, name)
    out = np.empty_like(img)
    getattr(lib, f"mg_{name}")(_u8p(img), img.shape[0] * img.shape[1], np.float32(factor),
                               _u8p(out))
    return out


def jitter_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """PIL ImageEnhance.Brightness.enhance(factor), bit-exact, one pass."""
    return _jitter("jitter_brightness", img, factor)


def jitter_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """PIL ImageEnhance.Contrast.enhance(factor), bit-exact (plus the mean
    luma reduction)."""
    return _jitter("jitter_contrast", img, factor)


def jitter_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    """PIL ImageEnhance.Color.enhance(factor), bit-exact, one pass."""
    return _jitter("jitter_saturation", img, factor)


def hue_shift(img: np.ndarray, shift: int) -> np.ndarray:
    """RGB -> HSV -> (H + shift, u8 wrap) -> RGB, bit-exact with PIL's
    convert chain, one pass."""
    lib = load()
    img = _hwc3(img, "hue_shift")
    out = np.empty_like(img)
    lib.mg_hue_shift(_u8p(img), img.shape[0] * img.shape[1], np.int32(shift), _u8p(out))
    return out
