"""Build and load the port's CUDA kernels.

Each source in `mgproto_tpu_torch/csrc/` is compiled by `nvcc` for `sm_90a`
into its own shared library with a plain C interface, loaded with `ctypes`.
Libraries are named by a hash of their source and flags and kept in
`build/torch_kernels/` at the repository root (listed in .gitignore), so a
second process reuses them and an edited source is rebuilt. Nothing is
compiled when this module is imported: the first launch (or `build_all`)
compiles, every source in its own `nvcc` process, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

SOURCES = {
    "score_pool": "score_pool.cu",
    "bn_epilogue": "bn_epilogue.cu",
    "score_pool_bwd": "score_pool_bwd.cu",
    "em_estep": "em_estep.cu",
}

# the kernels each CLI face launches on the card: a served resnet forward
# (the trunk's epilogue and the head's scoring), --online's consolidation
# (the E-step besides), and the synthetic trust drill (the tiny trunk has no
# residual tail; its bootstrap consolidation runs the E-step)
SERVE_KERNELS = ("score_pool", "bn_epilogue")
ONLINE_KERNELS = SERVE_KERNELS + ("em_estep",)
SYNTHETIC_KERNELS = ("score_pool", "em_estep")

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C interface of each library: function -> (argument types, return
# type). Declared once, when the library is loaded; every launcher returns
# a cudaError_t as int.
SIGNATURES = {
    "score_pool": {
        "score_pool_fwd": ([_PTR] * 6 + [_INT] * 5 + [_PTR], _INT),
    },
    "bn_epilogue": {
        "bn_epilogue_f32": ([_PTR] * 5 + [_I64, _INT, _PTR], _INT),
        "bn_epilogue_bf16": ([_PTR] * 5 + [_I64, _INT, _PTR], _INT),
    },
    "score_pool_bwd": {
        "score_pool_bwd": ([_PTR] * 7 + [_INT] * 5 + [_PTR], _INT),
        "score_pool_bwd_scratch_bytes": ([_INT] * 5, _I64),
    },
    "em_estep": {
        "em_estep": ([_PTR] * 9 + [_INT] * 4 + [_PTR], _INT),
        "em_estep_scratch_bytes": ([_INT] * 4, _I64),
    },
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc processes this process has started (the online plane's
# `steady_recompiles` reads it: a build after warmup is a cold path)
builds = 0


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _target(name: str) -> str:
    h = hashlib.sha256()
    # the source and the headers every source may include
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in (SOURCES[name], *headers):
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every named kernel that has no up-to-date library, one nvcc
    per source, all in parallel. Returns name -> library path. The ptxas
    report (registers, shared memory, spills) of each build is kept beside
    its library as `<lib>.log`."""
    global builds
    os.makedirs(BUILD_DIR, exist_ok=True)
    out: Dict[str, str] = {}
    procs = []
    for name in names:
        target = _target(name)
        out[name] = target
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        builds += 1
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        with open(target + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's report from the build of kernel `name`."""
    with open(_target(name) + ".log") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed, with
    the signatures of its functions declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(path)
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            for fn_name, (argtypes, restype) in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, restype
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
