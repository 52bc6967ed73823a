"""Numerics and device policy of the port.

What runs in which dtype is perf/precision.py's PrecisionPolicy: the trunk
in `ModelConfig.compute_dtype` (float32 or bfloat16), everything with an
absolute scale (master parameters, Adam moments, BatchNorm and EM
statistics, the bank, density and log p(x)) in float32. PyTorch's cuDNN
convolutions and matmuls default to TF32 on Hopper, which keeps about three
decimal digits; OoD thresholds ride on the absolute log p(x) scale
(mgproto_tpu/ops/gaussian.py keeps density math in full f32 for the same
reason), so TF32 is switched off for the f32 matmuls and convolutions alike.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

def apply_numerics_policy() -> None:
    """Full-f32 matmuls and convolutions (process-wide torch flags)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def use_kernel(flag: Optional[bool], device: torch.device) -> bool:
    """Resolve a `fused_*` config flag: None = the hand-written kernel on
    CUDA, the plain PyTorch version elsewhere; True/False force the route."""
    if flag is not None:
        return bool(flag)
    return device.type == "cuda"
