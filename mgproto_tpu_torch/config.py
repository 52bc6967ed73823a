"""Configuration of the port: a trimmed copy of mgproto_tpu/config.py.

Only the fields the serving forward reads. The field names and defaults are
the JAX package's, so one configuration describes both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model architecture (flagship: ResNet-34, 224 px, CUB-200)."""

    arch: str = "resnet34"
    img_size: int = 224
    num_classes: int = 200
    prototypes_per_class: int = 10
    proto_dim: int = 64
    add_on_type: str = "regular"  # 'regular' | 'bottleneck'
    sz_embedding: int = 32
    mine_T: int = 20
    init_sigma: float = 1.0 / math.sqrt(2.0 * math.pi)
    # only float32 is served by this package (numerics.py)
    compute_dtype: str = "float32"
    # density + top-T through the score_pool kernel (ops/fused_scoring.py).
    # None = the kernel on CUDA, the plain version on the CPU.
    fused_scoring: Optional[bool] = None
    # ResNet block tail through the BN epilogue kernel
    # (ops/fused_epilogue.py). None = the kernel on CUDA, plain on the CPU.
    fused_epilogue: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)


def tiny_test_config(
    num_classes: int = 4,
    prototypes_per_class: int = 3,
    proto_dim: int = 8,
    img_size: int = 32,
    mine_T: int = 4,
    arch: str = "tiny",
) -> Config:
    """Small config for tests (mirrors mgproto_tpu.config.tiny_test_config)."""
    return Config(
        model=ModelConfig(
            arch=arch,
            img_size=img_size,
            num_classes=num_classes,
            prototypes_per_class=prototypes_per_class,
            proto_dim=proto_dim,
            sz_embedding=8,
            mine_T=mine_T,
        )
    )
