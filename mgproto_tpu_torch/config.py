"""Configuration of the port: a trimmed copy of mgproto_tpu/config.py.

Only the fields the serving forward, the synchronous training step, the
training input path and the training schedule (cli/train.py) read.
The field names and defaults are the JAX package's, so one configuration
describes both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple


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
    mem_capacity: int = 800  # per-class memory-bank capacity
    init_sigma: float = 1.0 / math.sqrt(2.0 * math.pi)
    # only float32 is served and trained by this package (numerics.py)
    compute_dtype: str = "float32"
    # density + top-T through the score_pool kernels (ops/fused_scoring.py).
    # None = the kernels on CUDA, the plain version on the CPU.
    fused_scoring: Optional[bool] = None
    # ResNet block tail through the BN epilogue kernel
    # (ops/fused_epilogue.py). None = the kernel on CUDA, plain on the CPU.
    fused_epilogue: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class EMConfig:
    """EM over the memory bank (core/em.py)."""

    num_em_loop: int = 3
    alpha: float = 0.1  # responsibility additive smoothing
    tau: float = 0.990  # prior momentum
    diversity_lambda: float = 1.0
    mean_lr: float = 3e-3  # Adam on the means
    update_interval: int = 1  # EM every N train steps
    # compact dirty-class EM width: -1 = auto (min(C, train batch)), 0 = dense
    max_active_classes: int = -1
    # E-step through the em_estep kernel (ops/em_kernels.py). None = the
    # kernel on CUDA, the plain version on the CPU.
    fused_estep: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer groups (torch Adam with L2 added to the gradient). The aux
    embedding Linear is in no group: frozen, gradients flow through it."""

    features_lr: float = 1e-4
    add_on_lr: float = 3e-3
    aux_proxies_lr: float = 1e-2
    weight_decay: float = 1e-4
    lr_decay_gamma: float = 0.4
    lr_decay_epochs: Tuple[int, ...] = (30, 45, 60, 75, 90)


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """The training schedule: epoch gates, push epochs and the final prune."""

    num_train_epochs: int = 120
    num_warm_epochs: int = 0
    mine_start: int = 40
    update_gmm_start: int = 35
    push_start: int = 100
    push_every: int = 10
    prune_top_m: int = 8
    # rescale the kept priors to sum to 1 per class after the prune
    # (core/mgproto.py `prune_top_m`); False keeps the reference's priors
    prune_renormalize: bool = False

    def push_epochs(self) -> List[int]:
        return [e for e in range(self.num_train_epochs)
                if e % self.push_every == 0 and e >= self.push_start]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss coefficients. The aux loss is Proxy-Anchor (the JAX package's
    default; its other five aux losses are not ported)."""

    crs_ent: float = 1.0
    mine: float = 0.2
    aux: float = 0.5


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths, batch sizes and the input pipeline (reference
    settings.py:8-24; data/__init__.py `build_pipelines`)."""

    train_dir: str = ""
    test_dir: str = ""
    train_push_dir: str = ""
    ood_dirs: Tuple[str, ...] = ()
    train_batch_size: int = 80
    test_batch_size: int = 80
    train_push_batch_size: int = 80
    num_workers: int = 8
    # "thread" overlaps PIL decode with device compute; "process" (spawn
    # pool, dataset pickled once per worker) also runs the numpy
    # augmentation math past the GIL. Applied to the TRAIN loader only.
    worker_backend: str = "thread"
    # batches `Trainer.train_epoch` holds in flight (data/loader.py
    # `device_prefetch`), so batch N+1's host-to-device copy overlaps step N
    prefetch_depth: int = 2
    # uint8 wire + device augmentation tail (ops/augment.py): the host train
    # pipeline stops at geometry and ships uint8; flip, colour jitter and
    # normalize run in the step on the batch's device, seeded per sample.
    # None = on for a CUDA device, off for the CPU; True/False force it.
    device_augment: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    em: EMConfig = dataclasses.field(default_factory=EMConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    seed: int = 0  # the loaders' shuffle and augmentation streams
    # checkpoints, train.log, metrics.jsonl and push_provenance.json
    model_dir: str = "./saved_models"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def tiny_test_config(
    num_classes: int = 4,
    prototypes_per_class: int = 3,
    proto_dim: int = 8,
    img_size: int = 32,
    mem_capacity: int = 16,
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
            mem_capacity=mem_capacity,
        ),
        schedule=ScheduleConfig(num_train_epochs=2, mine_start=0, update_gmm_start=0,
                                push_start=1, push_every=1, prune_top_m=2),
    )
