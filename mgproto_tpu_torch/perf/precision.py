"""PrecisionPolicy: what runs in which dtype (counterpart of
mgproto_tpu/perf/precision.py, with torch dtypes).

`compute_dtype="bfloat16"` runs the backbone trunk in bf16: the convs, the
BatchNorm apply, the add-on 1x1 convs and the backward through them. What
carries an absolute scale stays float32:

  * master parameters and the Adam moments (the modules are never cast;
    a conv casts its f32 weight to the activation dtype at each call);
  * BatchNorm batch statistics and running statistics;
  * the EM sufficient statistics, the [C, cap, d] memory bank and the
    enqueue candidates (`assert_f32_stats` at the bank and EM entries);
  * density math, log p(x) and the served calibration (the proto map is
    cast to f32 at the trunk's exit, core/mgproto.py).

`resolve_policy` derives the policy from a Config; `policy_meta` is the
provenance block `run_training` writes into each checkpoint's metadata
(cli/train.py). TF32 stays off for the f32 parts
(numerics.py). The module imports no torch, so a Config validates its
dtype in a process that has none (a loader worker).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

SUPPORTED_COMPUTE_DTYPES = ("float32", "bfloat16")

# dtypes that must never appear in EM statistics, the bank or calibration math
HALF_DTYPES = ("bfloat16", "float16")


class PrecisionError(TypeError):
    """A tensor violated the policy's f32-statistics invariant."""


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Only `compute_dtype` is a knob; the f32 fields are stated so a run's
    metadata carries the whole policy, and refused if set otherwise."""

    compute_dtype: str = "float32"  # trunk activations and their gradients
    param_dtype: str = "float32"  # master parameters + optimizer moments
    stats_dtype: str = "float32"  # EM sufficient statistics, bank, BN statistics
    score_dtype: str = "float32"  # density, log p(x), calibration

    def __post_init__(self):
        if self.compute_dtype not in SUPPORTED_COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {SUPPORTED_COMPUTE_DTYPES}, "
                f"got {self.compute_dtype!r}"
            )
        for field in ("param_dtype", "stats_dtype", "score_dtype"):
            if getattr(self, field) != "float32":
                raise ValueError(
                    f"{field} is not a knob: it must stay float32 "
                    f"(got {getattr(self, field)!r}); see module docstring"
                )

    @property
    def mixed(self) -> bool:
        return self.compute_dtype != "float32"

    @property
    def torch_dtype(self):
        """The trunk's activation dtype, a torch.dtype."""
        import torch

        return getattr(torch, self.compute_dtype)


def resolve_policy(cfg) -> PrecisionPolicy:
    """The policy a Config (or its ModelConfig) implies."""
    model = getattr(cfg, "model", cfg)
    return PrecisionPolicy(compute_dtype=model.compute_dtype)


def policy_meta(policy: PrecisionPolicy) -> Dict[str, Any]:
    """Provenance block for a run's metadata."""
    return {
        "compute_dtype": policy.compute_dtype,
        "param_dtype": policy.param_dtype,
        "stats_dtype": policy.stats_dtype,
        "score_dtype": policy.score_dtype,
        "mixed": policy.mixed,
    }


def is_half_dtype(dtype: Any) -> bool:
    """True for bf16/f16, a torch dtype or its name."""
    return str(dtype).removeprefix("torch.") in HALF_DTYPES


def assert_f32_stats(x: Any, what: str) -> Any:
    """Raise PrecisionError if a statistics tensor is half precision. Called
    at the bank and EM entry points (core/memory.py, core/em.py) on the
    tensors the f32-statistics invariant protects; a dtype check on the
    host, no device work. Returns `x` unchanged."""
    dtype = getattr(x, "dtype", None)
    if dtype is not None and is_half_dtype(dtype):
        raise PrecisionError(
            f"{what} is {dtype} but the precision policy pins EM/bank/"
            "score statistics to float32 (perf/precision.py): a half-"
            "precision statistic silently shifts the p(x) scale every "
            "calibrated threshold depends on"
        )
    return x
