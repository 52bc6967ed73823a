"""Per-request input validation: a typed reject, never a device error
(copy of mgproto_tpu/serving/validate.py).

The serving boundary is where arbitrary caller bytes meet the model. Anything that would crash, retrace, or silently poison the device
computation is converted HERE into a `ValidationFailure` with a machine-
readable reason — shapes that don't match the artifact, dtypes that can't
losslessly become float32, NaN/Inf pixels, absurd value ranges. Host-side
numpy only: by the time an array is copied to the device it is exactly
`float32 [H, W, 3]` with finite values.

The checks are ordered cheapest-first and the NaN scrub is LAST: a payload
can fail several ways, and the reported reason should be the structural one
(a string payload is "malformed", not "non-finite").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

# |pixel| bound AFTER normalization: ImageNet-normalized pixels live within
# ~[-3, 3]; 64 leaves headroom for exotic normalizations while still
# rejecting e.g. raw uint16 sensor dumps that would shift log p(x) scales
MAX_ABS_PIXEL = 64.0

REASON_MALFORMED = "malformed"
REASON_BAD_SHAPE = "bad_shape"
REASON_BAD_DTYPE = "bad_dtype"
REASON_NONFINITE = "nonfinite"
REASON_OUT_OF_RANGE = "out_of_range"


class ValidationFailure(ValueError):
    """Typed rejection: `reason` is one of the REASON_* constants."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class ValidationSpec:
    """What the compiled program accepts (from the artifact/model config)."""

    img_size: int
    channels: int = 3
    max_abs: float = MAX_ABS_PIXEL


def validate_image(payload: Any, spec: ValidationSpec) -> np.ndarray:
    """One request's payload -> a clean float32 [H, W, 3] array, or raise
    ValidationFailure. Accepts anything numpy can coerce to a numeric array
    of the right shape; never lets a bad payload reach the device."""
    try:
        arr = np.asarray(payload)
    except Exception as e:
        raise ValidationFailure(REASON_MALFORMED, f"not array-like: {e}")
    if arr.dtype == object or arr.dtype.kind in "USV":
        raise ValidationFailure(
            REASON_BAD_DTYPE, f"non-numeric dtype {arr.dtype}"
        )
    want = (spec.img_size, spec.img_size, spec.channels)
    if arr.shape != want:
        raise ValidationFailure(
            REASON_BAD_SHAPE, f"got {arr.shape}, artifact expects {want}"
        )
    if arr.dtype.kind not in "fiub":
        raise ValidationFailure(
            REASON_BAD_DTYPE, f"cannot serve dtype {arr.dtype}"
        )
    arr = arr.astype(np.float32)
    if not np.isfinite(arr).all():
        raise ValidationFailure(REASON_NONFINITE, "NaN/Inf pixels")
    peak = float(np.abs(arr).max()) if arr.size else 0.0
    if peak > spec.max_abs:
        raise ValidationFailure(
            REASON_OUT_OF_RANGE,
            f"|pixel| max {peak:.3g} exceeds {spec.max_abs:g}",
        )
    return arr


def validate_batch(
    payload: Any, spec: ValidationSpec, max_batch: Optional[int] = None
) -> np.ndarray:
    """A [N, H, W, 3] batch payload -> clean float32 array (same checks)."""
    try:
        arr = np.asarray(payload)
    except Exception as e:
        raise ValidationFailure(REASON_MALFORMED, f"not array-like: {e}")
    if arr.ndim != 4:
        raise ValidationFailure(
            REASON_BAD_SHAPE, f"batch must be 4-d, got ndim={arr.ndim}"
        )
    if max_batch is not None and arr.shape[0] > max_batch:
        raise ValidationFailure(
            REASON_BAD_SHAPE,
            f"batch of {arr.shape[0]} exceeds max {max_batch}",
        )
    rows = [validate_image(row, spec) for row in arr]
    return (
        np.stack(rows)
        if rows
        else np.zeros((0, spec.img_size, spec.img_size, spec.channels),
                      np.float32)
    )
