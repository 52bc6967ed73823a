"""TrustGate: calibrated OoD abstention over served log p(x)
(trimmed copy of mgproto_tpu/serving/gate.py).

  * `in_dist`: log p(x) strictly above the calibrated threshold;
  * `abstain`: at or below it (or non-finite);
  * `ungated`: degraded mode, no valid calibration.

A calibration is honored only when its GMM fingerprint and compute dtype
match what is served; otherwise the gate fails closed into degraded mode and
counts the mismatch. This package serves unquantized weights, so a
calibration stamped with a quant config is refused the same way.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np

from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.serving.calibration import Calibration

TRUST_IN_DIST = "in_dist"
TRUST_ABSTAIN = "abstain"
TRUST_UNGATED = "ungated"


class TrustGate:
    def __init__(
        self,
        calibration: Optional[Calibration],
        expected_fingerprint: Optional[str] = None,
        window: int = 256,
        expected_compute_dtype: Optional[str] = None,
    ):
        self.fingerprint_mismatch = False
        self.precision_mismatch = False
        if (
            calibration is not None
            and expected_fingerprint is not None
            and calibration.gmm_fingerprint != expected_fingerprint
        ):
            _m.counter(_m.FINGERPRINT_MISMATCHES).inc()
            self.fingerprint_mismatch = True
            calibration = None
        if calibration is not None and (
            (expected_compute_dtype and calibration.compute_dtype
             and calibration.compute_dtype != expected_compute_dtype)
            or calibration.quant_config
        ):
            _m.counter(_m.PRECISION_MISMATCHES).inc()
            self.precision_mismatch = True
            calibration = None
        self.calibration = calibration
        self.threshold = calibration.threshold_log_px if calibration is not None else None
        self._window: Deque[bool] = deque(maxlen=max(int(window), 1))

    @property
    def degraded(self) -> bool:
        return self.calibration is None

    def decide(self, log_px: Sequence[float]) -> List[str]:
        """Trust label per sample; updates the trailing abstain-rate gauge."""
        scores = np.asarray(log_px, np.float64).ravel()
        if self.calibration is None:
            return [TRUST_UNGATED] * scores.size
        labels = []
        for s in scores:
            # <= as evaluate_with_ood's `score > thresh` in-distribution rule
            abstain = (not np.isfinite(s)) or (s <= self.threshold)
            labels.append(TRUST_ABSTAIN if abstain else TRUST_IN_DIST)
            self._window.append(abstain)
        if self._window:
            _m.gauge(_m.ABSTAIN_RATE).set(sum(self._window) / len(self._window))
        return labels

    def trust_score(self, log_px: float) -> Optional[float]:
        if self.calibration is None or not np.isfinite(log_px):
            return None
        return self.calibration.id_quantile_of(float(log_px))

    def confidence(self, logits_row: Sequence[float]) -> Optional[float]:
        """Max softmax over temperature-scaled class log-likelihoods."""
        if self.calibration is None:
            return None
        try:
            z = np.asarray(logits_row, np.float64) / np.asarray(
                self.calibration.per_class_temperature, np.float64
            )
            if np.isnan(z).any() or np.isposinf(z).any():
                return None
            m = z.max()
            if not np.isfinite(m):
                return None
            p = np.exp(z - m)
            return float(p.max() / p.sum())
        except (ValueError, TypeError):
            return None
