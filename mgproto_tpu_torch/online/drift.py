"""Drift detection via p(x) (counterpart of mgproto_tpu/online/drift.py).

MGProto is a generative classifier: summing p(x|c) gives a calibrated p(x)
that measures how well a request fits the distribution the banks were fit
on. When traffic drifts, p(x) falls while the argmax often still holds, so
drift shows before accuracy pays for it. Two signals, both against the
artifact's own calibration:

  * the p(x) QUANTILE-SKETCH DIVERGENCE: the calibration carries a
    101-point quantile sketch of held-out ID log p(x); the monitor keeps a
    bounded window of served scores, takes the same quantiles and reports
    their mean absolute displacement over the interior points, in units of
    the calibration sketch's interquartile range;
  * the PER-CLASS BANK MEAN AND VARIANCE SHIFT: each class's bank mean (L2)
    and diagonal variance (mean |delta|) against the calibration-time
    baseline (the mean-embedding view of "Deep Mean Maps").

A breach counts `drift_breach_total{signal=px|bank}` and records a
flight-recorder event. `evaluate` is cadence-gated on an injectable clock
and never sleeps. numpy and the standard library only.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from mgproto_tpu_torch.obs.flightrec import record_event
from mgproto_tpu_torch.online import metrics as om

SIGNAL_PX = "px"
SIGNAL_BANK = "bank"


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    px_window: int = 512  # serving-time log p(x) scores kept
    min_px_samples: int = 64  # below this the px signal stays quiet
    eval_interval_s: float = 1.0  # cadence of `evaluate` (injected clock)
    # breach thresholds; <= 0 disables a signal
    px_divergence_threshold: float = 0.35  # in calibration-IQR units
    mean_shift_threshold: float = 0.25  # L2 in feature space
    cov_shift_threshold: float = 0.0  # mean |Δ diag var|; default observe-only


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One cadence evaluation — always returned, breach or not."""

    t: float
    px_divergence: Optional[float]
    mean_shift_max: float
    cov_shift_max: float
    class_shifts: Dict[int, float]  # per-class bank mean L2 shift
    breached: bool
    signals: Tuple[str, ...]  # which thresholds breached

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["signals"] = list(self.signals)
        d["class_shifts"] = {
            str(k): v for k, v in self.class_shifts.items()
        }
        return d


def bank_moments(
    feats: np.ndarray, length: np.ndarray
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """{class: (mean [d], diag var [d])} over each class's VALID bank rows
    (circular buffer: row order is irrelevant to moments). Classes with an
    empty bank are omitted — no data, no drift claim."""
    feats = np.asarray(feats, np.float64)
    length = np.asarray(length)
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for c in range(feats.shape[0]):
        n = int(length[c])
        if n <= 0:
            continue
        rows = feats[c, : min(n, feats.shape[1])]
        out[c] = (rows.mean(axis=0), rows.var(axis=0))
    return out


class DriftMonitor:
    """Serving-time drift gauges against a calibration-time baseline."""

    def __init__(
        self,
        calibration,
        config: Optional[DriftConfig] = None,
        clock=time.monotonic,
        tenant: Optional[str] = None,
    ):
        self.config = config or DriftConfig()
        self.clock = clock
        self.calibration = calibration
        # multi-tenant serving: a tenant-owned monitor labels
        # every gauge/breach with its tenant, so one tenant's drifting
        # traffic is ATTRIBUTED, not a fleet-wide alarm. None = the
        # single-tenant monitor, metrics unchanged.
        self.tenant = tenant
        self._labels = {} if tenant is None else {"tenant": str(tenant)}
        self._scores: Deque[float] = deque(
            maxlen=max(int(self.config.px_window), 1)
        )
        self._baseline: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._current: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._next_eval = self.clock()
        self.breaches = 0
        self.first_breach: Optional[DriftReport] = None
        self.last_report: Optional[DriftReport] = None

    # ------------------------------------------------------------ observation
    def set_bank_baseline(self, feats, length) -> None:
        """Freeze the calibration-time bank moments (the Deep-Mean-Maps
        reference point the shift gauges measure against)."""
        self._baseline = bank_moments(feats, length)
        self._current = dict(self._baseline)

    def observe_px(self, log_px: float) -> None:
        """One served score into the sliding window (predict/abstain
        responses both carry it — abstentions are exactly the drifted
        tail the monitor must see)."""
        if log_px is not None and np.isfinite(log_px):
            self._scores.append(float(log_px))

    def observe_bank(self, feats, length) -> None:
        """Refresh the current bank moments (the consolidation cadence
        calls this after each run — bank reads stay off the pump)."""
        self._current = bank_moments(feats, length)

    # ------------------------------------------------------------- evaluation
    def px_divergence(self) -> Optional[float]:
        """Mean |serving quantile - calibration quantile| over the interior
        sketch points, in units of the calibration sketch's IQR. None until
        the window holds `min_px_samples` scores."""
        if (
            self.calibration is None
            or len(self._scores) < self.config.min_px_samples
        ):
            return None
        ref = np.asarray(self.calibration.quantile_log_px, np.float64)
        pts = np.linspace(0.0, 100.0, ref.size)
        # interior points only: the extreme tails of a bounded window are
        # order statistics of a few samples — all noise, no signal
        interior = (pts >= 5.0) & (pts <= 95.0)
        window = np.asarray(self._scores, np.float64)
        cur = np.percentile(window, pts[interior])
        iqr = float(
            np.interp(75.0, pts, ref) - np.interp(25.0, pts, ref)
        )
        iqr = max(iqr, 1e-9)
        return float(np.mean(np.abs(cur - ref[interior])) / iqr)

    def bank_shift(self) -> Tuple[float, float, Dict[int, float]]:
        """(max mean L2 shift, max mean |Δ diag var|, per-class mean
        shifts) of the current bank moments vs the baseline."""
        mean_max, cov_max = 0.0, 0.0
        per_class: Dict[int, float] = {}
        for c, (mu, var) in self._current.items():
            base = self._baseline.get(c)
            if base is None:
                continue
            d_mu = float(np.linalg.norm(mu - base[0]))
            d_var = float(np.mean(np.abs(var - base[1])))
            per_class[c] = d_mu
            mean_max = max(mean_max, d_mu)
            cov_max = max(cov_max, d_var)
        return mean_max, cov_max, per_class

    def evaluate(self, now: Optional[float] = None) -> Optional[DriftReport]:
        """Cadence-gated evaluation: None when the interval has not
        elapsed; else a DriftReport, with gauges refreshed and breaches
        counted + flight-recorded."""
        now = self.clock() if now is None else now
        if now < self._next_eval:
            return None
        self._next_eval = now + self.config.eval_interval_s
        cfg = self.config
        div = self.px_divergence()
        mean_max, cov_max, per_class = self.bank_shift()
        signals: List[str] = []
        if (
            div is not None
            and cfg.px_divergence_threshold > 0
            and div > cfg.px_divergence_threshold
        ):
            signals.append(SIGNAL_PX)
        if (
            cfg.mean_shift_threshold > 0
            and mean_max > cfg.mean_shift_threshold
        ) or (
            cfg.cov_shift_threshold > 0
            and cov_max > cfg.cov_shift_threshold
        ):
            signals.append(SIGNAL_BANK)
        if div is not None:
            om.gauge(om.DRIFT_PX_DIVERGENCE).set(div, **self._labels)
        om.gauge(om.DRIFT_SHIFT_MAX).set(mean_max, **self._labels)
        om.gauge(om.DRIFT_COV_SHIFT_MAX).set(cov_max, **self._labels)
        for c, v in per_class.items():
            om.gauge(om.DRIFT_CLASS_SHIFT).set(
                v, **{"class": str(c), **self._labels}
            )
        report = DriftReport(
            t=now,
            px_divergence=div,
            mean_shift_max=mean_max,
            cov_shift_max=cov_max,
            class_shifts=per_class,
            breached=bool(signals),
            signals=tuple(signals),
        )
        if signals:
            self.breaches += 1
            if self.first_breach is None:
                self.first_breach = report
            for sig in signals:
                om.counter(om.DRIFT_BREACHES).inc(
                    signal=sig, **self._labels
                )
            record_event(
                "drift_breach",
                signals=",".join(signals),
                px_divergence=div,
                mean_shift_max=mean_max,
                **self._labels,
            )
        self.last_report = report
        return report

    # --------------------------------------------------------------- rebase
    def rebase(self, calibration, feats=None, length=None) -> None:
        """Adopt a republished model's calibration (and optionally its
        consolidated bank) as the new reference: the window clears, the
        breach latch resets — the monitor now watches for drift away from
        the CORRECTED model, not the old one."""
        self.calibration = calibration
        self._scores.clear()
        if feats is not None and length is not None:
            self.set_bank_baseline(feats, length)
        else:
            self._baseline = dict(self._current)
        self.first_breach = None
        record_event("drift_rebase")
