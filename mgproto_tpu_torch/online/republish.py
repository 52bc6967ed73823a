"""Drift-triggered republish: recalibrate the candidate, swap it in with
zero drops (counterpart of mgproto_tpu/online/republish.py).

When the drift monitor breaches (on `min_confirmations` evaluations in a
row, at most once per `min_interval_s`) the republisher

  1. RECALIBRATES: the injected `recalibrate` closure scores held-out
     samples under the candidate (serving/calibration.py `calibrate`, the
     fingerprint stamped from the candidate's own mixture). A failure is
     counted as a refusal (`recalibrate_failed`) and serving goes on;
  2. PROMOTES through the blue/green swap (serving/swap.py `hot_swap`,
     `require_calibrated`): a standby fleet from `factory_builder(
     calibration)` is staged, warmed and verified fail-closed before
     traffic flips. The factory builds the candidate's engines over a model
     of their own, never the serving one;
  3. on commit, calls `on_commit(calibration)` (the drill rebases its drift
     monitor and retargets its capture there).

A refused promotion is an outcome, not an error: the old model serves on
and `online_republish_total{result=rejected}` counts it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from mgproto_tpu_torch.obs.flightrec import record_event
from mgproto_tpu_torch.online import metrics as om

RESULT_COMMITTED = "committed"
RESULT_REJECTED = "rejected"


@dataclasses.dataclass(frozen=True)
class RepublishRecord:
    """One attempt, committed or refused."""

    t: float
    result: str
    swap: Dict[str, Any]  # serving.swap.SwapReport.to_dict()
    calibration_fingerprint: Optional[str]
    trigger_signals: tuple

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["trigger_signals"] = list(self.trigger_signals)
        return d


class Republisher:
    """Drift breach -> recalibrate -> blue/green promote (see module
    docstring). The model stack enters only through the injected closures,
    so this module stays importable on a bare serving host."""

    def __init__(
        self,
        replica_set,
        recalibrate: Callable[[], Any],  # -> serving Calibration (candidate)
        factory_builder: Callable[[Any], Callable],  # calibration -> engine factory
        clock=time.monotonic,
        min_interval_s: float = 5.0,
        min_confirmations: int = 2,
        require_calibrated: bool = True,
        on_commit: Optional[Callable[[Any], None]] = None,
    ):
        self.replica_set = replica_set
        self.recalibrate = recalibrate
        self.factory_builder = factory_builder
        self.clock = clock
        self.min_interval_s = float(min_interval_s)
        # a republish is a fleet-wide warmup event: demand the breach hold
        # over this many CONSECUTIVE drift evaluations before acting, so a
        # single noisy window cannot thrash the fleet (and the detection
        # timestamp provably precedes the correction)
        self.min_confirmations = max(int(min_confirmations), 1)
        self.require_calibrated = require_calibrated
        self.on_commit = on_commit
        self._next_allowed = self.clock()
        self._consecutive = 0
        self.records: List[RepublishRecord] = []

    @property
    def committed(self) -> int:
        return sum(r.result == RESULT_COMMITTED for r in self.records)

    def maybe_republish(
        self, drift_report, now: Optional[float] = None
    ) -> Optional[RepublishRecord]:
        """Attempt a republish iff `drift_report` breached and the
        interval allows. Returns the record of an attempt, else None."""
        from mgproto_tpu_torch.serving.swap import hot_swap

        if drift_report is None:
            return None
        if not drift_report.breached:
            self._consecutive = 0
            return None
        self._consecutive += 1
        if self._consecutive < self.min_confirmations:
            return None
        now = self.clock() if now is None else now
        if now < self._next_allowed:
            return None
        self._next_allowed = now + self.min_interval_s
        record_event(
            "republish_triggered",
            signals=",".join(drift_report.signals),
            px_divergence=drift_report.px_divergence,
        )
        try:
            calibration = self.recalibrate()
        except Exception as e:
            # recalibration failing must not take serving down: count the
            # refusal, keep the old model, let the breach keep ringing
            report = {"ok": False, "reason": "recalibrate_failed",
                      "detail": f"{type(e).__name__}: {e}"}
            rec = RepublishRecord(
                t=now, result=RESULT_REJECTED, swap=report,
                calibration_fingerprint=None,
                trigger_signals=drift_report.signals,
            )
            om.counter(om.REPUBLISH).inc(result=RESULT_REJECTED)
            record_event("republish_rejected", reason="recalibrate_failed")
            self.records.append(rec)
            return rec
        factory = self.factory_builder(calibration)
        swap = hot_swap(
            self.replica_set, factory,
            require_calibrated=self.require_calibrated,
        )
        result = RESULT_COMMITTED if swap.ok else RESULT_REJECTED
        rec = RepublishRecord(
            t=now,
            result=result,
            swap=swap.to_dict(),
            calibration_fingerprint=getattr(
                calibration, "gmm_fingerprint", None
            ),
            trigger_signals=drift_report.signals,
        )
        om.counter(om.REPUBLISH).inc(result=result)
        record_event(f"republish_{result}", reason=swap.reason)
        self.records.append(rec)
        if swap.ok and self.on_commit is not None:
            self.on_commit(calibration)
        return rec
