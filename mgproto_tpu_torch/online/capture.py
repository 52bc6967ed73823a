"""Trusted capture: stage high-p(x) served samples for consolidation
(counterpart of mgproto_tpu/online/capture.py; its decisions on a seeded
stream equal the JAX package's, decision for decision).

The serving engine answers each request with a calibrated trust decision
(serving/gate.py); this is the tap behind it. Once a response leaves
`record()`, a sample whose log p(x) clears the CAPTURE gate (a stricter
percentile of the same calibration) is staged, with its predicted class as
the label, into a bounded per-class reservoir. Abstentions, rejects, sheds,
degraded predictions and low-p(x) predictions (the poison drill's
mislabeled junk) never stage; each decision is counted by outcome.

  * The engine's tap is `get_active()`: one module-global None-check when
    capture is off, an O(1) reservoir append when on. Raw payloads are
    staged; consolidation recomputes their features.
  * Per-class queues are bounded with seeded reservoir eviction: a full
    queue keeps an arriving sample with probability capacity/seen,
    displacing a uniformly drawn staged one.

A second reservoir (`recal_capacity`) keeps accepted samples for
recalibration; `drain` does not consume it. `submit_labeled` is the
operator-labeled path a new class needs: it bypasses the p(x) gate.

Neither torch nor numpy's global generator is used: the reservoirs draw
from their own `RandomState(seed)`.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from mgproto_tpu_torch.online import metrics as om

OUTCOME_ACCEPTED = "accepted"
OUTCOME_GATE_REJECTED = "gate_rejected"
OUTCOME_SKIPPED = "outcome_skipped"
OUTCOME_CLASS_UNKNOWN = "class_unknown"
OUTCOME_LABELED = "labeled"

DEFAULT_CAPTURE_PERCENTILE = 25.0


@dataclasses.dataclass(frozen=True)
class CaptureConfig:
    """Knobs of the trusted-capture gate and its staging reservoirs."""

    # log p(x) must exceed the calibration's threshold at THIS percentile
    # to stage (stricter than the abstention operating point: only
    # comfortably in-distribution traffic self-labels)
    percentile: float = DEFAULT_CAPTURE_PERCENTILE
    capacity_per_class: int = 64  # staging reservoir bound, per class
    recal_capacity: int = 128  # held-out recalibration reservoir (global)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class CapturedSample:
    """One staged sample: the raw payload plus its provenance."""

    payload: Any  # the validated input (features or image array)
    class_id: int
    log_px: Optional[float]
    request_id: str
    labeled: bool = False  # operator feedback (class addition) vs self-label


class TrustedCapture:
    """Per-class staging reservoirs behind the calibrated capture gate."""

    def __init__(
        self,
        calibration,
        num_classes: int,
        config: Optional[CaptureConfig] = None,
        tenant: Optional[str] = None,
    ):
        self.config = config or CaptureConfig()
        self.num_classes = int(num_classes)
        self.calibration = calibration
        # multi-tenant serving: a tenant-owned reservoir labels
        # its capture counters, so each tenant's self-labeling stream is
        # accounted separately. None = the single-tenant tap, unchanged.
        self.tenant = tenant
        self._labels = {} if tenant is None else {"tenant": str(tenant)}
        self.threshold: Optional[float] = None
        if calibration is not None:
            self.threshold = calibration.threshold_for(
                self.config.percentile
            )
        self._lock = threading.Lock()
        self._rng = np.random.RandomState(self.config.seed)
        self._queues: Dict[int, List[CapturedSample]] = {}
        self._seen: Dict[int, int] = {}  # accepted per class (reservoir N)
        self._recal: List[CapturedSample] = []
        self._recal_seen = 0
        self.accepted = 0
        self.evicted = 0
        # accepted request ids, bounded — the poison drill's ground truth
        # for "did mislabeled junk ever actually get staged"
        self._accepted_ids: Deque[str] = deque(maxlen=4096)
        self._accepted_set: set = set()

    def retarget(self, calibration) -> None:
        """Adopt a republished model's calibration: the capture gate must
        judge p(x) on the scale of the mixture NOW serving."""
        self.calibration = calibration
        self.threshold = (
            calibration.threshold_for(self.config.percentile)
            if calibration is not None else None
        )

    # ------------------------------------------------------------------- tap
    def on_response(self, payload, resp) -> bool:
        """The post-record() tap: stage `payload` iff `resp` is a trusted,
        gate-clearing prediction. Returns True when staged. Never raises —
        a capture bug must not take serving down."""
        try:
            if (
                resp.outcome != "predict"
                or resp.degraded
                or resp.trust != "in_dist"
                or resp.log_px is None
            ):
                om.counter(om.CAPTURED).inc(
                    outcome=OUTCOME_SKIPPED, **self._labels
                )
                return False
            if self.threshold is None or not (
                float(resp.log_px) > self.threshold
            ):
                # at-or-below the capture percentile (or no calibration to
                # gate with): the poison drill's low-p(x) mislabeled junk
                # lands here when it lands anywhere at all
                om.counter(om.CAPTURED).inc(
                    outcome=OUTCOME_GATE_REJECTED, **self._labels
                )
                return False
            cls = int(resp.prediction)
            if not 0 <= cls < self.num_classes:
                om.counter(om.CAPTURED).inc(
                    outcome=OUTCOME_CLASS_UNKNOWN, **self._labels
                )
                return False
            self._stage(CapturedSample(
                payload=payload,
                class_id=cls,
                log_px=float(resp.log_px),
                request_id=resp.request_id,
            ))
            om.counter(om.CAPTURED).inc(
                outcome=OUTCOME_ACCEPTED, **self._labels
            )
            return True
        except Exception:
            return False

    def submit_labeled(
        self, payload, class_id: int, request_id: str = ""
    ) -> bool:
        """Operator-labeled feedback (class addition): bypasses the p(x)
        gate — the serving mixture cannot score a class it does not know —
        but still bounded by the same reservoirs."""
        cls = int(class_id)
        if not 0 <= cls < self.num_classes:
            om.counter(om.CAPTURED).inc(
                outcome=OUTCOME_CLASS_UNKNOWN, **self._labels
            )
            return False
        self._stage(CapturedSample(
            payload=payload,
            class_id=cls,
            log_px=None,
            request_id=request_id,
            labeled=True,
        ))
        om.counter(om.CAPTURED).inc(
            outcome=OUTCOME_LABELED, **self._labels
        )
        return True

    def was_captured(self, request_id: str) -> bool:
        """True iff a sample with this request id was ever staged (over
        the last 4096 acceptances)."""
        with self._lock:
            return request_id in self._accepted_set

    def _stage(self, sample: CapturedSample) -> None:
        cap = max(int(self.config.capacity_per_class), 1)
        with self._lock:
            if sample.request_id:
                if len(self._accepted_ids) == self._accepted_ids.maxlen:
                    self._accepted_set.discard(self._accepted_ids[0])
                self._accepted_ids.append(sample.request_id)
                self._accepted_set.add(sample.request_id)
            q = self._queues.setdefault(sample.class_id, [])
            seen = self._seen.get(sample.class_id, 0) + 1
            self._seen[sample.class_id] = seen
            if len(q) < cap:
                q.append(sample)
            else:
                # reservoir step: keep with prob cap/seen, displacing a
                # uniformly random staged sample — the queue stays a
                # uniform sample of the class's accepted stream. Only an
                # actual displacement counts as an eviction (j >= cap
                # drops the ARRIVING sample, nothing staged moved).
                j = int(self._rng.randint(0, seen))
                if j < cap:
                    q[j] = sample
                    self.evicted += 1
                    om.counter(om.CAPTURE_EVICTED).inc()
            self.accepted += 1
            # recalibration holdout: plain reservoir over ALL accepted
            self._recal_seen += 1
            if len(self._recal) < max(int(self.config.recal_capacity), 1):
                self._recal.append(sample)
            else:
                j = int(self._rng.randint(0, self._recal_seen))
                if j < len(self._recal):
                    self._recal[j] = sample
            om.gauge(om.STAGED).set(float(
                sum(len(v) for v in self._queues.values())
            ))

    # ----------------------------------------------------------------- drain
    def staged_count(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def drain(self) -> List[CapturedSample]:
        """Pop EVERYTHING staged (consolidation's input), oldest class id
        first — deterministic order for a deterministic drill."""
        with self._lock:
            out: List[CapturedSample] = []
            for cls in sorted(self._queues):
                out.extend(self._queues[cls])
            self._queues.clear()
            om.gauge(om.STAGED).set(0.0)
            return out

    def recal_samples(self) -> List[CapturedSample]:
        """A COPY of the recalibration holdout (not consumed)."""
        with self._lock:
            return list(self._recal)

    def recal_batches(
        self, batch_size: int
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The holdout as full (images, labels) eval batches for the
        `calibrate()` path. Full batches only, so recalibration scores at
        one batch width."""
        samples = self.recal_samples()
        out = []
        for i in range(0, len(samples) - batch_size + 1, batch_size):
            chunk = samples[i:i + batch_size]
            out.append((
                np.stack([np.asarray(s.payload, np.float32) for s in chunk]),
                np.asarray([s.class_id for s in chunk], np.int32),
            ))
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "accepted": self.accepted,
                "evicted": self.evicted,
                "staged": sum(len(q) for q in self._queues.values()),
                "staged_classes": sorted(self._queues),
                "recal_held": len(self._recal),
                "threshold_log_px": self.threshold,
                "percentile": self.config.percentile,
            }


# --------------------------------------------------------- process-wide tap
# The serving engine consults this once a batch: disabled is
# one module-global None-check, no per-request work.
_ACTIVE: Optional[TrustedCapture] = None


def get_active() -> Optional[TrustedCapture]:
    """The process-active capture tap (None = capture off)."""
    return _ACTIVE


def install(capture: Optional[TrustedCapture]) -> Optional[TrustedCapture]:
    """Install `capture` as the process-active tap; returns the previous
    one so callers can restore it (the drill's and the CLI's try/finally)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = capture
    return prev


def uninstall() -> None:
    install(None)
