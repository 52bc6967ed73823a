"""ServingEngine: bucketed, trust-gated inference over a frozen model
(counterpart of mgproto_tpu/serving/engine.py).

  * Fixed batch-size BUCKETS: a batch is padded to the smallest bucket that
    fits and the padding is sliced off the results; `warmup` runs each
    bucket once before traffic (first-launch costs such as kernel builds and
    cuDNN algorithm selection are paid there).
  * Typed responses, never exceptions: payloads are validated host-side
    into typed rejects; device failures are answered as rejects and feed
    the circuit breaker; overload is shed by the admission queue.
  * Trust gating: every prediction carries log p(x) and a trust label from
    the calibrated gate; without a valid calibration the engine serves in
    degraded mode, flagged per response.

`from_live(evaluator)` serves an `engine.eval.Evaluator`.
"""

from __future__ import annotations

import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.serving.admission import AdmissionQueue, CircuitBreaker, ServeRequest
from mgproto_tpu_torch.serving.calibration import Calibration, gmm_fingerprint
from mgproto_tpu_torch.serving.gate import TRUST_ABSTAIN, TRUST_UNGATED, TrustGate
from mgproto_tpu_torch.serving.response import (
    OUTCOME_ABSTAIN,
    OUTCOME_PREDICT,
    OUTCOME_REJECT,
    OUTCOME_SHED,
    REASON_CIRCUIT_OPEN,
    REASON_DEVICE_ERROR,
    ServeResponse,
    record as _record_response,
)
from mgproto_tpu_torch.serving.validate import ValidationFailure, ValidationSpec, validate_image

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8)


class ServingEngine:
    def __init__(
        self,
        infer_fn: Callable[[np.ndarray], Dict[str, np.ndarray]],
        img_size: int,
        num_classes: int,
        calibration: Optional[Calibration] = None,
        expected_fingerprint: Optional[str] = None,
        expected_compute_dtype: Optional[str] = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        queue_capacity: int = 64,
        breaker: Optional[CircuitBreaker] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        """`infer_fn` maps float32 images [b, H, W, 3] to
        {"logits": [b, C], "log_px": [b]} numpy arrays."""
        if not buckets:
            raise ValueError("need at least one batch-size bucket")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if self.buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {self.buckets}")
        self.infer_fn = infer_fn
        self.img_size = int(img_size)
        self.num_classes = int(num_classes)
        self.spec = ValidationSpec(img_size=self.img_size)
        self.clock = clock
        self.gate = TrustGate(
            calibration,
            expected_fingerprint=expected_fingerprint,
            expected_compute_dtype=expected_compute_dtype,
        )
        self.queue = AdmissionQueue(capacity=queue_capacity, clock=clock)
        self.breaker = breaker if breaker is not None else CircuitBreaker(clock=clock)
        self.warmup_report: List[Dict[str, Any]] = []
        self.dispatch_count = 0  # device dispatches that returned results
        self.last_dispatch_error: Optional[str] = None  # traceback text
        self._request_seq = 0

    @classmethod
    def from_live(cls, evaluator, calibration: Optional[Calibration] = None,
                  **kw) -> "ServingEngine":
        """Serve an Evaluator. The expected fingerprint is the served GMM's,
        so a calibration measured on another mixture degrades the engine."""

        def infer(images: np.ndarray) -> Dict[str, np.ndarray]:
            out = evaluator(images)
            return {"logits": out.logits.cpu().numpy(), "log_px": out.log_px.cpu().numpy()}

        return cls(
            infer,
            img_size=evaluator.cfg.model.img_size,
            num_classes=evaluator.cfg.model.num_classes,
            calibration=calibration,
            expected_fingerprint=gmm_fingerprint(evaluator.gmm),
            expected_compute_dtype=evaluator.cfg.model.compute_dtype,
            **kw,
        )

    def warmup(self) -> List[Dict[str, Any]]:
        """Run every bucket shape once ahead of traffic; returns (and keeps)
        [{bucket, seconds}, ...]."""
        self.warmup_report = []
        for b in self.buckets:
            zeros = np.zeros((b, self.img_size, self.img_size, 3), np.float32)
            t0 = time.perf_counter()
            out = self.infer_fn(zeros)
            if np.asarray(out["log_px"]).shape != (b,):
                raise RuntimeError(f"bucket {b}: infer_fn broke its output contract")
            self.warmup_report.append({"bucket": b, "seconds": time.perf_counter() - t0})
        return self.warmup_report

    # ------------------------------------------------------------- admission
    def submit(self, payload: Any, request_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> List[ServeResponse]:
        """Validate + admit one request. Returns the immediate typed
        responses (a validation reject, shed responses); empty = queued."""
        t0 = self.clock()
        seq = self._request_seq
        self._request_seq += 1
        if deadline_s is not None and deadline_s <= 0:
            _m.counter(_m.SHED).inc(reason="deadline")
            return [self._respond(ServeResponse(
                request_id=request_id or f"v{seq}", outcome=OUTCOME_SHED,
                reason="deadline", degraded=self.gate.degraded, latency_s=0.0,
            ))]
        try:
            clean = validate_image(payload, self.spec)
        except ValidationFailure as e:
            return [self._respond(ServeResponse(
                request_id=request_id or f"v{seq}", outcome=OUTCOME_REJECT,
                reason=e.reason, degraded=self.gate.degraded,
                latency_s=self.clock() - t0,
            ))]
        req, shed_reason = self.queue.submit(clean, request_id=request_id, deadline_s=deadline_s)
        out = []
        for shed in self.queue.drain_shed():
            reason = shed_reason if shed is req else "deadline"
            out.append(self._respond(self._shed_response(shed, reason)))
        return out

    def _shed_response(self, req: ServeRequest, reason: str) -> ServeResponse:
        return ServeResponse(
            request_id=req.request_id, outcome=OUTCOME_SHED, reason=reason,
            degraded=self.gate.degraded, latency_s=self.clock() - req.enqueued_at,
        )

    def _reject_batch(self, batch: List[ServeRequest], reason: str) -> List[ServeResponse]:
        return [self._respond(ServeResponse(
            request_id=req.request_id, outcome=OUTCOME_REJECT, reason=reason,
            degraded=self.gate.degraded, latency_s=self.clock() - req.enqueued_at,
        )) for req in batch]

    # ------------------------------------------------------------ processing
    def process_pending(self) -> List[ServeResponse]:
        """Serve one bucket's worth of queued requests (plus typed responses
        for requests shed while queued). Never raises from request content
        or device failure."""
        responses: List[ServeResponse] = []
        batch = self.queue.pop_batch(self.buckets[-1])
        for req in self.queue.drain_shed():
            responses.append(self._respond(self._shed_response(req, "deadline")))
        if not batch:
            return responses
        if not self.breaker.allow():
            return responses + self._reject_batch(batch, REASON_CIRCUIT_OPEN)
        try:
            logits, log_px = self._dispatch(np.stack([r.payload for r in batch]))
        except Exception:
            # the serving boundary keeps running: the batch is answered
            # typed, the breaker counts it, the traceback is kept
            self.last_dispatch_error = traceback.format_exc()
            self.breaker.record_failure()
            _m.counter(_m.DEVICE_ERRORS).inc()
            return responses + self._reject_batch(batch, REASON_DEVICE_ERROR)
        self.breaker.record_success()
        responses.extend(self._gated_responses(batch, logits, log_px))
        return responses

    def serve_all(self, payloads: Sequence[Any], deadline_s: Optional[float] = None,
                  request_ids: Optional[Sequence[str]] = None) -> List[ServeResponse]:
        """Submit everything, drain to completion, return responses in
        submission order; every id gets exactly one response."""
        ids = [request_ids[i] if request_ids is not None else f"req{i}"
               for i in range(len(payloads))]
        order = {rid: i for i, rid in enumerate(ids)}
        responses: List[ServeResponse] = []
        for rid, payload in zip(ids, payloads):
            responses.extend(self.submit(payload, request_id=rid, deadline_s=deadline_s))
        # every pop answers or sheds with an answer, so this terminates
        while len(self.queue):
            responses.extend(self.process_pending())
        return sorted(responses, key=lambda r: order.get(r.request_id, len(order)))

    # ------------------------------------------------------------- internals
    def _dispatch(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Pad to bucket, run the model, slice the padding off."""
        n = images.shape[0]
        bucket = self._bucket_for(n)
        padded = images
        if bucket != n:
            padded = np.zeros((bucket, self.img_size, self.img_size, 3), np.float32)
            padded[:n] = images
        _m.gauge(_m.BATCH_FILL).set(n / bucket)
        _m.histogram(_m.BATCH_FILL_HIST).observe(n / bucket)
        out = self.infer_fn(padded)
        self.dispatch_count += 1
        return (np.asarray(out["logits"], np.float64)[:n],
                np.asarray(out["log_px"], np.float64)[:n])

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _gated_responses(self, batch: List[ServeRequest], logits: np.ndarray,
                         log_px: np.ndarray) -> List[ServeResponse]:
        preds = np.argmax(logits, axis=-1)
        try:
            labels = self.gate.decide(log_px)
            degraded = self.gate.degraded
        except Exception:
            # a failing gate degrades this batch to ungated classification
            labels = [TRUST_UNGATED] * len(batch)
            degraded = True
        out = []
        for req, pred, row, score, label in zip(batch, preds, logits, log_px, labels):
            out.append(self._respond(ServeResponse(
                request_id=req.request_id,
                outcome=OUTCOME_ABSTAIN if label == TRUST_ABSTAIN else OUTCOME_PREDICT,
                prediction=int(pred),
                log_px=float(score),
                trust=label,
                trust_score=self.gate.trust_score(float(score)),
                confidence=self.gate.confidence(row),
                degraded=degraded or label == TRUST_UNGATED,
                latency_s=self.clock() - req.enqueued_at,
            )))
        return out

    def _respond(self, resp: ServeResponse) -> ServeResponse:
        return _record_response(resp)
