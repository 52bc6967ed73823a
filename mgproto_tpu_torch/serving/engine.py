"""ServingEngine: bucketed, trust-gated inference over a frozen model
(counterpart of mgproto_tpu/serving/engine.py, without the AOT cache).

  * Fixed batch-size BUCKETS: a batch is padded to the smallest bucket that
    fits and the padding is sliced off the results; `warmup` runs each
    bucket once before traffic (first-launch costs such as kernel builds and
    cuDNN algorithm selection are paid there) and returns one record per
    bucket. `check_cold_dispatches` counts dispatches at a bucket that was
    not warmed since its last call: the port's meaning of the JAX summary
    line's "steady-state recompiles", which must stay 0.
  * Typed responses, never exceptions: payloads are validated host-side
    into typed rejects; device failures are answered as rejects and feed
    the circuit breaker; overload is shed by the admission queue; `drain`
    answers everything queued with a typed shed.
  * Trust gating: every prediction carries log p(x) and a trust label from
    the calibrated gate; without a valid calibration the engine serves in
    degraded mode, flagged per response.
  * Explanations (opt-in): with an explanation table the infer function is
    the explain forward (engine/eval.py `explain_forward`) and every PREDICT
    response carries its top prototypes (`_ExplainContext.rows`).
  * Tenants (opt-in, `tenants=` a serving/tenants.py TenantDirectory): a
    request carrying a tenant id gates through that tenant's head and pays
    its quota; an unmounted tenant is rejected typed. A head builds nothing
    on the card, so a mount costs no bucket a warmup. With `tenants=None`
    every response is what the single-tenant engine answers.
  * Online capture (online/capture.py): after `record()`, each gated
    response goes to the process-active capture tap, which stages trusted
    high-p(x) predictions for consolidation. Off, the tap costs one
    module-global None-check a batch.
  * Chaos (resilience/chaos.py, the process-active state): malformed and
    NaN payloads and a deadline storm by request index, simulated device
    errors by dispatch index.

`from_live(evaluator)` serves an `engine.eval.Evaluator`;
`from_artifact(path)` an exported artifact (engine/export.py), refusing one
without a calibration unless `allow_uncalibrated` (degraded mode).
"""

from __future__ import annotations

import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mgproto_tpu_torch.obs import reqtrace as _reqtrace
from mgproto_tpu_torch.online import capture as _capture
from mgproto_tpu_torch.resilience import chaos as _chaos
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
    REASON_SHUTDOWN,
    ServeResponse,
    record as _record_response,
    shed_response,
)
from mgproto_tpu_torch.serving.tenants import REASON_TENANT_UNMOUNTED
from mgproto_tpu_torch.serving.validate import ValidationFailure, ValidationSpec, validate_image
from mgproto_tpu_torch.telemetry.monitor import StepMonitor
from mgproto_tpu_torch.telemetry.session import current_session

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8)
DEFAULT_EXPLAIN_TOP = 5


class UncalibratedArtifactError(RuntimeError):
    """The artifact has no calibration and `allow_uncalibrated` is off."""


class _ExplainContext:
    """The static prototype table behind the `explain` response field: per
    flat prototype index its class, within-class k and prior, and the
    nearest training patch when the table carries push provenance."""

    def __init__(self, table: Dict[str, Any]):
        self.k_per_class = int(table["k_per_class"])
        self.priors = np.asarray(table["priors"], np.float64).ravel()
        prov = table.get("provenance") or None
        self._prov = None
        if prov is not None:
            self._prov = {
                "image_id": np.asarray(prov["image_id"], np.int64).ravel(),
                "spatial_idx": np.asarray(prov["spatial_idx"], np.int64).ravel(),
                "log_prob": np.asarray(prov["log_prob"], np.float64).ravel(),
            }

    def rows(self, proto_idx: np.ndarray, proto_logd: np.ndarray) -> List[Dict[str, Any]]:
        """One response's explanation, most activated first."""
        out: List[Dict[str, Any]] = []
        for p, logd in zip(proto_idx, proto_logd):
            p = int(p)
            row: Dict[str, Any] = {
                "prototype": p,
                "class": p // self.k_per_class,
                "k": p % self.k_per_class,
                "prior": float(self.priors[p]),
                "log_density": float(logd),
            }
            if self._prov is not None and self._prov["image_id"][p] >= 0:
                row["source_patch"] = {
                    "image_id": int(self._prov["image_id"][p]),
                    "spatial_idx": int(self._prov["spatial_idx"][p]),
                    "log_prob": float(self._prov["log_prob"][p]),
                }
            out.append(row)
        return out


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
        default_deadline_s: Optional[float] = None,
        breaker: Optional[CircuitBreaker] = None,
        clock: Callable[[], float] = time.monotonic,
        explain_table: Optional[Dict[str, Any]] = None,
        tenants: Optional[Any] = None,
        device: Optional[Any] = None,
        expected_quant: Optional[str] = None,
        monitor: Optional[StepMonitor] = None,
    ):
        """`infer_fn` maps float32 images [b, H, W, 3] to
        {"logits": [b, C], "log_px": [b]} numpy arrays (and, with an
        `explain_table`, "proto_idx" / "proto_logd" [b, E]).
        `default_deadline_s` applies to requests submitted without one.
        `tenants`: a TenantDirectory (module docstring). `device`: the
        torch device `infer_fn` runs on (None when unknown), where the trust
        matrix corrupts its chunks. `expected_quant`: the served weights'
        quant tag ("" unquantized; None makes no claim), matched against
        the calibration's stamp (serving/gate.py). `monitor`: the
        StepMonitor each dispatch is observed by (default: one of phase
        "serve" while a telemetry session is open, in its registry, else
        none); its cold paths are the warmed buckets and the dispatches at
        an unwarmed one."""
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
        self.default_deadline_s = default_deadline_s
        self.gate = TrustGate(
            calibration,
            expected_fingerprint=expected_fingerprint,
            expected_compute_dtype=expected_compute_dtype,
            expected_quant=expected_quant,
        )
        # the served weights' quant identity (perf/quant.py tag; "" unquantized)
        self.quant_config = str(expected_quant or "")
        self.tenants = tenants
        self.device = device
        self.queue = AdmissionQueue(capacity=queue_capacity, clock=clock)
        self.breaker = breaker if breaker is not None else CircuitBreaker(clock=clock)
        self._explain = _ExplainContext(explain_table) if explain_table is not None else None
        self.warmup_report: List[Dict[str, Any]] = []
        self.warmed_up = False
        # readiness veto during a graceful drain or a blue/green flip: the
        # engine still answers what it holds but takes no new routing
        self.draining = False
        self._warmed: set = set()
        self._cold = 0  # dispatches at an unwarmed bucket since the last check
        self._cold_total = 0  # warmed buckets + unwarmed dispatches, ever
        if monitor is None and current_session() is not None:
            monitor = StepMonitor(phase="serve")  # into the session's registry
        self.monitor = monitor
        if monitor is not None:
            monitor.watch(lambda: self._cold_total)
        self.dispatch_count = 0  # device dispatches that returned results
        self.last_dispatch_error: Optional[str] = None  # traceback text
        self._request_seq = 0
        self._dispatch_seq = 0

    # ----------------------------------------------------------- constructors
    @classmethod
    def from_live(cls, evaluator, calibration: Optional[Calibration] = None,
                  explain: bool = False, explain_top: int = DEFAULT_EXPLAIN_TOP,
                  provenance: Optional[Dict[str, Any]] = None, **kw) -> "ServingEngine":
        """Serve an Evaluator. The expected fingerprint is the served GMM's,
        so a calibration measured on another mixture degrades the engine.
        `explain=True` serves the explain forward with the top
        `explain_top` prototypes; `provenance` is a push-provenance dict
        (engine/push.py `provenance_dict`) for the source patches."""
        from mgproto_tpu_torch.engine.export import explain_table, make_explain_fn

        if explain:
            kw["explain_table"] = explain_table(evaluator.gmm, provenance=provenance,
                                                top_e=explain_top)
            infer = make_explain_fn(evaluator, explain_top)
        else:
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
            # a live state serves unrounded f32 weights: a stamped calibration fails closed
            expected_quant="",
            device=evaluator.device,
            **kw,
        )

    @classmethod
    def from_loaded(cls, artifact, allow_uncalibrated: bool = False, explain: bool = False,
                    source: str = "artifact", **kw) -> "ServingEngine":
        """Serve a `engine.export.LoadedArtifact`: engines built this way
        share its model and GMM (replicas hold no copy of the weights). A
        static-batch artifact serves its one batch size as the only
        bucket; `explain=True` needs an artifact exported with --explain."""
        from mgproto_tpu_torch.engine.export import make_explain_fn, quant_tag

        meta = artifact.meta
        if artifact.calibration is None and not allow_uncalibrated:
            raise UncalibratedArtifactError(
                f"{source} carries no calibration.json; re-export with --calibrate, or pass "
                "--allow-uncalibrated to serve classification WITHOUT OoD abstention "
                "(degraded mode)")
        if artifact.static_batch:
            kw["buckets"] = (int(artifact.static_batch),)
        infer = artifact.infer
        if explain:
            table = artifact.explain_table
            if table is None:
                raise ValueError(f"{source} carries no explanation table; re-export with "
                                 "--explain to serve explanations from this artifact")
            kw["explain_table"] = table
            infer = make_explain_fn(artifact.evaluator,
                                    int(table.get("top_e", DEFAULT_EXPLAIN_TOP)),
                                    static_batch=artifact.static_batch)
        policy = meta.get("precision_policy") or {}
        # the artifact's quant identity ("" unquantized): a calibration with
        # another stamp fails closed in the gate; the resident weight bytes
        # of a quantized artifact go on the gauge
        qmeta = meta.get("quant_config") or {}
        if qmeta.get("total_weight_bytes"):
            _m.gauge(_m.QUANT_WEIGHT_BYTES).set(float(qmeta["total_weight_bytes"]))
        return cls(
            infer,
            img_size=int(meta["img_size"]),
            num_classes=int(meta["num_classes"]),
            calibration=artifact.calibration,
            expected_fingerprint=meta.get("gmm_fingerprint"),
            expected_compute_dtype=policy.get("compute_dtype") or meta.get("compute_dtype"),
            expected_quant=quant_tag(meta),
            device=artifact.evaluator.device,
            **kw,
        )

    @classmethod
    def from_artifact(cls, path: str, allow_uncalibrated: bool = False, explain: bool = False,
                      device=None, **kw) -> "ServingEngine":
        """Load the artifact at `path` onto `device` (CUDA unless named) and
        serve it (`from_loaded`)."""
        from mgproto_tpu_torch.engine.export import load_artifact

        return cls.from_loaded(load_artifact(path, device=device),
                               allow_uncalibrated=allow_uncalibrated, explain=explain,
                               source=path, **kw)

    # ----------------------------------------------------------------- warmup
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
            if b not in self._warmed:
                self._cold_total += 1
            self._warmed.add(b)
        self.warmed_up = True
        return self.warmup_report

    def warmup_costs(self) -> Dict[str, Any]:
        """The counted cost of one dispatch at every bucket (obs/opcount.py:
        FLOPs, raw and fused bytes, the kernels' rows): the CPU's
        `--profile_warmup` capture, written by cli/serve.py as the capture's
        cost_analysis.json (the JAX `warmup_costs`, there XLA's cost
        analysis of each bucket's program). Runs each bucket once more:
        call it only when profiling asked for it."""
        from mgproto_tpu_torch.obs.opcount import OpCounter

        with OpCounter() as counter:
            for b in self.buckets:
                counter.phase = f"b{b}"
                self.infer_fn(np.zeros((b, self.img_size, self.img_size, 3), np.float32))
        programs = {}
        for b in self.buckets:
            t = counter.totals(f"b{b}")
            programs[f"b{b}"] = {"flops": t["flops"], "bytes_accessed": t["raw_bytes"],
                                 "fused_bytes": t["fused_bytes"]}
        return {
            "cost_source": "counted",
            "device": None if self.device is None else str(self.device),
            "buckets": [int(b) for b in self.buckets],
            "programs": programs,
            "flops": sum(p["flops"] for p in programs.values()),
            "bytes_accessed": sum(p["bytes_accessed"] for p in programs.values()),
            "kernels": counter.kernel_rows(),
        }

    def check_cold_dispatches(self) -> int:
        """Dispatches at a bucket that was not warmed, since the last call."""
        n, self._cold = self._cold, 0
        return n

    # ------------------------------------------------------------- admission
    def submit(self, payload: Any, request_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               tenant: Optional[str] = None) -> List[ServeResponse]:
        """Validate + admit one request. Returns the immediate typed
        responses (a validation reject, shed responses); empty = queued.
        A `tenant` id gates through that tenant's head and pays its quota;
        a tenant the directory does not hold is rejected typed."""
        t0 = self.clock()
        seq = self._request_seq
        self._request_seq += 1
        chaos = _chaos.get_active()
        if chaos is not None:
            payload = chaos.serve_corrupt_request(seq, payload)
            if chaos.serve_storm_due(seq):
                deadline_s = -1.0  # arrives already past its deadline
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        if deadline_s is not None and deadline_s <= 0:
            _m.counter(_m.SHED).inc(reason="deadline")
            if tenant is not None:
                _m.counter(_m.TENANT_SHED).inc(tenant=tenant, reason="deadline")
            return [self._respond(ServeResponse(
                request_id=request_id or f"v{seq}", outcome=OUTCOME_SHED,
                reason="deadline", degraded=self.gate.degraded, latency_s=0.0, tenant=tenant,
            ))]
        quota = None
        if tenant is not None:
            quota = (self.tenants.quota_for(tenant, self.queue.capacity)
                     if self.tenants is not None else None)
            if quota is None:
                return [self._respond(ServeResponse(
                    request_id=request_id or f"v{seq}", outcome=OUTCOME_REJECT,
                    reason=REASON_TENANT_UNMOUNTED, degraded=self.gate.degraded,
                    latency_s=self.clock() - t0, tenant=tenant,
                ))]
        try:
            clean = validate_image(payload, self.spec)
        except ValidationFailure as e:
            return [self._respond(ServeResponse(
                request_id=request_id or f"v{seq}", outcome=OUTCOME_REJECT,
                reason=e.reason, degraded=self.gate.degraded,
                latency_s=self.clock() - t0, tenant=tenant,
            ))]
        req, shed_reason = self.queue.submit(clean, request_id=request_id, deadline_s=deadline_s,
                                             tenant=tenant, quota=quota)
        if shed_reason is None and _reqtrace.enabled():
            # admission; mints here when nothing upstream did (the one
            # engine's batch face), so every traced face gets its spans
            _reqtrace.on_enqueue(req.request_id, req.enqueued_at)
        out = []
        for shed in self.queue.drain_shed():
            reason = shed_reason if shed is req else "deadline"
            out.append(self._respond(self._shed_response(shed, reason)))
        return out

    def _shed_response(self, req: ServeRequest, reason: str) -> ServeResponse:
        return ServeResponse(
            request_id=req.request_id, outcome=OUTCOME_SHED, reason=reason,
            degraded=self.gate.degraded, latency_s=self.clock() - req.enqueued_at,
            tenant=req.tenant,
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
        t_pop = self.clock()  # the dispatch window when no batcher set a context
        batch = self.queue.pop_batch(self.buckets[-1])
        for req in self.queue.drain_shed():
            responses.append(self._respond(self._shed_response(req, "deadline")))
        if not batch:
            return responses
        if not self.breaker.allow():
            return responses + self._reject_batch(batch, REASON_CIRCUIT_OPEN)
        try:
            logits, log_px, extras = self._dispatch(np.stack([r.payload for r in batch]))
        except Exception:
            # the serving boundary keeps running: the batch is answered
            # typed, the breaker counts it, the traceback is kept
            self.last_dispatch_error = traceback.format_exc()
            self.breaker.record_failure()
            _m.counter(_m.DEVICE_ERRORS).inc()
            return responses + self._reject_batch(batch, REASON_DEVICE_ERROR)
        self.breaker.record_success()
        if _reqtrace.enabled():
            bucket = self._bucket_for(len(batch))
            _reqtrace.on_dispatch([r.request_id for r in batch], bucket=bucket,
                                  fill=len(batch) / bucket, fallback_t0=t_pop)
        responses.extend(self._gated_responses(batch, logits, log_px, extras))
        return responses

    def drain(self, reason: str = REASON_SHUTDOWN) -> List[ServeResponse]:
        """Answer everything still queued with a typed shed, without a
        dispatch (a draining engine may be draining because dispatching
        stopped working); readiness goes false."""
        self.draining = True
        responses = []
        for req in self.queue.drain_all():
            _m.counter(_m.SHED).inc(reason=reason)
            if req.tenant is not None:
                _m.counter(_m.TENANT_SHED).inc(tenant=req.tenant, reason=reason)
            responses.append(self._respond(self._shed_response(req, reason)))
        for req in self.queue.drain_shed():
            responses.append(self._respond(self._shed_response(req, "deadline")))
        return responses

    def serve_all(self, payloads: Sequence[Any], deadline_s: Optional[float] = None,
                  request_ids: Optional[Sequence[str]] = None,
                  should_stop: Optional[Callable[[], bool]] = None,
                  on_pump: Optional[Callable[[], None]] = None) -> List[ServeResponse]:
        """Submit everything, drain to completion, return responses in
        submission order; every id gets exactly one response. `should_stop`
        (the preemption flag) makes the exit graceful: queued work is shed
        typed through `drain()` and the payloads not yet submitted are
        answered with a typed `shutdown` shed. `on_pump` runs between pump
        iterations (the --online consolidation tick)."""
        ids = [request_ids[i] if request_ids is not None else f"req{i}"
               for i in range(len(payloads))]
        order = {rid: i for i, rid in enumerate(ids)}
        responses: List[ServeResponse] = []
        unsubmitted: List[str] = []
        for i, payload in enumerate(payloads):
            if should_stop is not None and should_stop():
                unsubmitted = ids[i:]
                break
            responses.extend(self.submit(payload, request_id=ids[i], deadline_s=deadline_s))
            if on_pump is not None:
                on_pump()
        # every pop answers or sheds with an answer, so this terminates
        while len(self.queue):
            if should_stop is not None and should_stop():
                responses.extend(self.drain())
                break
            responses.extend(self.process_pending())
            if on_pump is not None:
                on_pump()
        responses.extend(shed_response(rid, REASON_SHUTDOWN) for rid in unsubmitted)
        return sorted(responses, key=lambda r: order.get(r.request_id, len(order)))

    # ------------------------------------------------------------- internals
    def _dispatch(self, images: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, Optional[Tuple[np.ndarray, np.ndarray]]]:
        """Pad to bucket, run the model, slice the padding off. The third
        element is None unless explanations are on: then the rows'
        (proto_idx, proto_logd)."""
        n = images.shape[0]
        bucket = self._bucket_for(n)
        seq = self._dispatch_seq
        self._dispatch_seq += 1
        chaos = _chaos.get_active()
        padded = images
        if bucket != n:
            padded = np.zeros((bucket, self.img_size, self.img_size, 3), np.float32)
            padded[:n] = images
        _m.gauge(_m.BATCH_FILL).set(n / bucket)
        _m.histogram(_m.BATCH_FILL_HIST).observe(n / bucket)
        if chaos is not None and chaos.serve_device_error_due(seq):
            raise _chaos.ChaosError(f"chaos: simulated device failure at dispatch {seq}")
        if bucket not in self._warmed:
            self._cold += 1
            self._cold_total += 1
        t0 = time.perf_counter()
        out = self.infer_fn(padded)
        self.dispatch_count += 1
        if self.monitor is not None:
            self.monitor.observe_step(n, time.perf_counter() - t0,
                                      transfer_bytes=int(padded.nbytes))
        extras = None
        if self._explain is not None:
            extras = (np.asarray(out["proto_idx"], np.int64)[:n],
                      np.asarray(out["proto_logd"], np.float64)[:n])
        return (np.asarray(out["logits"], np.float64)[:n],
                np.asarray(out["log_px"], np.float64)[:n], extras)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _gated_responses(self, batch: List[ServeRequest], logits: np.ndarray,
                         log_px: np.ndarray, extras=None) -> List[ServeResponse]:
        preds = np.argmax(logits, axis=-1)
        # a request with a tenant gates through that tenant's head; the
        # batch-level decide below is the single-tenant path
        gates = [self.gate] * len(batch)
        if self.tenants is not None:
            for i, req in enumerate(batch):
                if req.tenant is not None:
                    g = self.tenants.gate_for(req.tenant)
                    if g is not None:
                        gates[i] = g
        if any(g is not self.gate for g in gates):
            labels, degraded_rows = [], []
            for g, score in zip(gates, log_px):
                try:
                    labels.append(g.decide([float(score)])[0])
                    degraded_rows.append(g.degraded)
                except Exception:
                    labels.append(TRUST_UNGATED)
                    degraded_rows.append(True)
        else:
            try:
                labels = self.gate.decide(log_px)
                degraded_rows = [self.gate.degraded] * len(batch)
            except Exception:
                # a failing gate degrades this batch to ungated classification
                labels = [TRUST_UNGATED] * len(batch)
                degraded_rows = [True] * len(batch)
        # the online capture tap: off, one module-global None-check a batch
        tap = _capture.get_active()
        out = []
        for i, (req, pred, row, score, label) in enumerate(
                zip(batch, preds, logits, log_px, labels)):
            outcome = OUTCOME_ABSTAIN if label == TRUST_ABSTAIN else OUTCOME_PREDICT
            explain_rows = None
            if self._explain is not None and outcome == OUTCOME_PREDICT:
                # an abstained request has no served decision to explain
                explain_rows = self._explain.rows(extras[0][i], extras[1][i])
                _m.counter(_m.EXPLANATIONS).inc()
            gate = gates[i]
            resp = self._respond(ServeResponse(
                request_id=req.request_id,
                outcome=outcome,
                prediction=int(pred),
                log_px=float(score),
                trust=label,
                trust_score=gate.trust_score(float(score)),
                confidence=gate.confidence(row),
                degraded=degraded_rows[i] or label == TRUST_UNGATED,
                latency_s=self.clock() - req.enqueued_at,
                explain=explain_rows,
                tenant=req.tenant,
            ))
            if tap is not None:
                # stage a trusted high-p(x) prediction (never raises)
                tap.on_response(req.payload, resp)
            if self.tenants is not None:
                self.tenants.on_response(req.payload, resp)
            out.append(resp)
        return out

    def _respond(self, resp: ServeResponse) -> ServeResponse:
        return _record_response(resp)
