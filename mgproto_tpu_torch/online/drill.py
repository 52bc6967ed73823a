"""The seeded drift drill and the tenant drill on a virtual clock
(counterpart of the online and tenant parts of scripts/load_test.py and of
`drift_drill_gates` in mgproto_tpu/cli/telemetry.py).

A deterministic arrival schedule (phases of DURxRPS) runs through the real
serving plane (ReplicaSet, micro-batchers, engines) on a VIRTUAL clock: a
dispatch advances it by a synthetic service time, nothing sleeps.

Drift drill (`run_storm(online=True)`, `run_drill`): class-conditional
traffic (a seeded per-class texture), a hermetic EM bootstrap (labeled
samples consolidated through the production path until the generative
classifier separates the classes), then from request `drift_at` a shift of
every class's texture (`drift_kind="shift"`) or a brand-new class claiming
a padded slot (`"new_class"`, with operator-labeled feedback). The online
plane runs between pump polls and takes no virtual time: trusted capture,
consolidation on its cadence, the drift monitor, and the drift-triggered
recalibrate + blue/green republish. MGPROTO_CHAOS_ONLINE_POISON_RATE (or
`poison_rate`) replaces requests by low-p(x) mislabeled junk the capture
gate must refuse.

Tenant drill (`run_storm(tenants=N)`): N tenant heads with per-tenant drift
monitors and capture reservoirs on one shared model, round-robin traffic; in
the middle phase the first tenant storms past its quota, part of its lane
(MGPROTO_CHAOS_TENANT_POISON_RATE) is off-manifold junk only its own drift
monitor may see, a new tenant mounts mid-storm, and a tenant-scoped
blue/green pair runs (the storm tenant's swap sabotaged by
MGPROTO_CHAOS_TENANT_BAD_SWAP, a quiet tenant's committed).

The JAX package seeds the model with a PRNGKey the port cannot draw, so the
entry points take an optional initial `state` (a `TrainState` of the tiny
config with the class bucket applied: the tests carry JAX's through
models/convert.py `from_jax_train_state`) and a `device`. Everything else
draws from numpy seeded as the JAX drill draws it.

The record is one dict; `drift_drill_gates` re-derives the drill's verdicts
from its raw numbers.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_PHASES = "2x40,4x40,4x40"


class VirtualClock:
    """Monotonic fake time the whole plane runs on."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def parse_phases(raw: str) -> List[Tuple[float, float]]:
    """"2x40,4x80" -> [(2.0 s, 40 rps), (4.0 s, 80 rps)]."""
    phases = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        dur, _, rps = part.partition("x")
        phases.append((float(dur), float(rps)))
    if not phases:
        raise ValueError(f"no phases in {raw!r}")
    return phases


def _consolidation_block(cons) -> Dict:
    """The consolidation's count of runs and samples, and its shape
    accounting: `compiles` is 1 once a batch ran (the port's one input
    shape), `steady_recompiles` the Consolidator's own count."""
    return {
        "runs": cons.runs,
        "samples": cons.samples_consolidated,
        "compiles": int(cons.batches > 0),
        "steady_recompiles": cons.steady_recompiles(),
    }


def _gauge_value(snapshot: Dict, name: str):
    """Latest unlabeled-series value of a gauge (None when absent)."""
    for s in snapshot.get(name, {}).get("series", []):
        if not s.get("labels"):
            return s.get("value")
    return None


def _label_counts(snapshot: Dict, name: str, key: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in snapshot.get(name, {}).get("series", []):
        label = s.get("labels", {}).get(key)
        if label is not None and s.get("value"):
            out[label] = out.get(label, 0.0) + s["value"]
    return out


def _tenant_label_counts(snapshot: Dict, name: str, inner_key: str) -> Dict[str, Dict[str, float]]:
    """{tenant: {inner_label: count}} for a tenant-labeled counter."""
    out: Dict[str, Dict[str, float]] = {}
    for s in snapshot.get(name, {}).get("series", []):
        labels = s.get("labels", {})
        t, k = labels.get("tenant"), labels.get(inner_key)
        if t is not None and k is not None and s.get("value"):
            row = out.setdefault(t, {})
            row[k] = row.get(k, 0.0) + s["value"]
    return out


def _pcts(latencies_ms: Sequence[float]) -> Dict[str, Optional[float]]:
    if not latencies_ms:
        return {"p50_ms": None, "p99_ms": None, "max_ms": None}
    arr = np.asarray(latencies_ms, np.float64)
    return {
        "p50_ms": round(float(np.percentile(arr, 50)), 3),
        "p99_ms": round(float(np.percentile(arr, 99)), 3),
        "max_ms": round(float(arr.max()), 3),
    }


def _calibrate(evaluator, batches):
    """The port's calibration over (images, labels) batches."""
    from mgproto_tpu_torch.serving.calibration import calibrate

    return calibrate(evaluator, [images for images, _ in batches])


class OnlinePlane:
    """The drift drill's continual-learning side-plane: the seeded
    class-conditional traffic generator, the hermetic EM bootstrap, the
    capture tap, the consolidation cadence, the drift monitor and the
    drift-triggered recalibrate + blue/green republish. Deterministic."""

    def __init__(self, trainer, state, clock, seed: int, base_classes: int, drift_kind: str,
                 drift_magnitude: float, capture_percentile: float, capture_capacity: int,
                 online_cadence_s: float, republish_min_interval_s: float,
                 px_divergence_threshold: float, mean_shift_threshold: float,
                 engine_kw: Dict, bootstrap_epochs: int = 20, bootstrap_per_class: int = 8,
                 new_class_rate: float = 0.35, new_class_label_rate: float = 0.5):
        from mgproto_tpu_torch.engine.eval import Evaluator
        from mgproto_tpu_torch.online import classes as ocl
        from mgproto_tpu_torch.online.capture import CaptureConfig, CapturedSample, TrustedCapture
        from mgproto_tpu_torch.online.consolidate import Consolidator, ConsolidatorConfig
        from mgproto_tpu_torch.online.drift import DriftConfig, DriftMonitor

        self.trainer = trainer
        self.clock = clock
        self.drift_kind = drift_kind
        self.drift_magnitude = float(drift_magnitude)
        self.base_classes = int(base_classes)
        self.img = trainer.cfg.model.img_size
        self.engine_kw = engine_kw
        self.new_class_rate = new_class_rate
        self.new_class_label_rate = new_class_label_rate
        self._gen_rng = np.random.RandomState(seed + 11)
        self._traffic_rng = np.random.RandomState(seed + 13)
        self._poison_rng = np.random.RandomState(seed + 17)
        self._evaluator_cls = Evaluator
        self.directory = ocl.ClassDirectory(base_classes, trainer.cfg.model.num_classes)
        self.new_slot: Optional[int] = None
        # padded slots inert until claimed (zero priors = -inf logits)
        state = dataclasses.replace(state, gmm=ocl.floor_padded_priors(state.gmm, base_classes))
        # hermetic bootstrap: labeled samples through the production
        # consolidation path until the classifier separates the classes
        self.cons = Consolidator(
            trainer, state,
            config=ConsolidatorConfig(cadence_s=online_cadence_s, batch_width=8),
            clock=clock,
        )
        for _ in range(int(bootstrap_epochs)):
            for c in range(base_classes):
                self.cons.ingest([CapturedSample(p, c, None, "bootstrap", True)
                                  for p in self._samples(c, bootstrap_per_class)])
        self.base_state = self.cons.candidate_state(state)
        self.id_batch_size = 4
        self.id_batches = [
            (np.stack(self._samples(c, self.id_batch_size)),
             np.full((self.id_batch_size,), c, np.int32))
            for c in range(base_classes) for _ in range(2)
        ]
        self._serving_ev = self._evaluator(self.base_state)
        self.calib = _calibrate(self._serving_ev, self.id_batches)
        self.serving_state = self.base_state
        self.capture = TrustedCapture(
            self.calib, trainer.cfg.model.num_classes,
            CaptureConfig(percentile=capture_percentile, capacity_per_class=capture_capacity,
                          seed=seed),
        )
        self.cons.capture = self.capture
        self.drift = DriftMonitor(
            self.calib,
            DriftConfig(px_window=128, min_px_samples=48, eval_interval_s=online_cadence_s,
                        px_divergence_threshold=px_divergence_threshold,
                        mean_shift_threshold=mean_shift_threshold),
            clock=clock,
        )
        self.drift.set_bank_baseline(*self.cons.bank_arrays())
        self.republish_min_interval_s = republish_min_interval_s
        self.republisher = None  # bound once the ReplicaSet exists
        self._pending_candidate = None
        self.first_breach: Optional[Dict] = None
        self.drift_active = False
        self.drift_started_t: Optional[float] = None
        self.poisoned: set = set()
        self.truth: Dict[str, int] = {}
        self.drifted: Dict[str, bool] = {}
        self.labeled_feedback = 0
        self.replica_set = None
        # recent raw traffic for THRESHOLD recalibration, deliberately
        # ungated: a capture-gated sample never shows the sub-gate tail, so
        # thresholds re-derived from it would sit too high; the gate's job
        # is protecting the banks, which only ever see gated or labeled
        # samples
        self.recent_traffic = deque(maxlen=128)

    def _evaluator(self, state, own_model: bool = False):
        """An Evaluator of `state`'s trunk and GMM; `own_model` serves a
        copy of the trunk (a republished candidate shares nothing with the
        serving model)."""
        model = copy.deepcopy(state.model) if own_model else state.model
        return self._evaluator_cls(model, state.gmm, self.trainer.cfg, device=self.trainer.device)

    # ----------------------------------------------------------- traffic gen
    def _pattern(self, cls: int, drift: float, channel: float = 1.0) -> np.ndarray:
        """A class's texture: an oriented wave and a channel balance;
        `drift` rotates the wave and moves the balance, `channel` -2.0 is
        the off-manifold poison direction."""
        n = self.img
        xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        ang = (cls * 45.0 + drift * 30.0) * np.pi / 180.0
        wave = np.cos(2.0 * np.pi * (cls + 1) * (xx * np.cos(ang) + yy * np.sin(ang)) / float(n))
        base = np.repeat(wave[..., None].astype(np.float32), 3, axis=2)
        base[..., cls % 3] += channel
        base[..., (cls + 1) % 3] += drift * 0.6
        return base

    def _samples(self, cls: int, count: int, drift: float = 0.0) -> list:
        base = self._pattern(cls, drift)
        return [base + self._gen_rng.randn(self.img, self.img, 3).astype(np.float32) * 0.05
                for _ in range(count)]

    def start_drift(self, now: float) -> None:
        self.drift_active = True
        self.drift_started_t = now
        if self.drift_kind == "new_class" and self.new_slot is None:
            self.new_slot = self.directory.add_class("drill_new_class")
            self.cons.claim_class(self.new_slot)

    def next_payload(self, rid: str, poisoned: bool) -> np.ndarray:
        """One request's payload and its truth bookkeeping."""
        if poisoned:
            # low-p(x) mislabeled junk far off the manifold
            self.poisoned.add(rid)
            self.truth[rid] = int(self._traffic_rng.randint(0, self.base_classes))
            self.drifted[rid] = self.drift_active
            src = int(self._poison_rng.randint(0, self.base_classes))
            payload = (self._pattern(src, drift=0.0, channel=-2.0)
                       + self._poison_rng.randn(self.img, self.img, 3).astype(np.float32) * 0.05)
            self.recent_traffic.append(payload)
            return payload
        cls = int(self._traffic_rng.randint(0, self.base_classes))
        drift = 0.0
        if self.drift_active:
            if (self.drift_kind == "new_class" and self.new_slot is not None
                    and self._traffic_rng.rand() < self.new_class_rate):
                cls = self.new_slot
            elif self.drift_kind == "shift":
                drift = self.drift_magnitude
        self.truth[rid] = cls
        self.drifted[rid] = self.drift_active
        payload = (self._pattern(cls, drift)
                   + self._gen_rng.randn(self.img, self.img, 3).astype(np.float32) * 0.05)
        if cls == self.new_slot and self._traffic_rng.rand() < self.new_class_label_rate:
            # operator-labeled feedback: the only way a class the serving
            # mixture cannot score yet gets trusted samples staged
            self.capture.submit_labeled(payload, cls, request_id=rid)
            self.labeled_feedback += 1
        self.recent_traffic.append(payload)
        return payload

    # -------------------------------------------------------------- republish
    def bind_replica_set(self, replica_set) -> None:
        from mgproto_tpu_torch.online.republish import Republisher

        self.replica_set = replica_set
        self.republisher = Republisher(
            replica_set, recalibrate=self._recalibrate, factory_builder=self._factory_builder,
            clock=self.clock, min_interval_s=self.republish_min_interval_s,
            on_commit=self._on_commit,
        )

    def factory(self):
        """The initial engine factory (a hot swap retargets the set's)."""
        from mgproto_tpu_torch.serving.engine import ServingEngine

        return ServingEngine.from_live(self._serving_ev, calibration=self.calib, **self.engine_kw)

    def _recalibrate(self):
        cand = self.cons.candidate_state(self.base_state)
        ev = self._evaluator(cand, own_model=True)
        # thresholds from the recent live traffic rescored under the
        # candidate; the capture holdout and the bootstrap set are the
        # fallbacks of a cold start
        traffic = list(self.recent_traffic)
        bs = self.id_batch_size
        batches = [(np.stack(traffic[j:j + bs]), np.zeros((bs,), np.int32))
                   for j in range(0, len(traffic) - bs + 1, bs)]
        if not batches:
            batches = self.capture.recal_batches(bs) or self.id_batches
        calib = _calibrate(ev, batches)
        self._pending_candidate = (cand, ev)
        return calib

    def _factory_builder(self, calibration):
        from mgproto_tpu_torch.serving.engine import ServingEngine

        _, ev = self._pending_candidate

        def factory():
            return ServingEngine.from_live(ev, calibration=calibration, **self.engine_kw)

        return factory

    def _on_commit(self, calibration) -> None:
        cand, _ = self._pending_candidate
        self.serving_state = cand
        self.calib = calibration
        self.capture.retarget(calibration)
        self.drift.rebase(calibration, *self.cons.bank_arrays())

    # ------------------------------------------------------------------ ticks
    def observe_responses(self, responses) -> None:
        for r in responses:
            if r.outcome in ("predict", "abstain") and r.log_px is not None:
                self.drift.observe_px(r.log_px)

    def tick(self, now: float) -> None:
        """One poll beside the pump: consolidate on cadence, refresh drift,
        republish on a breach. Takes no virtual time."""
        report = self.cons.tick(now)
        if report is not None and report.result == "ran":
            self.drift.observe_bank(*self.cons.bank_arrays())
        d = self.drift.evaluate(now)
        if d is not None and d.breached and self.first_breach is None:
            self.first_breach = d.to_dict()
        if d is not None and self.republisher is not None:
            self.republisher.maybe_republish(d, now=now)

    # ---------------------------------------------------------------- result
    def accuracy_windows(self, responses, index_of: Dict[str, int], window: int) -> list:
        """Served-accuracy / abstain / p(x) curves over request-index
        windows. An answer is correct only as a trusted (in_dist)
        prediction of the true class; poisoned requests are excluded."""
        rows: Dict[int, Dict] = {}
        for r in responses:
            i = index_of.get(r.request_id)
            if i is None or r.request_id in self.poisoned:
                continue
            if r.outcome not in ("predict", "abstain"):
                continue
            w = i // window
            row = rows.setdefault(w, {
                "window": w, "first_request": w * window, "answered": 0, "predict": 0,
                "abstain": 0, "raw_correct": 0, "served_correct": 0, "log_px_sum": 0.0,
                "drifted": 0,
            })
            truth = self.truth.get(r.request_id)
            row["answered"] += 1
            row["drifted"] += bool(self.drifted.get(r.request_id))
            if r.log_px is not None:
                row["log_px_sum"] += r.log_px
            if r.outcome == "predict":
                row["predict"] += 1
            else:
                row["abstain"] += 1
            if r.prediction is not None and truth is not None and int(r.prediction) == truth:
                row["raw_correct"] += 1
                if r.outcome == "predict" and r.trust == "in_dist":
                    row["served_correct"] += 1
        out = []
        for w in sorted(rows):
            row = rows[w]
            n = row["answered"]
            out.append({
                "window": row["window"],
                "first_request": row["first_request"],
                "answered": n,
                "abstain_rate": round(row["abstain"] / n, 4) if n else None,
                "raw_accuracy": round(row["raw_correct"] / n, 4) if n else None,
                "served_accuracy": round(row["served_correct"] / n, 4) if n else None,
                "mean_log_px": round(row["log_px_sum"] / n, 4) if n else None,
                "drifted_fraction": round(row["drifted"] / n, 4) if n else None,
            })
        return out


def drill_config(class_bucket: int = 8):
    """The drill's model: the tiny config with the class axis padded to
    `class_bucket` and a drill-scale EM mean step (the JAX drill's)."""
    from mgproto_tpu_torch.config import tiny_test_config
    from mgproto_tpu_torch.online.classes import apply_class_bucket

    cfg = tiny_test_config()
    return apply_class_bucket(cfg.replace(
        model=dataclasses.replace(cfg.model, class_bucket=class_bucket),
        em=dataclasses.replace(cfg.em, mean_lr=0.05),
    ))


def run_storm(
    seed: int = 0,
    phases: Sequence[Tuple[float, float]] = ((2.0, 60.0), (2.0, 300.0), (2.0, 60.0)),
    replicas: int = 2,
    buckets: Sequence[int] = (1, 2, 4, 8),
    deadline_ms: float = 100.0,
    queue_capacity: int = 32,
    service_ms: float = 4.0,
    linger_ms: float = 30.0,
    heartbeat_timeout_s: float = 0.3,
    drift_at: Optional[int] = None,
    drift_kind: str = "shift",
    drift_magnitude: float = 0.35,
    online: bool = False,
    online_cadence_s: float = 0.5,
    capture_percentile: float = 25.0,
    capture_capacity: int = 48,
    republish_min_interval_s: float = 2.0,
    px_divergence_threshold: float = 0.25,
    mean_shift_threshold: float = 0.0,
    poison_rate: Optional[float] = None,
    class_bucket: int = 8,
    accuracy_window: int = 40,
    tenants: Optional[int] = None,
    tenant_storm_at: Optional[int] = None,
    tenant_storm_burst: int = 24,
    tenant_mount_at: Optional[int] = None,
    tenant_swap_at: Optional[int] = None,
    tenant_poison_rate: Optional[float] = None,
    state=None,
    device=None,
) -> Dict:
    """Drive the storm (the JAX `run_load_test`'s online and tenant modes);
    returns the record. `state`: the initial TrainState (the tiny config,
    the class bucket applied in online mode); None draws one from `seed`.
    `device`: CUDA unless named."""
    from mgproto_tpu_torch.config import tiny_test_config
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.online import capture as capture_mod
    from mgproto_tpu_torch.online.metrics import register_online_metrics
    from mgproto_tpu_torch.resilience import chaos as chaos_mod
    from mgproto_tpu_torch.serving import metrics as sm
    from mgproto_tpu_torch.serving.batcher import BatcherConfig
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.serving.replica import ReplicaSet
    from mgproto_tpu_torch.trust.metrics import register_trust_metrics

    online_mode = online or drift_at is not None
    tenant_mode = tenants is not None
    if tenant_mode:
        if int(tenants) < 2:
            raise ValueError(f"tenants needs N >= 2 (isolation is a two-party property), "
                             f"got {tenants}")
        if online_mode:
            raise ValueError("tenants does not combine with online/drift_at (one drill at a "
                             "time)")
    if poison_rate is None:
        poison_rate = float(os.environ.get("MGPROTO_CHAOS_ONLINE_POISON_RATE") or 0.0)
    # tenant drill geometry: the storm is the middle phase, so every tenant
    # has a calm before and after; mount and swap land inside the storm
    phase_counts = [max(int(round(d * r)), 1) for d, r in phases]
    tenant_bad_swaps = 0
    storm_end = 0
    if tenant_mode:
        storm_phase = min(1, len(phases) - 1)
        storm_start = sum(phase_counts[:storm_phase])
        storm_end = sum(phase_counts[:storm_phase + 1])
        if tenant_storm_at is None:
            env = os.environ.get("MGPROTO_CHAOS_TENANT_STORM_AT")
            tenant_storm_at = int(env) if env else storm_start
        if tenant_poison_rate is None:
            env = os.environ.get("MGPROTO_CHAOS_TENANT_POISON_RATE")
            tenant_poison_rate = float(env) if env else 0.5
        if tenant_mount_at is None:
            tenant_mount_at = (tenant_storm_at + storm_end) // 2
        if tenant_swap_at is None:
            tenant_swap_at = tenant_storm_at + ((storm_end - tenant_storm_at) * 3 // 4)
        tenant_bad_swaps = int(os.environ.get("MGPROTO_CHAOS_TENANT_BAD_SWAP") or 1)
    registry = sm.MetricRegistry()
    prev_registry = sm.set_current_registry(registry)
    sm.register_serving_metrics(registry)
    if online_mode or tenant_mode:
        register_online_metrics(registry)
        register_trust_metrics(registry)
    plan = chaos_mod.ChaosPlan(
        seed=seed,
        online_poison_rate=poison_rate if online_mode else 0.0,
        tenant_storm_at=tenant_storm_at if tenant_mode else None,
        tenant_bad_swap=tenant_bad_swaps,
        tenant_poison_rate=float(tenant_poison_rate) if tenant_mode else 0.0,
    )
    prev_chaos = chaos_mod.set_active(chaos_mod.ChaosState(plan) if plan.any_active() else None)
    prev_capture = capture_mod.get_active()
    try:
        clock = VirtualClock()
        service_s = service_ms / 1000.0
        engine_kw = dict(buckets=tuple(buckets), clock=clock, queue_capacity=queue_capacity,
                         default_deadline_s=deadline_ms / 1000.0)
        plane: Optional[OnlinePlane] = None
        if online_mode:
            base_classes = tiny_test_config().model.num_classes
            cfg = drill_config(class_bucket)
            trainer = Trainer(cfg, steps_per_epoch=1, device=device)
            state = trainer.init_state(seed) if state is None else state
            plane = OnlinePlane(
                trainer, state, clock, seed=seed, base_classes=base_classes,
                drift_kind=drift_kind, drift_magnitude=drift_magnitude,
                capture_percentile=capture_percentile, capture_capacity=capture_capacity,
                online_cadence_s=online_cadence_s,
                republish_min_interval_s=republish_min_interval_s,
                px_divergence_threshold=px_divergence_threshold,
                mean_shift_threshold=mean_shift_threshold, engine_kw=engine_kw,
            )
            capture_mod.install(plane.capture)
        else:
            cfg = tiny_test_config()
            trainer = Trainer(cfg, steps_per_epoch=1, device=device)
            state = trainer.init_state(seed) if state is None else state
            ev = Evaluator(state.model, state.gmm, cfg, device=trainer.device)
            rng = np.random.RandomState(seed)
            id_batches = [
                (rng.rand(4, cfg.model.img_size, cfg.model.img_size, 3).astype(np.float32),
                 rng.randint(0, cfg.model.num_classes, (4,)).astype(np.int32))
                for _ in range(2)
            ]
            calib = _calibrate(ev, id_batches)

        directory = None
        tenant_names: List[str] = []
        storm_tenant: Optional[str] = None
        mount_calib = None
        tenant_drift_cfg = None
        tenant_capture_cfg = None
        tenant_mounts: List[Dict] = []
        if tenant_mode:
            from mgproto_tpu_torch.online.capture import CaptureConfig
            from mgproto_tpu_torch.online.drift import DriftConfig
            from mgproto_tpu_torch.serving.tenants import TenantDirectory

            directory = TenantDirectory(clock=clock)
            # the threshold sits between the quiet tenants' divergence under
            # storm-cadence dispatch and the poisoned tenant's
            tenant_drift_cfg = DriftConfig(px_window=96, min_px_samples=32, eval_interval_s=0.25,
                                           px_divergence_threshold=0.45,
                                           mean_shift_threshold=0.0)
            tenant_capture_cfg = CaptureConfig(percentile=capture_percentile,
                                               capacity_per_class=capture_capacity, seed=seed)

            # the heads calibrate on a larger ID sample than the engine: an
            # 8-sample sketch is noisy enough to false-breach a quiet tenant
            def _tenant_batches(rng_x):
                return [
                    (rng_x.rand(4, cfg.model.img_size, cfg.model.img_size, 3).astype(np.float32),
                     rng_x.randint(0, cfg.model.num_classes, (4,)).astype(np.int32))
                    for _ in range(8)
                ]

            tenant_calib = _calibrate(ev, _tenant_batches(np.random.RandomState(seed + 3)))
            # a second calibration: the different head the mid-storm mount
            # and the blue/green pair ship
            mount_calib = _calibrate(ev, _tenant_batches(np.random.RandomState(seed + 2)))
            for t in range(int(tenants)):
                rep_m = directory.mount(f"t{t}", tenant_calib, drift_config=tenant_drift_cfg,
                                        capture_config=tenant_capture_cfg,
                                        num_classes=cfg.model.num_classes)
                tenant_mounts.append({**rep_m.to_dict(), "during_storm": False,
                                      "trunk_compiles_delta": 0})
            tenant_names = list(directory.tenants())
            storm_tenant = tenant_names[0]

        if plane is not None:
            factory = plane.factory
        else:
            def factory():
                return ServingEngine.from_live(ev, calibration=calib, tenants=directory,
                                               **engine_kw)

        # the synthetic device: every dispatch takes service_ms of virtual
        # time before its responses are stamped
        rs = ReplicaSet(factory, replicas=replicas, clock=clock,
                        heartbeat_timeout_s=heartbeat_timeout_s,
                        batcher_config=BatcherConfig(cost_prior_s=service_s,
                                                     max_linger_s=linger_ms / 1000.0),
                        pre_dispatch=lambda: clock.advance(service_s))
        warmup_compiles = rs.start()
        if plane is not None:
            plane.bind_replica_set(rs)

        responses = []
        submitted: List[str] = []
        phase_of: Dict[str, int] = {}
        index_of: Dict[str, int] = {}
        payload_rng = np.random.RandomState(seed + 1)
        img = cfg.model.img_size
        poison_injected = 0
        chaos = chaos_mod.get_active()
        drift_injected_t: Optional[float] = None
        tenant_of: Dict[str, str] = {}
        tenant_submitted: Dict[str, int] = {}
        tenant_swap_reports: List[Dict] = []
        tenant_poison_injected = 0
        tenant_storm_extras = 0
        poison_seq = 0
        i = 0
        for phase_idx, (duration_s, rps) in enumerate(phases):
            n = max(int(round(duration_s * rps)), 1)
            spacing = 1.0 / rps
            for _ in range(n):
                storm_now = (tenant_mode and chaos is not None and i < storm_end
                             and chaos.tenant_storm_due(i))
                if tenant_mode and i == tenant_mount_at:
                    # a new tenant mounts mid-storm: head bytes only, the
                    # engines' buckets and cold-dispatch count untouched
                    pre_compiles = rs.steady_recompiles
                    new_name = f"t{len(tenant_names)}"
                    rep_m = directory.mount(new_name, mount_calib, drift_config=tenant_drift_cfg,
                                            capture_config=tenant_capture_cfg,
                                            num_classes=cfg.model.num_classes)
                    responses.extend(rs.poll())
                    tenant_mounts.append({**rep_m.to_dict(), "during_storm": bool(storm_now),
                                          "trunk_compiles_delta":
                                              rs.steady_recompiles - pre_compiles})
                    tenant_names.append(new_name)
                if tenant_mode and i == tenant_swap_at:
                    # the tenant-scoped blue/green pair: the storm tenant's
                    # (sabotaged by chaos) first, then a quiet tenant's
                    quiet = next(t for t in tenant_names if t != storm_tenant)
                    tenant_swap_reports.append(directory.swap(storm_tenant, mount_calib).to_dict())
                    tenant_swap_reports.append(directory.swap(quiet, mount_calib).to_dict())
                rid = f"q{i}"
                arrivals: List[Tuple[str, Optional[str]]] = [(rid, None)]
                if tenant_mode:
                    arrivals = [(rid, tenant_names[i % len(tenant_names)])]
                    if storm_now:
                        # extra storm-tenant requests a tick, far past its
                        # quota: its own tail sheds, nobody else's
                        for j in range(int(tenant_storm_burst)):
                            arrivals.append((f"q{i}x{j}", storm_tenant))
                            tenant_storm_extras += 1
                before = len(responses)
                for arid, tenant in arrivals:
                    submitted.append(arid)
                    phase_of[arid] = phase_idx
                    index_of[arid] = i
                    if plane is not None:
                        if drift_at is not None and i == drift_at:
                            plane.start_drift(clock())
                            drift_injected_t = clock()
                        poisoned = chaos is not None and chaos.online_poison_due(i)
                        poison_injected += poisoned
                        payload = plane.next_payload(arid, poisoned)
                    else:
                        payload = payload_rng.rand(img, img, 3).astype(np.float32)
                    if tenant is not None:
                        tenant_of[arid] = tenant
                        tenant_submitted[tenant] = tenant_submitted.get(tenant, 0) + 1
                        if (storm_now and tenant == storm_tenant
                                and chaos.tenant_poison_due(poison_seq)):
                            # off-manifold junk inside the storm tenant's lane
                            tenant_poison_injected += 1
                            payload = (payload * 6.0 - 3.0).astype(np.float32)
                        poison_seq += int(tenant == storm_tenant)
                    responses.extend(rs.submit(payload, request_id=arid, tenant=tenant))
                responses.extend(rs.poll())
                if plane is not None:
                    # the online plane runs between pump polls and takes no
                    # virtual time
                    plane.observe_responses(responses[before:])
                    plane.tick(clock())
                clock.advance(spacing)
                i += 1
        # drain: pump virtual time until every request is answered
        answered = {r.request_id for r in responses}
        drain_dt = max(linger_ms, service_ms) / 1000.0
        for _ in range(10_000):
            if len(answered) >= len(submitted):
                break
            before = len(responses)
            responses.extend(rs.poll())
            if plane is not None:
                plane.observe_responses(responses[before:])
                plane.tick(clock())
            answered = {r.request_id for r in responses}
            clock.advance(drain_dt)
        responses.extend(rs.drain())
        answered = {r.request_id for r in responses}

        # ----------------------------------------------------------- analysis
        snapshot = registry.snapshot()
        by_outcome: Dict[str, int] = {}
        for r in responses:
            by_outcome[r.outcome] = by_outcome.get(r.outcome, 0) + 1
        served_lat = [r.latency_s * 1000.0 for r in responses
                      if r.outcome in ("predict", "abstain")]
        phase_rows = []
        for phase_idx, (duration_s, rps) in enumerate(phases):
            rows = [r for r in responses if phase_of.get(r.request_id) == phase_idx]
            lat = [r.latency_s * 1000.0 for r in rows if r.outcome in ("predict", "abstain")]
            shed = sum(r.outcome == "shed" for r in rows)
            outcomes: Dict[str, int] = {}
            for r in rows:
                outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1
            phase_rows.append({
                "duration_s": duration_s, "rps": rps, "requests": len(rows),
                "outcomes": outcomes, "shed_rate": round(shed / len(rows), 4) if rows else None,
                **_pcts(lat),
            })
        result: Dict[str, Any] = {
            "load_test": True,
            "seed": seed,
            "virtual_clock": True,
            "config": {
                "phases": [list(p) for p in phases], "replicas": replicas,
                "buckets": list(buckets), "deadline_ms": deadline_ms,
                "queue_capacity": queue_capacity, "service_ms": service_ms,
                "linger_ms": linger_ms, "heartbeat_timeout_s": heartbeat_timeout_s,
            },
            "phases": phase_rows,
            "overall": {
                "submitted": len(submitted),
                "answered": len(answered & set(submitted)),
                "responses": len(responses),
                "zero_dropped": answered >= set(submitted)
                and len(responses) == len(set(submitted)),
                "outcomes": by_outcome,
                "shed_by_reason": _label_counts(snapshot, sm.SHED, "reason"),
                **_pcts(served_lat),
            },
            "dispatch_triggers": _label_counts(snapshot, sm.DISPATCHES, "trigger"),
            "swaps_by_result": _label_counts(snapshot, sm.SWAPS, "result"),
            "warmup_compiles": warmup_compiles,
            "steady_state_recompiles": rs.steady_recompiles,
            "virtual_duration_s": round(clock(), 3),
        }
        if plane is not None:
            # poisoned requests that were ever STAGED: must be zero (the
            # capture's own record of accepted ids is the ground truth)
            poison_eligible = sum(1 for rid in plane.poisoned
                                  if plane.capture.was_captured(rid))
            republishes = ([rec.to_dict() for rec in plane.republisher.records]
                           if plane.republisher is not None else [])
            commits = [rec for rec in republishes if rec["result"] == "committed"]
            first_commit_t = commits[0]["t"] if commits else None
            detected_before = bool(plane.first_breach is not None
                                   and (first_commit_t is None
                                        or plane.first_breach["t"] <= first_commit_t))
            result["online"] = {
                "drift_at": drift_at,
                "drift_kind": drift_kind,
                "drift_magnitude": drift_magnitude,
                "drift_injected_t": drift_injected_t,
                "class_bucket": class_bucket,
                "base_classes": plane.base_classes,
                "padded_classes": plane.directory.padded_classes,
                "new_class_slot": plane.new_slot,
                "labeled_feedback": plane.labeled_feedback,
                "capture": plane.capture.stats(),
                "capture_by_outcome": _label_counts(snapshot, sm.CAPTURED, "outcome"),
                "poison": {"rate": poison_rate, "injected": poison_injected,
                           "capture_eligible": poison_eligible},
                "consolidation": _consolidation_block(plane.cons),
                "detection": {"first_breach": plane.first_breach,
                              "first_commit_t": first_commit_t,
                              "detected_before_correction": detected_before},
                "drift_gauges": {
                    "px_divergence": _gauge_value(snapshot, sm.DRIFT_PX_DIVERGENCE),
                    "mean_shift_max": _gauge_value(snapshot, sm.DRIFT_SHIFT_MAX),
                    "breaches_by_signal": _label_counts(snapshot, sm.DRIFT_BREACHES, "signal"),
                },
                "republishes": republishes,
                "republish_by_result": _label_counts(snapshot, sm.REPUBLISH, "result"),
                "accuracy_windows": plane.accuracy_windows(responses, index_of, accuracy_window),
            }
        if tenant_mode:
            lat_by_tenant: Dict[str, Dict[str, List[float]]] = {}
            outcomes_by_tenant: Dict[str, Dict[str, int]] = {}
            for r in responses:
                t = tenant_of.get(r.request_id)
                if t is None:
                    continue
                row = outcomes_by_tenant.setdefault(t, {})
                row[r.outcome] = row.get(r.outcome, 0) + 1
                if r.outcome in ("predict", "abstain"):
                    idx = index_of.get(r.request_id, 0)
                    window = "storm" if tenant_storm_at <= idx < storm_end else "calm"
                    lat_by_tenant.setdefault(t, {"calm": [], "storm": []})[window].append(
                        r.latency_s * 1000.0)
            shed_by_tenant = _tenant_label_counts(snapshot, sm.TENANT_SHED, "reason")
            per_tenant: Dict[str, Dict] = {}
            for t in directory.tenants():
                head = directory.head_for(t)
                lat = lat_by_tenant.get(t, {"calm": [], "storm": []})
                per_tenant[t] = {
                    "submitted": tenant_submitted.get(t, 0),
                    "outcomes": outcomes_by_tenant.get(t, {}),
                    "shed_by_reason": shed_by_tenant.get(t, {}),
                    "quota": directory.quota_for(t, queue_capacity),
                    "head_fingerprint": head.head_fingerprint,
                    "head_bytes": head.head_bytes,
                    "drift_breaches": head.drift.breaches if head.drift else 0,
                    "capture": head.capture.stats() if head.capture else None,
                    "calm": _pcts(lat["calm"]),
                    "storm": _pcts(lat["storm"]),
                }
            result["tenants"] = {
                "count": len(directory),
                "initial": int(tenants),
                "storm_tenant": storm_tenant,
                "storm_at": tenant_storm_at,
                "storm_end": storm_end,
                "storm_burst": int(tenant_storm_burst),
                "storm_extras": tenant_storm_extras,
                "mount_at": tenant_mount_at,
                "swap_at": tenant_swap_at,
                "bad_swap": tenant_bad_swaps,
                "poison_rate": tenant_poison_rate,
                "poison_injected": tenant_poison_injected,
                "per_tenant": per_tenant,
                "mounts": tenant_mounts,
                "swaps": tenant_swap_reports,
            }
        return result
    finally:
        capture_mod.install(prev_capture)
        chaos_mod.set_active(prev_chaos)
        sm.set_current_registry(prev_registry)


def run_drill(seed: int = 0, drift_kind: str = "shift", drift_at: int = 120,
              drift_magnitude: float = 0.25, phases: str = DEFAULT_PHASES,
              capture_percentile: float = 10.0, poison_rate: Optional[float] = None,
              class_bucket: int = 8, accuracy_window: int = 40, state=None,
              device=None) -> Dict:
    """The drift drill as a record (the JAX `cli/online.py::run_drill`),
    with its gates stored under "gates" (re-derived, never trusted, by
    `drift_drill_gates`)."""
    result = run_storm(
        seed=seed, phases=parse_phases(phases), online=True, drift_at=drift_at,
        drift_kind=drift_kind, drift_magnitude=drift_magnitude,
        capture_percentile=capture_percentile, poison_rate=poison_rate,
        class_bucket=class_bucket, accuracy_window=accuracy_window, state=state,
        device=device,
    )
    result["drift_drill"] = True
    result["gates"] = drift_drill_gates(result)
    return result


def drift_drill_gates(record: Dict[str, Any]) -> Dict[str, Any]:
    """Gate a drift-drill record from its RAW numbers: the shift was
    detected via p(x) before the correction landed, the correction committed
    through the blue/green swap with zero dropped requests and zero steady
    recompiles (serving and consolidation), poisoned traffic never became
    capture-eligible, and served accuracy dipped under drift and recovered
    after the republish."""
    rows: List[Dict[str, Any]] = []

    def gate(key: str, ok: bool, why: str = "") -> None:
        rows.append({"key": key, "ok": bool(ok), "why": "" if ok else why, "baseline": None,
                     "value": None, "direction": "drill"})

    o = record.get("online") or {}
    det = o.get("detection") or {}
    fb = det.get("first_breach") or None
    gate("drill.record", bool(o), "record has no 'online' section — not a drift-drill result")
    gate("drill.detected_via_px", bool(fb) and "px" in (fb.get("signals") or ()),
         "no p(x) drift breach recorded")
    commit_t = det.get("first_commit_t")
    gate("drill.detected_before_correction",
         bool(fb) and commit_t is not None and fb.get("t") is not None and fb["t"] <= commit_t,
         f"breach t={fb.get('t') if fb else None} vs commit t={commit_t}")
    committed = (o.get("republish_by_result") or {}).get("committed", 0)
    gate("drill.republish_committed", committed >= 1,
         "no republish committed through the blue/green swap")
    overall = record.get("overall") or {}
    gate("drill.zero_dropped", overall.get("zero_dropped") is True, "storm dropped requests")
    gate("drill.zero_steady_recompiles", record.get("steady_state_recompiles") == 0,
         f"serving recompiled in steady state: {record.get('steady_state_recompiles')}")
    cons = o.get("consolidation") or {}
    gate("drill.consolidation_compiled_once",
         cons.get("steady_recompiles") == 0 and 0 < (cons.get("compiles") or 0) <= 1,
         f"consolidation program compiles={cons.get('compiles')} "
         f"steady={cons.get('steady_recompiles')}")
    poison = o.get("poison") or {}
    gate("drill.poison_never_capture_eligible", (poison.get("capture_eligible") or 0) == 0,
         f"{poison.get('capture_eligible')} poisoned requests cleared the capture gate")
    windows = o.get("accuracy_windows") or []
    pre = [w for w in windows
           if (w.get("drifted_fraction") or 0) == 0 and w.get("served_accuracy") is not None]
    drifted = [w for w in windows
               if (w.get("drifted_fraction") or 0) > 0.5 and w.get("served_accuracy") is not None]
    if pre and len(drifted) >= 2:
        pre_acc = sum(w["served_accuracy"] for w in pre) / len(pre)
        dip = min(w["served_accuracy"] for w in drifted)
        post_acc = sum(w["served_accuracy"] for w in drifted[-2:]) / 2.0
        detail = f"pre={pre_acc:.3f} dip={dip:.3f} post={post_acc:.3f}"
        gate("drill.accuracy_dipped_under_drift", dip <= pre_acc - 0.05, detail)
        gate("drill.accuracy_recovered_after_republish",
             post_acc >= pre_acc - 0.15 and post_acc >= dip + 0.1, detail)
    else:
        gate("drill.accuracy_curves_present", False,
             "missing pre-drift/drifted accuracy windows")
    return {"ok": all(r["ok"] for r in rows), "checked": len(rows),
            "failed": sum(not r["ok"] for r in rows), "rows": rows}
