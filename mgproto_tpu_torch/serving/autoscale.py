"""The autoscaler: grow and shrink a ReplicaSet under load (counterpart of
mgproto_tpu/serving/autoscale.py).

A pump-hook policy on the plane's injectable clock (no threads, no
sleeps): `tick()` runs where `ReplicaSet.poll()` runs (the HTTP frontend's
pump step, a batch driver's loop), reads the serving metrics over a
decision window and steers the replica count within
`[min_replicas, max_replicas]`:

  * SCALE UP when the fleet is saturated: queue depth per ready replica,
    the window's shed rate, or the window's p99 over their thresholds. The
    new replica is added by `ReplicaSet.add_replica()`, a due-now backoff
    entry that the next poll builds and warms off any request's path.
  * SCALE DOWN after `down_patience` calm evaluations in a row: shallow
    queues, no sheds in the window, low capacity utilization. The victim
    drains through `ReplicaSet.remove_replica()` with zero dropped
    requests; the decision carries the responses that drain produced.

Window signals are deltas of the cumulative registry between evaluations
(`MetricRegistry.snapshot`): p99 comes from the difference of the request
latency histogram's bucket counts, so a decision sees the last window's
tail. Every applied decision counts `autoscale_events_total{direction}`
and sets the `autoscale_replicas_target` gauge.

`hbm_bucket_prep` is the ReplicaSet's `engine_prep` hook of `cli.serve
--auto_tune`: every engine a start, a restart or a scale-up builds plans
its buckets with the memory planner before its warmup, and one whose
buckets all exceed the budget fails closed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.serving.response import ServeResponse

DIRECTION_UP = "up"
DIRECTION_DOWN = "down"


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Thresholds and pacing. Any saturation signal scales up; every calm
    condition, `down_patience` evaluations in a row, scales down."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 0.25  # decision cadence on the clock
    up_queue_per_replica: float = 6.0  # queued requests per ready replica
    up_shed_rate: float = 0.02  # window sheds / window requests
    up_p99_s: float = 0.0  # window request p99 (0: signal off)
    down_queue_per_replica: float = 1.0
    # window requests / (window dispatches x the largest bucket): per-
    # dispatch fill is ~1 by construction (pad to the smallest bucket), so
    # utilization against the largest bucket tells busy from idle
    down_utilization: float = 0.5
    down_patience: int = 3  # calm evaluations in a row before a shrink
    up_cooldown_s: float = 0.5  # least spacing of scale-ups
    down_cooldown_s: float = 1.0  # least spacing of scale-downs


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One applied decision (`tick` returns None when nothing changed)."""

    t: float
    direction: str
    reason: str
    replicas_before: int
    replicas_after: int
    signals: Dict[str, Any]
    responses: List[ServeResponse] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"t": round(self.t, 6), "direction": self.direction, "reason": self.reason,
                "replicas_before": self.replicas_before, "replicas_after": self.replicas_after,
                "signals": self.signals}


def _merged_hist(snapshot: Dict, name: str) -> Optional[Dict[str, Any]]:
    """One cumulative histogram series merged across label sets."""
    m = snapshot.get(name)
    if not m or m.get("type") != "histogram":
        return None
    merged: Optional[Dict[str, Any]] = None
    for s in m.get("series", []):
        if merged is None:
            merged = {"bounds": list(s["bounds"]), "bucket_counts": list(s["bucket_counts"]),
                      "count": s["count"], "sum": s["sum"]}
        else:
            merged["bucket_counts"] = [a + b for a, b in
                                       zip(merged["bucket_counts"], s["bucket_counts"])]
            merged["count"] += s["count"]
            merged["sum"] += s["sum"]
    return merged


def _counter_total(snapshot: Dict, name: str) -> float:
    m = snapshot.get(name) or {}
    return sum(s.get("value") or 0.0 for s in m.get("series", []))


def _hist_delta(cur: Optional[Dict[str, Any]],
                prev: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """cur - prev as a bucket dict (None when cur is absent)."""
    if cur is None:
        return None
    if prev is None:
        return dict(cur)
    return {"bounds": cur["bounds"],
            "bucket_counts": [a - b for a, b in zip(cur["bucket_counts"],
                                                    prev["bucket_counts"])],
            "count": cur["count"] - prev["count"], "sum": cur["sum"] - prev["sum"]}


class Autoscaler:
    """`tick(now)` is the whole interface: call it from the pump that turns
    `ReplicaSet.poll()`. Returns the applied `ScaleDecision`, whose
    `responses` (typed answers from a scale-down's drain) the caller must
    deliver, or None."""

    def __init__(self, replica_set, config: Optional[AutoscalerConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.rs = replica_set
        self.config = config if config is not None else AutoscalerConfig()
        if self.config.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.config.max_replicas < self.config.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.clock = clock if clock is not None else replica_set.clock
        self._last_eval: Optional[float] = None
        self._last_up = -math.inf
        self._last_down = -math.inf
        self._calm_streak = 0
        self._prev: Dict[str, Any] = {}
        self.decisions: List[ScaleDecision] = []
        _m.gauge(_m.AUTOSCALE_TARGET).set(float(len(self.rs.replicas)))

    def _signals(self, now: float) -> Dict[str, Any]:
        """One window's view: counter and histogram deltas since the last
        evaluation, and the fleet's state now."""
        snapshot = _m.default_registry().snapshot()
        ready = len(self.rs.ready_replicas())
        depth = sum(len(rep.engine.queue) for rep in self.rs.replicas if rep.engine is not None)
        requests = _counter_total(snapshot, _m.REQUESTS)
        sheds = _counter_total(snapshot, _m.SHED)
        lat = _merged_hist(snapshot, _m.REQUEST_SECONDS)
        fill = _merged_hist(snapshot, _m.BATCH_FILL_HIST)
        w_requests = requests - self._prev.get("requests", 0.0)
        w_sheds = sheds - self._prev.get("sheds", 0.0)
        w_lat = _hist_delta(lat, self._prev.get("lat"))
        w_fill = _hist_delta(fill, self._prev.get("fill"))
        self._prev = {"requests": requests, "sheds": sheds, "lat": lat, "fill": fill}
        p99 = None
        if w_lat and w_lat["count"] > 0:
            p99 = _m.percentile_from_buckets(w_lat, 99.0)
        fill_mean = w_dispatches = None
        if w_fill and w_fill["count"] > 0:
            fill_mean = w_fill["sum"] / w_fill["count"]
            w_dispatches = w_fill["count"]
        max_bucket = max((rep.engine.buckets[-1] for rep in self.rs.replicas
                          if rep.engine is not None), default=0)
        utilization = None
        if w_dispatches and max_bucket:
            utilization = w_requests / (w_dispatches * max_bucket)
        return {
            "t": round(now, 6),
            "replicas": len(self.rs.replicas),
            "replicas_ready": ready,
            "queue_depth": depth,
            "queue_per_replica": depth / max(ready, 1),
            "window_requests": w_requests,
            "window_sheds": w_sheds,
            "shed_rate": (w_sheds / w_requests) if w_requests > 0 else 0.0,
            "window_p99_s": p99,
            "window_batch_fill": fill_mean,
            "window_dispatches": w_dispatches,
            "window_utilization": utilization,
        }

    def _saturation_reason(self, sig: Dict[str, Any]) -> Optional[str]:
        c = self.config
        if sig["queue_per_replica"] >= c.up_queue_per_replica:
            return "queue_depth"
        if sig["window_requests"] > 0 and sig["shed_rate"] >= c.up_shed_rate:
            return "shed_rate"
        if c.up_p99_s > 0 and sig["window_p99_s"] is not None and sig["window_p99_s"] >= c.up_p99_s:
            return "p99"
        return None

    def _calm(self, sig: Dict[str, Any]) -> bool:
        c = self.config
        if sig["window_sheds"] > 0 or sig["queue_per_replica"] > c.down_queue_per_replica:
            return False
        util = sig["window_utilization"]
        return util is None or util <= c.down_utilization

    def tick(self, now: Optional[float] = None) -> Optional[ScaleDecision]:
        """Evaluate on the cadence; apply at most one scale step."""
        now = self.clock() if now is None else now
        c = self.config
        if self._last_eval is not None and now - self._last_eval < c.interval_s:
            return None
        self._last_eval = now
        sig = self._signals(now)
        before = len(self.rs.replicas)
        reason = self._saturation_reason(sig)
        if (reason is not None and before < c.max_replicas
                and now - self._last_up >= c.up_cooldown_s):
            self._calm_streak = 0
            self._last_up = now
            self.rs.add_replica()
            return self._applied(now, DIRECTION_UP, reason, before, sig, [])
        if reason is not None:
            # saturated but unable to grow: no shrink may follow
            self._calm_streak = 0
            return None
        if not self._calm(sig):
            self._calm_streak = 0
            return None
        self._calm_streak += 1
        if (self._calm_streak >= c.down_patience and before > c.min_replicas
                and now - self._last_down >= c.down_cooldown_s):
            self._calm_streak = 0
            self._last_down = now
            responses = self.rs.remove_replica()
            return self._applied(now, DIRECTION_DOWN, "calm", before, sig, responses)
        return None

    def _applied(self, now: float, direction: str, reason: str, before: int,
                 sig: Dict[str, Any], responses: List[ServeResponse]) -> ScaleDecision:
        after = len(self.rs.replicas)
        _m.counter(_m.AUTOSCALE_EVENTS).inc(direction=direction)
        _m.gauge(_m.AUTOSCALE_TARGET).set(float(after))
        decision = ScaleDecision(t=now, direction=direction, reason=reason,
                                 replicas_before=before, replicas_after=after, signals=sig,
                                 responses=responses)
        self.decisions.append(decision)
        return decision

    def status(self) -> Dict[str, Any]:
        """The operator's view (the frontend's GET /admin/autoscale)."""
        return {
            "min_replicas": self.config.min_replicas,
            "max_replicas": self.config.max_replicas,
            "replicas": len(self.rs.replicas),
            "replicas_ready": len(self.rs.ready_replicas()),
            "calm_streak": self._calm_streak,
            "decisions": len(self.decisions),
            "last_decision": self.decisions[-1].to_dict() if self.decisions else None,
        }


def hbm_bucket_prep(budget_bytes: Optional[int] = None, margin: Optional[float] = None,
                    log: Optional[Callable[[str], None]] = None,
                    weight_bytes: int = 0) -> Callable[[Any], None]:
    """An `engine_prep` hook (ReplicaSet) that sizes every new engine's
    buckets to its device's budget with perf/planner.py
    `plan_serve_buckets` (`weight_bytes`: the artifact's resident weight
    term) before its warmup. Fail-closed like `cli.serve --auto_tune`: no
    fitting bucket raises, which sends the replica to backoff instead of
    warming a predicted out-of-memory error."""

    def prep(engine) -> None:
        from mgproto_tpu_torch.perf.planner import plan_serve_buckets

        fitting, outcome = plan_serve_buckets(engine, budget_bytes=budget_bytes, margin=margin,
                                              log=log, weight_bytes=weight_bytes)
        if not fitting:
            raise RuntimeError("hbm_bucket_prep: no warmup bucket fits the HBM budget "
                               f"({outcome.budget_bytes} bytes, margin {outcome.margin})")
        if tuple(fitting) != engine.buckets:
            engine.buckets = tuple(fitting)

    return prep
