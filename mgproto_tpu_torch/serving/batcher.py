"""Continuous micro-batching over a ServingEngine's admission queue
(counterpart of mgproto_tpu/serving/batcher.py).

Every bucket is warmed before traffic, so any queue depth pads to a warmed
bucket. The batcher decides when waiting for a fuller batch is worth it,
and dispatches when:

  * `bucket_full`: the largest warmed bucket can be filled;
  * `deadline`: the oldest queued request's deadline slack has dropped to
    the measured dispatch cost (an EMA of recent dispatch wall time, seeded
    by `cost_prior_s`): a padded partial batch beats a typed shed;
  * `linger`: the oldest (deadline-less) request has waited `max_linger_s`;
  * `drain`: `flush()` was called (shutdown, blue/green flip).

Host-side; the engine's `process_pending` owns the device. The clock is
injectable (the engine's by default) and nothing sleeps. `pre_dispatch` is
a test hook that runs at the top of every dispatch (a virtual clock
advances there to model device time, which the cost EMA then measures).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from mgproto_tpu_torch.obs import reqtrace as _reqtrace
from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.serving.response import ServeResponse

TRIGGER_BUCKET_FULL = "bucket_full"
TRIGGER_DEADLINE = "deadline"
TRIGGER_LINGER = "linger"
TRIGGER_DRAIN = "drain"


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """Scheduling knobs."""

    cost_prior_s: float = 0.002  # dispatch-cost estimate before any sample
    cost_ema_alpha: float = 0.2  # weight of the newest measured dispatch
    slack_safety: float = 1.0  # dispatch when slack <= cost * safety
    max_linger_s: float = 0.02  # deadline-less requests wait at most this


class MicroBatcher:
    """One batcher per engine; `poll()` dispatches the due batches and
    returns every typed response they produced."""

    def __init__(self, engine, config: Optional[BatcherConfig] = None,
                 clock: Optional[Callable[[], float]] = None, name: Optional[str] = None,
                 pre_dispatch: Optional[Callable[[], None]] = None):
        self.engine = engine
        self.config = config if config is not None else BatcherConfig()
        self.clock = clock if clock is not None else engine.clock
        self.name = name
        self.pre_dispatch = pre_dispatch
        self.dispatch_cost_s = float(self.config.cost_prior_s)
        self.dispatches = 0
        self._tenant_lanes_seen: set = set()  # lanes whose depth gauge was set

    def dispatch_due(self) -> Optional[str]:
        """The trigger that makes dispatching now right, or None."""
        q = self.engine.queue
        if len(q) == 0:
            return None
        now = self.clock()
        if len(q) >= self.engine.buckets[-1]:
            return TRIGGER_BUCKET_FULL
        oldest = q.peek_oldest()
        if oldest.deadline is not None:
            if oldest.deadline - now <= self.dispatch_cost_s * self.config.slack_safety:
                return TRIGGER_DEADLINE
        if now - oldest.enqueued_at >= self.config.max_linger_s:
            return TRIGGER_LINGER
        return None

    def poll(self) -> List[ServeResponse]:
        """Dispatch every due batch and update the queue-depth gauge. Each
        dispatch pops at least one request, so the loop is bounded by the
        depth at entry."""
        out: List[ServeResponse] = []
        for _ in range(len(self.engine.queue) + 1):
            trigger = self.dispatch_due()
            if trigger is None:
                break
            out.extend(self._dispatch(trigger))
        self._observe_depth()
        return out

    def flush(self) -> List[ServeResponse]:
        """Dispatch until the queue is empty: every queued request is
        answered through the device, not shed."""
        out: List[ServeResponse] = []
        while len(self.engine.queue):
            out.extend(self._dispatch(TRIGGER_DRAIN))
        self._observe_depth()
        return out

    def _dispatch(self, trigger: str) -> List[ServeResponse]:
        _m.counter(_m.DISPATCHES).inc(trigger=trigger)
        self.dispatches += 1
        t0 = self.clock()  # before the hook: its virtual time is the cost
        if _reqtrace.enabled():
            # the engine's on_dispatch stamps the batch with this replica's
            # lane, the trigger and t0, so the trace's linger/device split
            # is the cost EMA's
            _reqtrace.dispatch_context(self.name or "", trigger, t0)
        try:
            if self.pre_dispatch is not None:
                self.pre_dispatch()
            responses = self.engine.process_pending()
        finally:
            # a pump that never reached on_dispatch (breaker open, empty
            # pop, device error) must not leak its context into a later one
            if _reqtrace.enabled():
                _reqtrace.clear_dispatch_context()
        dt = self.clock() - t0
        if dt > 0:  # a virtual clock that did not move keeps the estimate
            a = self.config.cost_ema_alpha
            self.dispatch_cost_s = (1 - a) * self.dispatch_cost_s + a * dt
        return responses

    def _observe_depth(self) -> None:
        depth = float(len(self.engine.queue))
        if self.name is not None:
            _m.gauge(_m.QUEUE_DEPTH).set(depth, replica=self.name)
        else:
            _m.gauge(_m.QUEUE_DEPTH).set(depth)
        if getattr(self.engine, "tenants", None) is not None:
            # per-tenant lane depths, zeroed for lanes that drained
            depths = self.engine.queue.tenant_depths()
            for t in self._tenant_lanes_seen - set(depths):
                _m.gauge(_m.TENANT_QUEUE_DEPTH).set(0.0, tenant=t)
            for t, d in depths.items():
                _m.gauge(_m.TENANT_QUEUE_DEPTH).set(float(d), tenant=t)
            self._tenant_lanes_seen |= set(depths)
