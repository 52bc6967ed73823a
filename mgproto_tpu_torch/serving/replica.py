"""Replica supervision: N serving engines behind one admission boundary
(counterpart of mgproto_tpu/serving/replica.py, without its request
tracing).

  * ROUTING: round-robin over replicas whose `HealthProbe.readiness()` is
    true. With none ready the request gets a typed shed (`no_replica`).
  * HEARTBEATS: every supervisor pass over a responsive replica beats it.
    A replica that stops beating (its `alive` or `wedged` flag, which a
    test or an operator hook sets) is detected when its heartbeat goes
    stale, DRAINED (its queued requests move to the survivors with their
    deadlines and enqueue times kept; what finds no room is shed typed as
    `replica_lost`) and scheduled for a restart on `backoff_delays`'s
    jitter-free schedule. The failure is recorded in the flight recorder
    (obs/flightrec.py), which dumps `replica_<dead|wedged>` where it has a
    directory (`cli.serve --telemetry_dir`).
  * RESTARTS: a due replica rebuilds its engine from the factory and warms
    every bucket before it rejoins; a failing factory waits the next,
    longer delay.
  * ELASTICITY (the autoscaler's arms, serving/autoscale.py):
    `add_replica` appends a due-now backoff entry that the next `poll`
    builds and warms (after `engine_prep`, serving/autoscale.py
    `hbm_bucket_prep`, plans its buckets); `remove_replica` drains a victim with zero dropped
    requests: its queue moves to the survivors, what finds no room is
    answered through the victim's own device, and only an unresponsive
    victim's leftovers shed typed (`replica_lost`).
  * CHAOS (resilience/chaos.py): MGPROTO_CHAOS_SERVE_REPLICA_KILL_AT and
    _WEDGE_AT kill or wedge the replica a request would land on, at that
    admitted-request index; the request reroutes.

Replicas share one card in one process: the factory builds engines over
the same loaded model (cli/serve.py), so each replica has its own buckets,
queue and breaker but no copy of the weights.

The clock is injectable and nothing here sleeps or blocks: the supervisor
is a `poll()` pump that the frontend or a batch driver turns.
`steady_recompiles` keeps the JAX name of the summary line's count: here
it sums the engines' dispatches at a bucket that was not warmed (first
launches after warmup), which must stay 0.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from mgproto_tpu_torch.obs import reqtrace as _reqtrace
from mgproto_tpu_torch.obs.flightrec import get_recorder
from mgproto_tpu_torch.resilience import chaos as _chaos
from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.serving.admission import backoff_delays
from mgproto_tpu_torch.serving.batcher import BatcherConfig, MicroBatcher
from mgproto_tpu_torch.serving.health import HealthProbe
from mgproto_tpu_torch.serving.response import (
    REASON_NO_REPLICA,
    REASON_REPLICA_LOST,
    REASON_SHUTDOWN,
    ServeResponse,
    shed_response,
)

STATE_READY = "ready"
STATE_BACKOFF = "backoff"  # failed; waiting for its scheduled restart

FAILURE_DEAD = "dead"  # stopped beating, process presumed gone
FAILURE_WEDGED = "wedged"  # stopped beating, present but stuck


class Replica:
    """One supervised worker: engine + batcher + probe + heartbeat."""

    def __init__(self, name: str, factory: Callable[[], object], clock: Callable[[], float],
                 batcher_config: Optional[BatcherConfig] = None,
                 pre_dispatch: Optional[Callable[[], None]] = None,
                 engine_prep: Optional[Callable[[object], None]] = None):
        self.name = name
        self.factory = factory
        self.clock = clock
        self.batcher_config = batcher_config
        self.pre_dispatch = pre_dispatch
        self.engine_prep = engine_prep
        self.engine = None
        self.batcher: Optional[MicroBatcher] = None
        self.probe: Optional[HealthProbe] = None
        self.state = STATE_BACKOFF
        self.alive = True  # False: the worker is gone
        self.wedged = False  # True: present but unresponsive
        self.last_beat = 0.0
        self.restarts = 0  # restart attempts (paces the backoff)
        self.restart_at = 0.0

    def start(self) -> int:
        """Build and warm the engine; returns the buckets warmed. Raises on
        a factory, `engine_prep` or warmup failure (the supervisor turns it
        into backoff). `engine_prep` runs between the build and the warmup:
        the per-replica bucket planning hook."""
        engine = self.factory()
        if self.engine_prep is not None:
            self.engine_prep(engine)
        warmed = len(engine.warmup())
        self.adopt(engine)
        return warmed

    def adopt(self, engine) -> None:
        """Install a warmed engine (a restart, or the blue/green flip's
        target); the replica keeps its name, its heartbeat restarts."""
        self.engine = engine
        self.batcher = MicroBatcher(engine, config=self.batcher_config, clock=self.clock,
                                    name=self.name, pre_dispatch=self.pre_dispatch)
        self.probe = HealthProbe(engine)
        self.state = STATE_READY
        self.alive = True
        self.wedged = False
        self.last_beat = self.clock()

    def responsive(self) -> bool:
        """Can this replica do work now (beat and dispatch)?"""
        return (self.state == STATE_READY and self.alive and not self.wedged
                and self.engine is not None)

    def routable(self) -> bool:
        """Should new traffic land here?"""
        return bool(self.responsive() and self.probe.readiness()["ready"])

    def beat_stale(self, now: float, timeout_s: float) -> bool:
        return now - self.last_beat > timeout_s


class ReplicaSet:
    """The supervisor (see the module docstring)."""

    def __init__(self, engine_factory: Callable[[], object], replicas: int = 2,
                 clock: Callable[[], float] = time.monotonic, heartbeat_timeout_s: float = 1.0,
                 restart_base_delay_s: float = 0.1, restart_max_delay_s: float = 5.0,
                 batcher_config: Optional[BatcherConfig] = None,
                 pre_dispatch: Optional[Callable[[], None]] = None,
                 engine_prep: Optional[Callable[[object], None]] = None):
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.engine_factory = engine_factory
        self.clock = clock
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.restart_base_delay_s = float(restart_base_delay_s)
        self.restart_max_delay_s = float(restart_max_delay_s)
        self.batcher_config = batcher_config
        self.pre_dispatch = pre_dispatch
        self.engine_prep = engine_prep
        self._next_name = int(replicas)  # names stay unique across add/remove
        self.replicas: List[Replica] = [self._make_replica(f"r{i}")
                                        for i in range(int(replicas))]
        self._rr = 0  # round-robin cursor
        self._seq = 0  # admitted-request index (default ids)
        self._started_at: Optional[float] = None
        self.steady_recompiles = 0  # see the module docstring
        _m.gauge(_m.REPLICAS_TOTAL).set(float(len(self.replicas)))

    def _make_replica(self, name: str) -> Replica:
        # late-bound: a hot swap retargets `engine_factory`, and later
        # restarts build the new model
        return Replica(name, lambda: self.engine_factory(), self.clock,
                       batcher_config=self.batcher_config, pre_dispatch=self.pre_dispatch,
                       engine_prep=self.engine_prep)

    def start(self) -> int:
        """Build and warm every replica; returns the buckets warmed."""
        self._started_at = self.clock()
        warmed = sum(rep.start() for rep in self.replicas)
        self._observe()
        return warmed

    # ---------------------------------------------------------- elasticity
    def add_replica(self) -> Replica:
        """Grow the set by one: a due-now backoff entry, so the next `poll`
        builds and warms it through the restart path, off any request's."""
        rep = self._make_replica(f"r{self._next_name}")
        self._next_name += 1
        rep.restart_at = self.clock()
        self.replicas.append(rep)
        _m.gauge(_m.REPLICAS_TOTAL).set(float(len(self.replicas)))
        _reqtrace.plane_event("replica_added", replica=rep.name)
        self._observe()
        return rep

    def remove_replica(self, rep: Optional[Replica] = None) -> List[ServeResponse]:
        """Shrink the set by one with zero dropped requests. The victim
        (default: a replica without an engine, else the last ready one)
        stops taking traffic, its queue moves to the responsive survivors
        with deadlines and enqueue times kept; what they cannot hold is
        answered through the victim's own device before it leaves, and only
        an unresponsive victim's leftovers shed typed. Returns every
        response produced. Refuses to empty the set."""
        if len(self.replicas) <= 1:
            raise ValueError("refusing to remove the last replica")
        if rep is None:
            idle = [r for r in self.replicas if r.engine is None]
            if idle:
                rep = idle[-1]
            else:
                ready = self.ready_replicas()
                rep = ready[-1] if ready else self.replicas[-1]
        if rep not in self.replicas:
            raise ValueError(f"{rep.name} is not in this set")
        out: List[ServeResponse] = []
        now = self.clock()
        if rep.engine is not None:
            rep.engine.draining = True  # readiness false: no new routing
            stranded = rep.engine.queue.drain_all() + rep.engine.queue.drain_shed()
            survivors = [s for s in self.replicas if s is not rep and s.responsive()]
            i = 0
            for req in stranded:
                placed = False
                for _ in range(len(survivors)):
                    target = survivors[i % len(survivors)]
                    i += 1
                    if target.engine.queue.restore(req):
                        placed = True
                        break
                if placed or (rep.responsive() and rep.engine.queue.restore(req)):
                    continue
                out.append(shed_response(req.request_id, REASON_REPLICA_LOST,
                                         latency_s=now - req.enqueued_at))
            if rep.responsive() and len(rep.engine.queue):
                out.extend(rep.batcher.flush())
                self._account(rep)
        self.replicas.remove(rep)
        _m.gauge(_m.REPLICAS_TOTAL).set(float(len(self.replicas)))
        _reqtrace.plane_event("replica_removed", replica=rep.name)
        self._observe()
        return out

    # ------------------------------------------------------------ routing
    def ready_replicas(self) -> List[Replica]:
        return [rep for rep in self.replicas if rep.routable()]

    def _pick(self) -> Optional[Replica]:
        ready = self.ready_replicas()
        if not ready:
            return None
        rep = ready[self._rr % len(ready)]
        self._rr += 1
        return rep

    def submit(self, payload, request_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               tenant: Optional[str] = None) -> List[ServeResponse]:
        """Route one request to a ready replica (`ServingEngine.submit`'s
        contract, the tenant id passed through: the immediate typed
        responses; empty means queued)."""
        seq = self._seq
        self._seq += 1
        rid = request_id or f"g{seq}"
        if _reqtrace.enabled():
            # frontend-less faces start the request trace here; after the
            # HTTP frontend's mint this is a no-op (the first mint wins)
            _reqtrace.mint(rid, self.clock())
        target = self._pick()
        chaos = _chaos.get_active()
        if chaos is not None and target is not None:
            # the replica this request would land on dies or wedges; the
            # request itself reroutes
            if chaos.serve_replica_kill_due(seq):
                target.alive = False
                _reqtrace.plane_event("replica_kill", replica=target.name)
                target = self._pick()
            elif chaos.serve_replica_wedge_due(seq):
                target.wedged = True
                _reqtrace.plane_event("replica_wedge", replica=target.name)
                target = self._pick()
        if target is None:
            return [shed_response(rid, REASON_NO_REPLICA, tenant=tenant)]
        return target.engine.submit(payload, request_id=rid, deadline_s=deadline_s,
                                    tenant=tenant)

    # ------------------------------------------------------------ pumping
    def _account(self, rep: Replica) -> None:
        self.steady_recompiles += rep.engine.check_cold_dispatches()

    def poll(self) -> List[ServeResponse]:
        """One pass: restart due replicas, detect stale heartbeats (drain,
        reroute, schedule the restart), pump every responsive replica's
        batcher, refresh the fleet gauges."""
        out: List[ServeResponse] = []
        now = self.clock()
        for rep in self.replicas:
            if rep.state == STATE_BACKOFF:
                if now >= rep.restart_at:
                    self._try_restart(rep)
                continue
            if rep.responsive():
                # an open breaker gets no traffic to call allow(): tick it
                rep.engine.breaker.tick()
                out.extend(rep.batcher.poll())
                rep.last_beat = self.clock()
                self._account(rep)
            elif rep.beat_stale(now, self.heartbeat_timeout_s):
                out.extend(self._fail(rep, now))
        self._observe()
        return out

    def flush(self) -> List[ServeResponse]:
        """Answer everything queued through the device without leaving the
        rotation (batch drivers; `drain` is the terminal variant)."""
        out: List[ServeResponse] = []
        for rep in self.replicas:
            if rep.responsive():
                out.extend(rep.batcher.flush())
                self._account(rep)
        self._observe()
        return out

    def shed_stranded(self, reason: str = REASON_REPLICA_LOST) -> List[ServeResponse]:
        """Typed sheds for requests queued on replicas that cannot dispatch
        and were not detected yet: a batch driver's exit leaves nothing
        stranded."""
        out: List[ServeResponse] = []
        now = self.clock()
        for rep in self.replicas:
            if rep.engine is None or rep.responsive():
                continue
            stranded = rep.engine.queue.drain_all() + rep.engine.queue.drain_shed()
            out.extend(shed_response(req.request_id, reason, latency_s=now - req.enqueued_at)
                       for req in stranded)
        self._observe()
        return out

    def drain(self, reason: str = REASON_SHUTDOWN) -> List[ServeResponse]:
        """Graceful shutdown: every queued request is answered (responsive
        replicas flush through the device) or shed typed (the others);
        readiness goes false."""
        out: List[ServeResponse] = []
        for rep in self.replicas:
            if rep.engine is None:
                continue
            rep.engine.draining = True
            if rep.responsive():
                out.extend(rep.batcher.flush())
                self._account(rep)
            else:
                out.extend(rep.engine.drain(reason))
        self._observe()
        return out

    # ------------------------------------------------------------ failure
    def _fail(self, rep: Replica, now: float) -> List[ServeResponse]:
        """A heartbeat-stale replica: count it, move its queue to the
        survivors (deadlines and enqueue times kept), schedule the restart."""
        reason = FAILURE_WEDGED if rep.alive else FAILURE_DEAD
        _m.counter(_m.REPLICA_RESTARTS).inc(reason=reason)
        # what the plane was doing before the heartbeat went stale
        recorder = get_recorder()
        recorder.record("replica_failure", replica=rep.name, reason=reason,
                        queued=len(rep.engine.queue), restarts=rep.restarts)
        _reqtrace.plane_event("replica_fail_detected", replica=rep.name, reason=reason)
        stranded = rep.engine.queue.drain_all() + rep.engine.queue.drain_shed()
        survivors = [s for s in self.replicas if s is not rep and s.responsive()]
        out: List[ServeResponse] = []
        i = 0
        for req in stranded:
            placed = False
            for _ in range(len(survivors)):
                target = survivors[i % len(survivors)]
                i += 1
                if target.engine.queue.restore(req):
                    placed = True
                    break
            if not placed:
                out.append(shed_response(req.request_id, REASON_REPLICA_LOST,
                                         latency_s=now - req.enqueued_at))
        self._to_backoff(rep, now)
        recorder.maybe_dump(f"replica_{reason}")
        return out

    def _to_backoff(self, rep: Replica, now: float) -> None:
        rep.engine = None
        rep.batcher = None
        rep.probe = None
        rep.state = STATE_BACKOFF
        rep.restart_at = now + self._restart_delay(rep.restarts)

    def _restart_delay(self, attempts: int) -> float:
        """The (attempts+1)-th delay of the shared backoff schedule,
        jitter-free."""
        return list(backoff_delays(attempts + 1, base_delay=self.restart_base_delay_s,
                                   max_delay=self.restart_max_delay_s, jitter=0.0))[-1]

    def _try_restart(self, rep: Replica) -> None:
        rep.restarts += 1
        try:
            rep.start()
            _reqtrace.plane_event("replica_restart", replica=rep.name)
        except Exception:
            # the factory or warmup failed: wait the next, longer delay
            self._to_backoff(rep, self.clock())

    def _observe(self) -> None:
        now = self.clock()
        _m.gauge(_m.REPLICAS_READY).set(float(len(self.ready_replicas())))
        depth = sum(len(rep.engine.queue) for rep in self.replicas if rep.engine is not None)
        _m.gauge(_m.QUEUE_DEPTH).set(float(depth))
        if self._started_at is not None:
            uptime = max(now - self._started_at, 0.0)
            _m.gauge(_m.UPTIME_SECONDS).set(uptime)
            open_s = sum(rep.engine.breaker.open_seconds(now)
                         for rep in self.replicas if rep.engine is not None)
            denom = uptime * max(len(self.replicas), 1)
            _m.gauge(_m.BREAKER_OPEN_FRACTION).set(open_s / denom if denom > 0 else 0.0)
