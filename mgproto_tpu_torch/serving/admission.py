"""Admission control: bounded queue, deadline shedding, tenant lanes,
circuit breaker (copy of mgproto_tpu/serving/admission.py).

  * `AdmissionQueue`: FIFO with a hard capacity and per-request deadlines.
    A full queue first sheds entries already past their deadline, then the
    newcomer; `pop_batch` sheds entries that expired while queued.
    `drain_all` / `restore` move queued requests between engines (a
    replica's reroute, a blue/green swap) with their identity, deadline and
    enqueue time kept.
  * Tenant lanes: a request may carry a tenant id and that tenant's quota
    (serving/tenants.py `quota_for`). A tenant at its quota sheds its own
    tail, its expired entries first, then the newcomer (`tenant_quota`),
    never another tenant's work; with more than one lane queued,
    `pop_batch` gives batch slots to the lanes in turn. Without tenants
    every path is the single-lane FIFO.
  * `CircuitBreaker`: closed -> open after `failure_threshold` consecutive
    failures; the open cooldown follows `backoff_delays` (jitter-free);
    after it a half-open probe admits one batch. `open_seconds` accounts
    the outage time; `tick` lets a supervisor advance open -> half-open on
    a replica that gets no traffic.

Clocks are injectable so tests drive deadlines and recovery without sleeping.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from mgproto_tpu_torch.serving import metrics as _m

SHED_QUEUE_FULL = "queue_full"
SHED_DEADLINE = "deadline"
SHED_TENANT_QUOTA = "tenant_quota"  # a tenant's own tail, over its fair share

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

_STATE_GAUGE = {BREAKER_CLOSED: 0.0, BREAKER_HALF_OPEN: 0.5, BREAKER_OPEN: 1.0}


def backoff_delays(retries: int, base_delay: float = 0.1, max_delay: float = 5.0,
                   jitter: float = 0.5, rng=None):
    """base * 2^k capped at max_delay, each scaled by a uniform jitter in
    [1, 1 + jitter) (copy of mgproto_tpu/resilience/retry.py)."""
    for attempt in range(retries):
        delay = min(max_delay, base_delay * (2.0 ** attempt))
        u = rng.random() if rng is not None else random.random()
        yield delay * (1.0 + jitter * u)


@dataclasses.dataclass
class ServeRequest:
    """An opaque payload plus its latency contract; `deadline` is an
    absolute clock() time (None = no deadline)."""

    payload: Any
    request_id: str
    deadline: Optional[float] = None
    enqueued_at: float = 0.0
    tenant: Optional[str] = None  # the tenant lane; None = no lane

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class AdmissionQueue:
    def __init__(self, capacity: int = 64, clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self._q: Deque[ServeRequest] = deque()
        self._ids = itertools.count()
        self.shed: List[ServeRequest] = []  # drained by the engine

    def __len__(self) -> int:
        return len(self._q)

    def _shed(self, req: ServeRequest, reason: str) -> None:
        _m.counter(_m.SHED).inc(reason=reason)
        if req.tenant is not None:
            _m.counter(_m.TENANT_SHED).inc(tenant=req.tenant, reason=reason)
        self.shed.append(req)

    def tenant_depths(self) -> Dict[str, int]:
        """Queued entries per tenant lane (requests without a tenant are
        not listed)."""
        out: Dict[str, int] = {}
        for req in self._q:
            if req.tenant is not None:
                out[req.tenant] = out.get(req.tenant, 0) + 1
        return out

    def submit(self, payload: Any, request_id: Optional[str] = None,
               deadline_s: Optional[float] = None, tenant: Optional[str] = None,
               quota: Optional[int] = None) -> Tuple[ServeRequest, Optional[str]]:
        """Admit a request: (request, None), or (request, shed_reason) when
        it was shed instead (also recorded in `self.shed`). `quota` (with
        `tenant`) is the tenant's share of this queue: at it the tenant
        sheds its own expired entries, then the newcomer (`tenant_quota`)."""
        now = self.clock()
        req = ServeRequest(
            payload=payload,
            request_id=request_id or f"r{next(self._ids)}",
            deadline=None if deadline_s is None else now + deadline_s,
            enqueued_at=now,
            tenant=tenant,
        )
        if req.expired(now):
            self._shed(req, SHED_DEADLINE)
            return req, SHED_DEADLINE
        if tenant is not None and quota is not None:
            held = sum(1 for r in self._q if r.tenant == tenant)
            if held >= quota:
                keep: Deque[ServeRequest] = deque()
                for queued in self._q:
                    if queued.tenant == tenant and queued.expired(now):
                        self._shed(queued, SHED_DEADLINE)
                        held -= 1
                    else:
                        keep.append(queued)
                self._q = keep
                if held >= quota:
                    self._shed(req, SHED_TENANT_QUOTA)
                    return req, SHED_TENANT_QUOTA
        if len(self._q) >= self.capacity:
            keep: Deque[ServeRequest] = deque()
            for queued in self._q:
                if queued.expired(now):
                    self._shed(queued, SHED_DEADLINE)
                else:
                    keep.append(queued)
            self._q = keep
            if len(self._q) >= self.capacity:
                self._shed(req, SHED_QUEUE_FULL)
                return req, SHED_QUEUE_FULL
        self._q.append(req)
        return req, None

    def peek_oldest(self) -> Optional[ServeRequest]:
        """The request that has waited longest (None when empty)."""
        return self._q[0] if self._q else None

    def drain_all(self) -> List[ServeRequest]:
        """Remove and return everything queued, unanswered and unaccounted,
        for transfer: the caller answers each drained request (typed) or
        restores it somewhere."""
        out = list(self._q)
        self._q.clear()
        return out

    def restore(self, req: ServeRequest) -> bool:
        """Re-admit a transferred request with its identity, deadline and
        original `enqueued_at`. False at capacity: the caller answers it."""
        if len(self._q) >= self.capacity:
            return False
        self._q.append(req)
        return True

    def pop_batch(self, max_size: int) -> List[ServeRequest]:
        """Up to `max_size` still-viable requests, FIFO; expired ones shed.
        With more than one tenant lane queued, the slots go to the lanes in
        turn (`_pop_batch_fair`)."""
        now = self.clock()
        if len({r.tenant for r in self._q}) > 1:
            return self._pop_batch_fair(max_size, now)
        out: List[ServeRequest] = []
        while self._q and len(out) < max_size:
            req = self._q.popleft()
            if req.expired(now):
                self._shed(req, SHED_DEADLINE)
                continue
            out.append(req)
        return out

    def _pop_batch_fair(self, max_size: int, now: float) -> List[ServeRequest]:
        """Round-robin over the lanes, ordered by their oldest entry, FIFO
        within a lane; expired entries shed as on the FIFO path."""
        lanes: Dict[Any, Deque[ServeRequest]] = {}
        for req in self._q:
            lanes.setdefault(req.tenant, deque()).append(req)
        out: List[ServeRequest] = []
        removed: List[ServeRequest] = []
        progressed = True
        while len(out) < max_size and progressed:
            progressed = False
            for lane in lanes.values():
                if len(out) >= max_size:
                    break
                while lane:
                    req = lane.popleft()
                    removed.append(req)
                    if req.expired(now):
                        self._shed(req, SHED_DEADLINE)
                        continue
                    out.append(req)
                    progressed = True
                    break
        gone = {id(r) for r in removed}
        self._q = deque(r for r in self._q if id(r) not in gone)
        return out

    def drain_shed(self) -> List[ServeRequest]:
        out, self.shed = self.shed, []
        return out


class CircuitBreaker:
    """Consecutive-failure breaker with backoff-paced recovery."""

    def __init__(self, failure_threshold: int = 3, base_delay: float = 0.5,
                 max_delay: float = 30.0, clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.clock = clock
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self._open_until = 0.0
        self._reopen_count = 0
        self._state_since = clock()
        self._open_seconds_total = 0.0
        _m.gauge(_m.BREAKER_STATE).set(_STATE_GAUGE[self.state])

    def _transition(self, new_state: str) -> None:
        if new_state == self.state:
            return
        now = self.clock()
        if self.state == BREAKER_OPEN:
            self._open_seconds_total += max(now - self._state_since, 0.0)
        self._state_since = now
        _m.counter(_m.BREAKER_TRANSITIONS).inc(edge=f"{self.state}->{new_state}")
        self.state = new_state
        _m.gauge(_m.BREAKER_STATE).set(_STATE_GAUGE[new_state])

    def open_seconds(self, now: Optional[float] = None) -> float:
        """Cumulative seconds spent OPEN, the current open period included."""
        total = self._open_seconds_total
        if self.state == BREAKER_OPEN:
            total += max((self.clock() if now is None else now) - self._state_since, 0.0)
        return total

    def _cooldown(self) -> float:
        return list(backoff_delays(
            self._reopen_count + 1, base_delay=self.base_delay,
            max_delay=self.max_delay, jitter=0.0,
        ))[-1]

    def allow(self) -> bool:
        """May a batch be dispatched now? An elapsed cooldown moves the
        breaker to half-open and admits one probe batch."""
        if self.state == BREAKER_CLOSED:
            return True
        if self.state == BREAKER_OPEN and self.clock() >= self._open_until:
            self._transition(BREAKER_HALF_OPEN)
            return True
        return self.state == BREAKER_HALF_OPEN

    def tick(self) -> None:
        """Advance the lazy open -> half-open transition without asking to
        dispatch: readiness-gated routing starves an open replica of the
        traffic whose `allow()` would do it."""
        if self.state == BREAKER_OPEN and self.clock() >= self._open_until:
            self._transition(BREAKER_HALF_OPEN)

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state != BREAKER_CLOSED:
            self._transition(BREAKER_CLOSED)
            self._reopen_count = 0

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == BREAKER_HALF_OPEN:
            self._reopen_count += 1
            self._open_until = self.clock() + self._cooldown()
            self._transition(BREAKER_OPEN)
        elif (self.state == BREAKER_CLOSED
              and self.consecutive_failures >= self.failure_threshold):
            self._open_until = self.clock() + self._cooldown()
            self._transition(BREAKER_OPEN)
