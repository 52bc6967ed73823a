"""Admission control: bounded queue, deadline shedding, circuit breaker
(trimmed copy of mgproto_tpu/serving/admission.py, single tenant).

  * `AdmissionQueue`: FIFO with a hard capacity and per-request deadlines.
    A full queue first sheds entries already past their deadline, then the
    newcomer; `pop_batch` sheds entries that expired while queued.
  * `CircuitBreaker`: closed -> open after `failure_threshold` consecutive
    failures; the open cooldown follows `backoff_delays` (jitter-free);
    after it a half-open probe admits one batch.

Clocks are injectable so tests drive deadlines and recovery without sleeping.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import time
from collections import deque
from typing import Any, Callable, Deque, List, Optional, Tuple

from mgproto_tpu_torch.serving import metrics as _m

SHED_QUEUE_FULL = "queue_full"
SHED_DEADLINE = "deadline"

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
        self.shed.append(req)

    def submit(self, payload: Any, request_id: Optional[str] = None,
               deadline_s: Optional[float] = None
               ) -> Tuple[ServeRequest, Optional[str]]:
        """Admit a request: (request, None), or (request, shed_reason) when
        it was shed instead (also recorded in `self.shed`)."""
        now = self.clock()
        req = ServeRequest(
            payload=payload,
            request_id=request_id or f"r{next(self._ids)}",
            deadline=None if deadline_s is None else now + deadline_s,
            enqueued_at=now,
        )
        if req.expired(now):
            self._shed(req, SHED_DEADLINE)
            return req, SHED_DEADLINE
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

    def pop_batch(self, max_size: int) -> List[ServeRequest]:
        """Up to `max_size` still-viable requests, FIFO; expired ones shed."""
        now = self.clock()
        out: List[ServeRequest] = []
        while self._q and len(out) < max_size:
            req = self._q.popleft()
            if req.expired(now):
                self._shed(req, SHED_DEADLINE)
                continue
            out.append(req)
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
        _m.gauge(_m.BREAKER_STATE).set(_STATE_GAUGE[self.state])

    def _transition(self, new_state: str) -> None:
        if new_state == self.state:
            return
        _m.counter(_m.BREAKER_TRANSITIONS).inc(edge=f"{self.state}->{new_state}")
        self.state = new_state
        _m.gauge(_m.BREAKER_STATE).set(_STATE_GAUGE[new_state])

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
