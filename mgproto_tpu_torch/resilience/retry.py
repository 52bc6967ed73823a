"""Retry with exponential backoff and jitter (the port's copy of
mgproto_tpu/resilience/retry.py; imports no torch).

One schedule for every transient-failure site: the loader's sample reads
(`backoff_delays`, data/loader.py) and the checkpoint writes
(`retry_call`, utils/checkpoint.py). Each retry performed increments
`resilience_retries_total{scope=...}`. A seeded numpy Generator makes the
jitter deterministic.
"""

from __future__ import annotations

import random
import time
from functools import wraps
from typing import Callable, Optional, Tuple, Type


def backoff_delays(
    retries: int,
    base_delay: float = 0.1,
    max_delay: float = 5.0,
    jitter: float = 0.5,
    rng=None,
):
    """The delays `retry_call` sleeps through: base * 2^k, capped at
    max_delay, each scaled by a uniform jitter in [1, 1 + jitter)."""
    for attempt in range(retries):
        delay = min(max_delay, base_delay * (2.0 ** attempt))
        u = rng.random() if rng is not None else random.random()
        yield delay * (1.0 + jitter * u)


def retry_call(
    fn: Callable,
    *args,
    retries: int = 3,
    base_delay: float = 0.1,
    max_delay: float = 5.0,
    jitter: float = 0.5,
    deadline_s: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    no_retry_on: Tuple[Type[BaseException], ...] = (),
    scope: str = "generic",
    on_retry: Optional[Callable] = None,
    sleep: Callable[[float], None] = time.sleep,
    rng=None,
    **kwargs,
):
    """Call `fn(*args, **kwargs)`, retrying up to `retries` times on
    `retry_on` with `backoff_delays`. `deadline_s` bounds the total wall
    time: a retry whose backoff would land past it re-raises instead.
    `no_retry_on` carves exceptions out of `retry_on` (a barrier timeout:
    the dead peer cannot join a retry either). `on_retry(attempt, exc,
    delay)` observes each retry performed."""
    start = time.monotonic()
    delays = backoff_delays(retries, base_delay, max_delay, jitter, rng=rng)
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if no_retry_on and isinstance(e, no_retry_on):
                raise
            attempt += 1
            if attempt > retries:
                raise
            delay = next(delays)
            if deadline_s is not None and time.monotonic() - start + delay > deadline_s:
                raise
            from mgproto_tpu_torch.resilience import metrics as _m

            _m.counter(_m.RETRIES).inc(scope=scope)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)


def retryable(
    retries: int = 3,
    base_delay: float = 0.1,
    max_delay: float = 5.0,
    jitter: float = 0.5,
    deadline_s: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    no_retry_on: Tuple[Type[BaseException], ...] = (),
    scope: str = "generic",
    on_retry: Optional[Callable] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Decorator form of `retry_call` (the same parameters)."""

    def deco(fn):
        @wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, *args, retries=retries, base_delay=base_delay,
                              max_delay=max_delay, jitter=jitter, deadline_s=deadline_s,
                              retry_on=retry_on, no_retry_on=no_retry_on, scope=scope,
                              on_retry=on_retry, sleep=sleep, **kwargs)

        return wrapper

    return deco
