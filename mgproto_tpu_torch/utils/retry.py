"""The backoff schedule of the loader's sample retries (the port's copy of
`backoff_delays` from mgproto_tpu/resilience/retry.py)."""

from __future__ import annotations

import random


def backoff_delays(
    retries: int,
    base_delay: float = 0.1,
    max_delay: float = 5.0,
    jitter: float = 0.5,
    rng=None,
):
    """base * 2^k, capped at max_delay, each scaled by a uniform jitter in
    [1, 1 + jitter). A seeded numpy Generator makes the jitter
    deterministic."""
    for attempt in range(retries):
        delay = min(max_delay, base_delay * (2.0 ** attempt))
        u = rng.random() if rng is not None else random.random()
        yield delay * (1.0 + jitter * u)
