"""Serving and loader metrics: names and a minimal in-process registry.

A trimmed copy of mgproto_tpu/serving/metrics.py on a registry of its own:
labeled counters, gauges and histograms held in memory, read back with
`value()` / `count()`. Metrics resolve through the process-current
registry; `set_current_registry` swaps it (tests isolate themselves so).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple

REQUESTS = "serving_requests_total"
REQUEST_SECONDS = "serving_request_seconds"
ABSTAIN_RATE = "serving_abstain_rate"
SHED = "serving_shed_total"
BREAKER_STATE = "serving_breaker_state"
BREAKER_TRANSITIONS = "serving_breaker_transitions_total"
FINGERPRINT_MISMATCHES = "serving_fingerprint_mismatch_total"
PRECISION_MISMATCHES = "serving_precision_mismatch_total"
DEGRADED_REQUESTS = "serving_degraded_requests_total"
DEVICE_ERRORS = "serving_device_errors_total"
BATCH_FILL = "serving_batch_fill_ratio"
BATCH_FILL_HIST = "serving_batch_fill_fraction"
# the input pipeline (data/loader.py)
LOADER_RETRIES = "resilience_retries_total"  # label scope="loader"
LOADER_SENTINEL_ROWS = "loader_sentinel_rows_total"
LOADER_WORKER_RESTARTS = "loader_worker_restarts_total"
LOADER_SHM_SLABS = "loader_shm_slabs_in_use"

FILL_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
TIME_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

_Labels = Tuple[Tuple[str, str], ...]


def _key(labels: Dict[str, object]) -> _Labels:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    def __init__(self):
        self._v: Dict[_Labels, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = _key(labels)
        with self._lock:
            self._v[k] = self._v.get(k, 0.0) + float(amount)

    def value(self, **labels) -> float:
        return self._v.get(_key(labels), 0.0)


class Gauge:
    def __init__(self):
        self._v: Dict[_Labels, float] = {}

    def set(self, value: float, **labels) -> None:
        self._v[_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._v.get(_key(labels), 0.0)


class Histogram:
    def __init__(self, buckets: Sequence[float] = TIME_BUCKETS):
        self.buckets = tuple(buckets)
        self._counts: Dict[_Labels, list] = {}
        self._sum: Dict[_Labels, float] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        k = _key(labels)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * (len(self.buckets) + 1))
            counts[bisect.bisect_left(self.buckets, value)] += 1
            self._sum[k] = self._sum.get(k, 0.0) + float(value)

    def count(self, **labels) -> int:
        return sum(self._counts.get(_key(labels), ()))


class MetricRegistry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets: Sequence[float] = TIME_BUCKETS) -> Histogram:
        return self._get(name, lambda: Histogram(buckets))


_current = MetricRegistry()


def default_registry() -> MetricRegistry:
    return _current


def set_current_registry(registry: Optional[MetricRegistry]) -> MetricRegistry:
    """Install `registry` (None = a fresh one) as process-current; returns
    the previous one."""
    global _current
    prev, _current = _current, registry if registry is not None else MetricRegistry()
    return prev


def counter(name: str) -> Counter:
    return default_registry().counter(name)


def gauge(name: str) -> Gauge:
    return default_registry().gauge(name)


def histogram(name: str) -> Histogram:
    buckets = FILL_BUCKETS if name == BATCH_FILL_HIST else TIME_BUCKETS
    return default_registry().histogram(name, buckets)
