"""The online and drift metric names and their registration (counterpart
of mgproto_tpu/online/metrics.py). The names and help strings live in the
port's registry module (serving/metrics.py); `register_online_metrics`
pre-creates the family with zero-valued unlabeled series, so a scrape of a
run that never drifted still shows the series."""

from __future__ import annotations

from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.serving.metrics import (  # noqa: F401 (the names, re-exported)
    ACTIVE_CLASSES,
    CAPTURE_EVICTED,
    CAPTURED,
    CLASS_ADDITIONS,
    CONSOLIDATED_SAMPLES,
    CONSOLIDATIONS,
    DRIFT_BREACHES,
    DRIFT_CLASS_SHIFT,
    DRIFT_COV_SHIFT_MAX,
    DRIFT_PX_DIVERGENCE,
    DRIFT_SHIFT_MAX,
    REPUBLISH,
    STAGED,
)

COUNTER_HELP = _m.ONLINE_COUNTER_HELP
GAUGE_HELP = _m.ONLINE_GAUGE_HELP
ALL_COUNTERS = tuple(COUNTER_HELP)
ALL_GAUGES = tuple(GAUGE_HELP)


def counter(name: str) -> _m.Counter:
    """The named online counter in the process-current registry."""
    return _m.default_registry().counter(name, COUNTER_HELP.get(name, ""))


def gauge(name: str) -> _m.Gauge:
    """The named online gauge in the process-current registry."""
    return _m.default_registry().gauge(name, GAUGE_HELP.get(name, ""))


def register_online_metrics(registry: _m.MetricRegistry) -> None:
    """Pre-create the online/drift family with explicit zeros."""
    for name in ALL_COUNTERS:
        registry.counter(name, COUNTER_HELP[name]).inc(0.0)
    for name in ALL_GAUGES:
        registry.gauge(name, GAUGE_HELP[name]).set(0.0)
