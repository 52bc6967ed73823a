"""The trust-plane metric names and their registration (counterpart of
mgproto_tpu/trust/metrics.py). The names and help strings live in the
port's registry module (serving/metrics.py); `register_trust_metrics`
pre-creates the family with zero-valued unlabeled series, so a scrape of a
run that never verified still shows the series. Values are rates, scores
and metric percentages, not times."""

from __future__ import annotations

from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.serving.metrics import (  # noqa: F401 (the names, re-exported)
    ANSWERED_ACCURACY,
    INTERP_CONSISTENCY,
    INTERP_PURITY,
    INTERP_STABILITY,
    MATRIX_CELLS,
    PAIR_AUROC,
    PX_DIVERGENCE,
    VERDICTS,
)
from mgproto_tpu_torch.serving.metrics import TRUST_ABSTENTION_RATE as ABSTENTION_RATE

COUNTER_HELP = _m.TRUST_COUNTER_HELP
GAUGE_HELP = _m.TRUST_GAUGE_HELP
ALL_COUNTERS = tuple(COUNTER_HELP)
ALL_GAUGES = tuple(GAUGE_HELP)


def counter(name: str) -> _m.Counter:
    """The named trust counter in the process-current registry."""
    return _m.default_registry().counter(name, COUNTER_HELP.get(name, ""))


def gauge(name: str) -> _m.Gauge:
    """The named trust gauge in the process-current registry."""
    return _m.default_registry().gauge(name, GAUGE_HELP.get(name, ""))


def register_trust_metrics(registry: _m.MetricRegistry) -> None:
    """Pre-create the trust family with explicit zeros."""
    for name in ALL_COUNTERS:
        registry.counter(name, COUNTER_HELP[name]).inc(0.0)
    for name in ALL_GAUGES:
        registry.gauge(name, GAUGE_HELP[name]).set(0.0)
