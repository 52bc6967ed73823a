"""Telemetry (counterpart of mgproto_tpu/telemetry; imports no torch until
a health record is taken):

  registry  counters, gauges and histograms with labels; Prometheus text
            and JSONL snapshot sinks (`MetricRegistry`, `JsonlWriter`).
  tracing   nesting wall-clock spans; Chrome-trace export (`Tracer`,
            `trace_span`).
  monitor   `StepMonitor`: step time EMA and histogram, images/s, loader
            wait, host-to-device bytes, the port's cold paths.
  health    `ModelHealth`: per-epoch EM and prototype diagnostics.
  session   `TelemetrySession`: the above wired to a telemetry directory,
            `.h<rank>` sidecars under several ranks.

`cli.telemetry summarize` reads such a directory and `check` gates it.
"""

from mgproto_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    JsonlWriter,
    MetricRegistry,
    default_registry,
    percentile_from_buckets,
    write_jsonl_snapshot,
)
from mgproto_tpu_torch.telemetry.tracing import Tracer, default_tracer, trace_span
from mgproto_tpu_torch.telemetry.monitor import StepMonitor
from mgproto_tpu_torch.telemetry.health import ModelHealth
from mgproto_tpu_torch.telemetry.session import TelemetrySession, make_session

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlWriter",
    "MetricRegistry",
    "default_registry",
    "percentile_from_buckets",
    "write_jsonl_snapshot",
    "Tracer",
    "default_tracer",
    "trace_span",
    "StepMonitor",
    "ModelHealth",
    "TelemetrySession",
    "make_session",
]
