"""The port's observatory (counterpart of mgproto_tpu/obs/): the
instrumentation that turns "the run was slow" into line items, on top of
the telemetry plane (registry / tracer / monitors, telemetry/).

  profiler  — `ProfilerWindow`: opens a `torch.profiler` capture (CPU and
              CUDA activities) for a configured step range or on an anomaly
              trigger (step-time spike over the EMA, a cold path through
              the StepMonitor, loader-wait share); on the CPU, which a
              caller asks for, a counted-cost-only capture. No fallback on
              the card. `profile_block` for one-shot captures (serve warmup).
  stall     — stall-budget attribution: a captured trace (a kineto trace's
              CUDA streams merged into one device lane) or the counted cost
              of the production step apportioned into MXU-busy / HBM-bound /
              collective / host+infeed / bubble buckets, with measured MFU
              against the H100's peaks. Driven by `cli/trace_report.py`.
  opcount   — the cost counter behind stall's cost side: FLOPs and bytes of
              a real run under a TorchDispatchMode, the four kernels and the
              optimizers charged by rule so the CPU and the card agree.
  reqtrace  — end-to-end request tracing through the serving plane:
              frontend -> batcher -> replica -> engine stage spans on the
              plane's injectable clock, per-stage latency histograms and an
              opt-in timing breakdown on the ServeResponse. No per-request
              work when disabled.
  flightrec — bounded ring buffer of recent structured events (steps,
              rollbacks, preemptions, replica deaths, drift, swaps) dumped
              to JSONL on a failure, every event tagged with its rank.

Not ported yet: the JAX package's `fleet.SkewMonitor` (straggler
detection, ROADMAP A item 7). Everything here is host-side; only a
capture on the card, opcount and stall's cost side import torch, where
they run. The regression gate lives in `cli/telemetry.py` (`check
--stall-report`).
"""

from mgproto_tpu_torch.obs.flightrec import (
    FlightRecorder,
    get_recorder,
    record_event,
    set_recorder,
)

__all__ = [
    "FlightRecorder",
    "get_recorder",
    "record_event",
    "set_recorder",
]
