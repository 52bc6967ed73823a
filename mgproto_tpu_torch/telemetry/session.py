"""TelemetrySession: one run's telemetry wiring and its directory
(counterpart of mgproto_tpu/telemetry/session.py; imports no torch until
an epoch ends).

Owns (or borrows) a registry and a tracer, installs them as
process-current (so the serving, loader, resilience, online and trust
metrics and `utils/log.py::timed_span` land in this run's directory, and a
second run in one process starts from zero), and holds a StepMonitor and a
ModelHealth recorder. While a session is open it is `current_session()`:
a serving engine or a consolidator built then observes its dispatches
into the session's registry; without one they keep no monitor. It writes:

    metrics.prom    the latest Prometheus text (atomic overwrite)
    metrics.jsonl   one registry snapshot per flush (summarize's input)
    health.jsonl    one ModelHealth record per epoch
    trace.json      the tracer's Chrome trace
    meta.json       run configuration (rank 0 only, merged per call)

Under torch.distributed, rank 0 writes the canonical files and rank p > 0
the same streams with a `.h<p>` suffix (`metrics.jsonl.h1`, ...), the
naming of the flight recorder's dumps; every snapshot line carries `host`.
One process is rank 0. `end_epoch` sums the epoch's images over the ranks
(`parallel/multihost.py::allgather_sum`, a collective: every rank calls
it).

Pre-registered at explicit zeros, so a clean run's snapshots show "nothing
happened" instead of absent series: the resilience, online and trust
families, the EM fast path's gauge and fallback counter, the planner's
rejection counter, the loader's shm gauge, and the per-rank state bytes
(`observe_state_bytes`). `cli/serve.py` adds the serving family to a
serving session's registry. The fleet family of the JAX session (barrier
and collective waits, arrival skew, heartbeat age, straggler flags,
allgather bytes) belongs to straggler detection, which the port does not
have: its series are absent, not zero.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from mgproto_tpu_torch.telemetry.health import ModelHealth
from mgproto_tpu_torch.telemetry.monitor import StepMonitor
from mgproto_tpu_torch.telemetry.registry import (
    JsonlWriter,
    MetricRegistry,
    set_current_registry,
    write_jsonl_snapshot,
)
from mgproto_tpu_torch.telemetry.tracing import Tracer, set_current_tracer

PROM_FILE = "metrics.prom"
METRICS_FILE = "metrics.jsonl"
HEALTH_FILE = "health.jsonl"
TRACE_FILE = "trace.json"
META_FILE = "meta.json"

# the EM fast path (core/em.py): the widest EM call of the last epoch and
# the dense fallbacks of the compact dirty-class slab
EM_ACTIVE_GAUGE = "em_active_classes"
EM_FALLBACK_COUNTER = "em_compact_fallback_total"
# the async bank's overlap gauge (the StepMonitor's, telemetry/monitor.py)
# and the planner's rejections (perf/planner.py)
BANK_OVERLAP_GAUGE = "bank_dispatch_overlap_fraction"
AUTOTUNE_REJECTED_COUNTER = "autotune_plan_rejected_total"
# the input pipeline
DATA_WAIT_GAUGE = "loader_wait_fraction"
DATA_SHM_SLABS_GAUGE = "loader_shm_slabs_in_use"
# the fleet family's names (not registered here: module docstring)
BARRIER_WAIT_HIST = "barrier_wait_seconds"
COLLECTIVE_WAIT_HIST = "collective_wait_seconds"
SKEW_GAUGE = "host_step_skew_fraction"
HEARTBEAT_AGE_GAUGE = "peer_heartbeat_age_seconds"
STRAGGLER_COUNTER = "straggler_suspected_total"
ALLGATHER_BYTES_COUNTER = "allgather_bytes_total"
HOST_DEVICES_GAUGE = "host_local_device_count"
# what one rank holds of the class-sharded bank and of the optimizer
# moments (perf/planner.py state_bytes_per_chip)
BANK_BYTES_GAUGE = "bank_bytes_per_chip"
OPT_BYTES_GAUGE = "opt_bytes_per_chip"


_CURRENT: Optional["TelemetrySession"] = None


def current_session() -> Optional["TelemetrySession"]:
    """The open session this process made last, or None."""
    return _CURRENT


def resolve_host() -> int:
    """This process's rank in the default process group (0 outside one, or
    when torch is not loaded): the flight recorder's rule."""
    from mgproto_tpu_torch.obs.flightrec import _rank_and_world

    return int(_rank_and_world()[0])


class TelemetrySession:
    def __init__(
        self,
        out_dir: str,
        registry: Optional[MetricRegistry] = None,
        tracer: Optional[Tracer] = None,
        primary: Optional[bool] = None,
        host: Optional[int] = None,
    ):
        self.out_dir = out_dir
        self.registry = registry if registry is not None else MetricRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self._prev_registry = set_current_registry(self.registry)
        self._prev_tracer = set_current_tracer(self.tracer)
        global _CURRENT
        self._prev_session, _CURRENT = _CURRENT, self
        self.host = resolve_host() if host is None else int(host)
        self.primary = self.host == 0 if primary is None else bool(primary)
        self.host_suffix = f".h{self.host}" if self.host > 0 else ""
        self._closed = False
        metrics_writer = health_writer = None
        if self.primary or self.host > 0:
            os.makedirs(out_dir, exist_ok=True)
            metrics_writer = JsonlWriter(os.path.join(out_dir, METRICS_FILE + self.host_suffix))
            health_writer = JsonlWriter(os.path.join(out_dir, HEALTH_FILE + self.host_suffix))
        self._metrics_writer = metrics_writer
        self.monitor = StepMonitor(registry=self.registry)
        self.health = ModelHealth(registry=self.registry, writer=health_writer)
        from mgproto_tpu_torch.online.metrics import register_online_metrics
        from mgproto_tpu_torch.resilience.metrics import register_resilience_metrics
        from mgproto_tpu_torch.trust.metrics import register_trust_metrics

        register_resilience_metrics(self.registry)
        register_online_metrics(self.registry)
        register_trust_metrics(self.registry)
        r = self.registry
        self._g_epoch_ips = r.gauge("epoch_images_per_sec_global",
                                    "whole-epoch throughput summed across hosts")
        self._g_epoch = r.gauge("epoch", "last completed epoch")
        self._g_em_active = r.gauge(EM_ACTIVE_GAUGE,
                                    "classes EM touched (epoch max of the per-step width)")
        self._g_em_active.set(0.0)
        self._c_em_fallback = r.counter(
            EM_FALLBACK_COUNTER,
            "EM calls that exceeded the compact width and ran the dense fallback branch")
        self._c_em_fallback.inc(0.0)
        r.gauge(DATA_SHM_SLABS_GAUGE,
                "shared-memory batch slabs currently held by in-flight batches").set(0.0)
        self._c_autotune_rejected = r.counter(
            AUTOTUNE_REJECTED_COUNTER,
            "auto-tuner candidate plans rejected as over the HBM budget")
        self._c_autotune_rejected.inc(0.0)
        # one card per rank
        r.gauge(HOST_DEVICES_GAUGE,
                "devices addressed by this process (per-chip normalizer for the fleet "
                "table)").set(1.0)
        self._g_bank_bytes = r.gauge(
            BANK_BYTES_GAUGE,
            "bytes of the class-sharded memory bank ONE chip holds (planner shape math; "
            "~1/model_axis as chips grow)")
        self._g_bank_bytes.set(0.0)
        self._g_opt_bytes = r.gauge(
            OPT_BYTES_GAUGE,
            "bytes of optimizer state (joint+warm+EM-mean Adam moments) ONE chip holds "
            "under the per-param sharding map")
        self._g_opt_bytes.set(0.0)

    def observe_state_bytes(self, per_chip: Dict[str, Any]) -> None:
        """Record perf/planner.py `state_bytes_per_chip`'s figures."""
        if per_chip.get("bank_bytes_per_chip") is not None:
            self._g_bank_bytes.set(float(per_chip["bank_bytes_per_chip"]))
        if per_chip.get("opt_bytes_per_chip") is not None:
            self._g_opt_bytes.set(float(per_chip["opt_bytes_per_chip"]))

    def observe_em(self, active_classes: float, compact_fallbacks: float = 0.0) -> None:
        """One epoch's EM fast-path outcome (host floats)."""
        self._g_em_active.set(float(active_classes))
        if compact_fallbacks:
            self._c_em_fallback.inc(float(compact_fallbacks))

    def observe_autotune(self, outcome) -> None:
        """Record a planner run (perf/planner.py PlanOutcome): the chosen
        plan and every candidate's peak into meta.json "autotune", the
        rejections on the counter, the chosen plan's per-rank state bytes
        on the gauges."""
        if outcome.rejected:
            self._c_autotune_rejected.inc(float(outcome.rejected))
        if outcome.chosen is not None:
            self.observe_state_bytes(outcome.chosen.to_meta())
        self.write_meta({"autotune": outcome.to_meta()})

    def write_meta(self, meta: Dict[str, Any]) -> None:
        """Merge `meta` into meta.json (rank 0 only)."""
        if not self.primary or self._closed:
            return
        path = os.path.join(self.out_dir, META_FILE)
        merged: Dict[str, Any] = {}
        try:
            with open(path) as f:
                merged = json.load(f)
        except (OSError, ValueError):
            pass
        merged.update(meta)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    # ------------------------------------------------------------------ sinks
    def flush(self, step: Optional[int] = None, extra: Optional[Dict] = None) -> None:
        """Write the registry and the trace: rank 0 the canonical files,
        rank p > 0 its `.h<p>` sidecars; a sink-less session nothing."""
        if self._metrics_writer is None or self._closed:
            return
        self.registry.write_prometheus(os.path.join(self.out_dir, PROM_FILE + self.host_suffix))
        write_jsonl_snapshot(self.registry, self._metrics_writer, step=step,
                             extra={"host": self.host, **(extra or {})})
        self.tracer.export_chrome_trace(os.path.join(self.out_dir,
                                                     TRACE_FILE + self.host_suffix))

    def end_epoch(self, state: Any, epoch: int, step: Optional[int] = None,
                  aggregate: bool = True) -> Dict[str, float]:
        """Per-epoch bookkeeping: the ModelHealth record of `state` (a
        `gmm` and a `memory` holding every class), the global throughput
        from the monitor's epoch sums (summed over the ranks when
        `aggregate`: every rank must call then), a flush, and a reset of
        the epoch sums. Returns the health scalars."""
        local_images = float(self.monitor.epoch_images)
        seconds = self.monitor.epoch_seconds
        if aggregate:
            from mgproto_tpu_torch.parallel.multihost import allgather_sum

            images = allgather_sum(local_images)
        else:
            images = local_images
        if seconds > 0:
            self._g_epoch_ips.set(images / seconds)
        self._g_epoch.set(epoch)
        health = self.health.record(state, epoch=epoch)
        self.flush(step=step, extra={"epoch": int(epoch)})
        self.monitor.begin_epoch()
        return health

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        if self._metrics_writer is not None:
            self._metrics_writer.close()
        if self.health.writer is not None:
            self.health.writer.close()
        self._closed = True
        set_current_registry(self._prev_registry)
        set_current_tracer(self._prev_tracer)
        global _CURRENT
        _CURRENT = self._prev_session


def make_session(telemetry_dir: str, enabled: bool = True, **kw) -> Optional[TelemetrySession]:
    """None when disabled: call sites guard with `if telem:`."""
    if not enabled or not telemetry_dir:
        return None
    return TelemetrySession(telemetry_dir, **kw)
