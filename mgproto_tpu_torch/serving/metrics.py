"""Serving and loader metric names and their registration (a trimmed copy
of mgproto_tpu/serving/metrics.py; imports no torch).

Every serving-path event lands in the telemetry registry
(telemetry/registry.py) as a labeled counter, gauge or histogram under the
JAX package's name: scraped as Prometheus text (the frontend's GET
/metrics), snapshotted into a telemetry directory's metrics.jsonl
(telemetry/session.py), and diffed by the autoscaler between its
evaluations. Metrics resolve through the process-current registry, which a
live TelemetrySession installs; `set_current_registry` swaps it (None
installs a fresh one: tests isolate themselves so).
`register_serving_metrics` pre-creates the serving family with zero-valued
unlabeled series, so a scrape shows "nothing happened" explicitly.
"""

from __future__ import annotations

from typing import Optional

from mgproto_tpu_torch.telemetry import registry as _registry
from mgproto_tpu_torch.telemetry.registry import (  # noqa: F401 (re-exported)
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    default_registry,
    percentile_from_buckets,
)

REQUESTS = "serving_requests_total"
REQUEST_SECONDS = "serving_request_seconds"
ABSTAIN_RATE = "serving_abstain_rate"
SHED = "serving_shed_total"
BREAKER_STATE = "serving_breaker_state"
BREAKER_TRANSITIONS = "serving_breaker_transitions_total"
FINGERPRINT_MISMATCHES = "serving_fingerprint_mismatch_total"
PRECISION_MISMATCHES = "serving_precision_mismatch_total"
QUANT_MISMATCHES = "serving_quant_mismatch_total"
QUANT_WEIGHT_BYTES = "serving_quant_weight_bytes"
DEGRADED_REQUESTS = "serving_degraded_requests_total"
DEVICE_ERRORS = "serving_device_errors_total"
BATCH_FILL = "serving_batch_fill_ratio"
BATCH_FILL_HIST = "serving_batch_fill_fraction"
# the network serving plane: batcher, replica supervisor, swap
DISPATCHES = "serving_batch_dispatch_total"
QUEUE_DEPTH = "serving_queue_depth"
REPLICA_RESTARTS = "serving_replica_restarts_total"
REPLICAS_READY = "serving_replicas_ready"
REPLICAS_TOTAL = "serving_replicas_total"
BREAKER_OPEN_FRACTION = "serving_breaker_open_fraction"
UPTIME_SECONDS = "serving_uptime_seconds"
SWAPS = "serving_swap_total"
SWAP_TRANSFERRED = "serving_swap_transferred_total"
# the request tracer's per-stage latency (obs/reqtrace.py)
STAGE_SECONDS = "serving_stage_seconds"
# names the port writes no series under (the AOT executable cache is not
# ported); `cli.telemetry summarize` reads them
AOT_HITS = "serving_aot_hit_total"
AOT_MISSES = "serving_aot_miss_total"
AOT_REJECTS = "serving_aot_reject_total"
AOT_STORES = "serving_aot_store_total"
EXPLANATIONS = "serving_explanations_total"
# the autoscaler and the tenant plane
AUTOSCALE_TARGET = "autoscale_replicas_target"
AUTOSCALE_EVENTS = "autoscale_events_total"
TENANT_REQUESTS = "tenant_requests_total"
TENANT_REQUEST_SECONDS = "tenant_request_seconds"
TENANT_SHED = "tenant_shed_total"
TENANT_MOUNTS = "tenant_mount_total"
TENANT_UNMOUNTS = "tenant_unmount_total"
TENANT_SWAPS = "tenant_swap_total"
TENANTS_MOUNTED = "tenants_mounted"
TENANT_QUEUE_DEPTH = "tenant_queue_depth"
TENANT_HEAD_BYTES = "tenant_head_bytes"
TENANT_MOUNT_SECONDS = "tenant_mount_seconds"
# the input pipeline (data/loader.py)
LOADER_RETRIES = "resilience_retries_total"  # label scope="loader"
LOADER_SENTINEL_ROWS = "loader_sentinel_rows_total"
LOADER_WORKER_RESTARTS = "loader_worker_restarts_total"
LOADER_SHM_SLABS = "loader_shm_slabs_in_use"
# the online plane (online/metrics.py registers them)
CAPTURED = "online_capture_total"
CAPTURE_EVICTED = "online_capture_evicted_total"
STAGED = "online_staged_samples"
CONSOLIDATIONS = "online_consolidation_total"
CONSOLIDATED_SAMPLES = "online_consolidated_samples_total"
CLASS_ADDITIONS = "online_class_additions_total"
ACTIVE_CLASSES = "online_active_classes"
REPUBLISH = "online_republish_total"
DRIFT_PX_DIVERGENCE = "drift_px_divergence"
DRIFT_CLASS_SHIFT = "drift_class_mean_shift"  # labeled class=<c>
DRIFT_SHIFT_MAX = "drift_class_mean_shift_max"
DRIFT_COV_SHIFT_MAX = "drift_class_cov_shift_max"
DRIFT_BREACHES = "drift_breach_total"  # labeled signal= px | bank
# the trust plane (trust/metrics.py registers them)
MATRIX_CELLS = "trust_matrix_cells_total"  # labeled kind= (ood|<corruption>)
PAIR_AUROC = "trust_pair_auroc"  # labeled pair=<ood set>
TRUST_ABSTENTION_RATE = "trust_abstention_rate"  # labeled cell=<kind:severity>
ANSWERED_ACCURACY = "trust_answered_accuracy"  # labeled cell=
PX_DIVERGENCE = "trust_px_divergence"  # served-vs-calibration sketch drift
VERDICTS = "trust_verdict_total"  # labeled result= pass | fail
INTERP_CONSISTENCY = "trust_interp_consistency"
INTERP_STABILITY = "trust_interp_stability"
INTERP_PURITY = "trust_interp_purity"

COUNTER_HELP = {
    REQUESTS: "requests by outcome (predict/abstain/reject/shed)",
    SHED: "requests shed, by reason",
    BREAKER_TRANSITIONS: "circuit breaker state transitions, by edge",
    FINGERPRINT_MISMATCHES: "calibrations refused: measured under another GMM",
    PRECISION_MISMATCHES: "calibrations refused: measured under another compute dtype",
    QUANT_MISMATCHES:
        "calibrations rejected because the served quant config (meta.json "
        "quant_config.tag) does not match the one the thresholds were "
        "measured under (perf/quant.py; int8 weight rounding moves the "
        "p(x) scale the same way a dtype change does)",
    DEGRADED_REQUESTS: "requests answered WITHOUT OoD gating (degraded mode)",
    DEVICE_ERRORS: "inference dispatches that raised a device error",
    DISPATCHES: "micro-batch dispatches by trigger (bucket_full/deadline/linger/drain)",
    REPLICA_RESTARTS: "replica drain+restart cycles by detected failure (dead/wedged)",
    SWAPS: "blue/green hot-swap attempts by result (committed/rejected)",
    SWAP_TRANSFERRED: "queued requests transferred old->new engine during a hot swap",
    EXPLANATIONS: "predict outcomes answered with a prototype explanation block",
    AUTOSCALE_EVENTS: "autoscaler scale decisions applied, by direction (up/down)",
    TENANT_REQUESTS: "requests by tenant and outcome",
    TENANT_SHED: "requests shed by tenant and reason (tenant_quota = the tenant's own tail)",
    TENANT_MOUNTS: "tenant heads mounted into the directory",
    TENANT_UNMOUNTS: "tenant heads unmounted from the directory",
    TENANT_SWAPS: "tenant-scoped head swap attempts by result (committed/rejected)",
}

GAUGE_HELP = {
    ABSTAIN_RATE: "abstain fraction over the trailing decision window",
    BREAKER_STATE: "circuit breaker state (0=closed, 0.5=half-open, 1=open)",
    BATCH_FILL: "occupied fraction of the last padded serving batch",
    QUEUE_DEPTH: "admission queue depth (per replica, and unlabeled total)",
    REPLICAS_READY: "replicas currently passing the readiness probe",
    REPLICAS_TOTAL: "replicas the supervisor is responsible for",
    BREAKER_OPEN_FRACTION: "fraction of replica-seconds spent with the breaker OPEN",
    UPTIME_SECONDS: "seconds since the replica supervisor started",
    AUTOSCALE_TARGET: "replica count the autoscaler is steering toward",
    QUANT_WEIGHT_BYTES:
        "resident backbone weight bytes of the served program under its "
        "quant config (int8 tensors + scale vectors + untouched f32 "
        "leaves; 0 = unquantized or unknown)",
    TENANTS_MOUNTED: "tenant heads currently mounted in the directory",
    TENANT_QUEUE_DEPTH: "admission-queue entries held per tenant",
    TENANT_HEAD_BYTES: "resident bytes of a tenant's mounted head",
}

# the online family's help strings (the JAX package's online/metrics.py);
# pre-created only by `online.metrics.register_online_metrics`
ONLINE_COUNTER_HELP = {
    CAPTURED: "capture-tap decisions by outcome "
              "(accepted/gate_rejected/outcome_skipped/class_unknown/labeled)",
    CAPTURE_EVICTED:
        "staged samples displaced by reservoir eviction (full class queue)",
    CONSOLIDATIONS: "background consolidation cadence firings by result",
    CONSOLIDATED_SAMPLES:
        "captured samples drained into the memory banks by consolidation",
    CLASS_ADDITIONS: "classes added online into padded class-bucket slots",
    REPUBLISH: "drift-triggered republish attempts by result "
               "(committed/rejected — rejection is the TrustGate failing "
               "closed)",
    DRIFT_BREACHES: "drift threshold breaches by signal (px/bank)",
}

ONLINE_GAUGE_HELP = {
    STAGED: "samples currently staged across all per-class capture queues",
    ACTIVE_CLASSES: "classes registered in the online class directory",
    DRIFT_PX_DIVERGENCE:
        "mean |serving-quantile - calibration-quantile| of log p(x), "
        "normalized by the calibration sketch's IQR",
    DRIFT_CLASS_SHIFT:
        "L2 shift of a class's bank mean vs the calibration-time baseline "
        "(labeled class=<c>)",
    DRIFT_SHIFT_MAX: "max per-class bank mean shift",
    DRIFT_COV_SHIFT_MAX:
        "max per-class mean absolute shift of the bank's diagonal variance",
}

# the trust family's help strings (the JAX package's trust/metrics.py);
# pre-created only by `trust.metrics.register_trust_metrics`
TRUST_COUNTER_HELP = {
    MATRIX_CELLS:
        "robustness-matrix cells evaluated through the serving path, by "
        "kind (ood pair or corruption family)",
    VERDICTS:
        "trust verdicts derived by the matrix run, by result (pass/fail) "
        "— the same derivations `mgproto-telemetry check --trust` re-runs "
        "from the committed report's raw numbers",
}

TRUST_GAUGE_HELP = {
    PAIR_AUROC:
        "per ID x OoD pair AUROC of served log p(x) (labeled pair=), "
        "measured through the CALIBRATED serving path, not a bespoke loop",
    TRUST_ABSTENTION_RATE:
        "abstain fraction of a matrix cell's typed responses (labeled "
        "cell=<kind:severity>; clean ID is cell=id:0)",
    ANSWERED_ACCURACY:
        "accuracy over PREDICT outcomes only of a matrix cell (labeled "
        "cell=) — the risk half of the risk-coverage curve",
    PX_DIVERGENCE:
        "mean |served-quantile - calibration-quantile| of clean-ID "
        "log p(x), in calibration-IQR units (the serving-path counterpart "
        "of drift_px_divergence)",
    INTERP_CONSISTENCY:
        "prototype consistency (%) from the sharded evaluator",
    INTERP_STABILITY:
        "prototype stability (%) from the sharded evaluator",
    INTERP_PURITY:
        "prototype purity mean (%) from the sharded evaluator",
}

HIST_HELP = {
    REQUEST_SECONDS: "per-request latency (admission to response), by outcome",
    BATCH_FILL_HIST: "occupied fraction of each padded serving batch (per dispatch)",
    STAGE_SECONDS: "per-request stage latency by stage (queue=admission wait + batcher linger, "
                   "device=dispatch time, total=arrival to response); populated only while "
                   "request tracing (obs/reqtrace.py) is enabled",
    TENANT_REQUEST_SECONDS: "per-request latency by tenant and outcome",
    TENANT_MOUNT_SECONDS: "seconds to mount one tenant head",
}

FILL_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
# the JAX registry's default time buckets: the autoscaler's window p99 is
# interpolated within them, so the two packages decide alike
TIME_BUCKETS = DEFAULT_TIME_BUCKETS

ALL_COUNTERS = tuple(COUNTER_HELP)
ALL_GAUGES = tuple(GAUGE_HELP)


def help_of(name: str) -> str:
    """The help string of a metric this module names ("" otherwise)."""
    for table in (COUNTER_HELP, GAUGE_HELP, HIST_HELP, ONLINE_COUNTER_HELP, ONLINE_GAUGE_HELP,
                  TRUST_COUNTER_HELP, TRUST_GAUGE_HELP):
        if name in table:
            return table[name]
    return ""


def set_current_registry(registry: Optional[MetricRegistry]) -> MetricRegistry:
    """Install `registry` (None = a fresh one) as process-current; returns
    the previous one."""
    return _registry.set_current_registry(
        registry if registry is not None else MetricRegistry())


def counter(name: str) -> Counter:
    return default_registry().counter(name, help_of(name))


def gauge(name: str) -> Gauge:
    return default_registry().gauge(name, help_of(name))


def histogram(name: str) -> Histogram:
    buckets = FILL_BUCKETS if name == BATCH_FILL_HIST else TIME_BUCKETS
    return default_registry().histogram(name, help_of(name), buckets=buckets)


def register_serving_metrics(registry: MetricRegistry) -> None:
    """Pre-create the serving family in `registry` with explicit zero-valued
    unlabeled series (JAX's names; histograms are registered name-only)."""
    for name in COUNTER_HELP:
        registry.counter(name, COUNTER_HELP[name]).inc(0.0)
    for name in GAUGE_HELP:
        registry.gauge(name, GAUGE_HELP[name]).set(0.0)
    for name in HIST_HELP:
        registry.histogram(name, HIST_HELP[name],
                           buckets=FILL_BUCKETS if name == BATCH_FILL_HIST else TIME_BUCKETS)
