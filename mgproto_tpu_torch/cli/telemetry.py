"""The telemetry command (counterpart of mgproto_tpu/cli/telemetry.py):
summarize a telemetry directory and gate records and runs.

    python -m mgproto_tpu_torch.cli.telemetry [summarize] DIR [--json]
    python -m mgproto_tpu_torch.cli.telemetry check DIR --baseline FILE
        [--write-baseline] [--json]
    python -m mgproto_tpu_torch.cli.telemetry check --trust FILE
        | --quant FILE | --drift-drill FILE
        | --stall-report FILE [--stall-baseline FILE]

`summarize` reads what a TelemetrySession wrote (telemetry/session.py):
metrics.jsonl (registry snapshots; a torn last line of a killed run is
skipped), health.jsonl, trace.json and meta.json, and renders steps (EMA,
percentiles), cold paths, EM, data, meta (the planner's plan), perf (the
newest `stall_report*.json` in the directory), resilience, drift, trust,
serving, autoscale and tenants, model health and span totals, as JAX's
does (a run's model_dir works too: its telemetry/
subdirectory). The `.h<rank>` sidecars of other ranks are left to the
fleet view, which is not ported.

`check DIR --baseline FILE` gates a run against a baseline that
`--write-baseline` froze from a known-good run (`build_baseline`,
`check_entry`, `check`; exit 1 on a regression). `--trust` re-derives a
trust-matrix report's verdicts (`trust_gates`), `--drift-drill` a drift
drill's (online/drill.py `drift_drill_gates`), `--quant` a quantized
serving record's (`quant_gates`, perf/quant.py), `--stall-report` a stall
report's (`stall_report_gates`; cli/trace_report.py writes them), alone
or against `--stall-baseline`. `--autoscale`, `--tenants`, `--weakscale`,
`--fleet-gates` and `fleet` raise NotPortedError: their producers (the
load harness, the weak-scaling bench, straggler detection) are not
ported.

Host-side: nothing here imports torch but `--quant` and `--drift-drill`,
which read their gate modules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from mgproto_tpu_torch.telemetry.registry import percentile_from_buckets
from mgproto_tpu_torch.telemetry.session import (
    AUTOTUNE_REJECTED_COUNTER,
    BANK_OVERLAP_GAUGE,
    DATA_SHM_SLABS_GAUGE,
    DATA_WAIT_GAUGE,
    EM_ACTIVE_GAUGE,
    EM_FALLBACK_COUNTER,
    HEALTH_FILE,
    HEARTBEAT_AGE_GAUGE,
    META_FILE,
    METRICS_FILE,
    PROM_FILE,
    SKEW_GAUGE,
    STRAGGLER_COUNTER,
    TRACE_FILE,
)

REFUSED_LABEL = "A9 (obs and telemetry)"
# the JAX command's gate files whose producers the port lacks: parsed, then
# refused
OTHER_GATES = ("autoscale", "tenants", "weakscale")


def _refuse(what: str):
    from mgproto_tpu_torch.cli.common import NotPortedError

    raise NotPortedError(f"{what} is not ported: the port has no producer of its input; "
                         f"ROADMAP {REFUSED_LABEL}, item 7")


STEP_PERCENTILES = (50.0, 90.0, 99.0)

# the health keys whose first->last trajectory the table shows
HEALTH_TRAJECTORY_KEYS = (
    "prior_entropy_mean",
    "min_interproto_dist",
    "collapse_frac",
    "memory_occupancy",
)


def _is_telemetry_dir(path: str) -> bool:
    """True when `path` holds TelemetrySession artifacts. A run's model_dir
    ALSO contains a metrics.jsonl (the MetricsWriter train-metrics stream,
    one scalar dict per step — no "metrics" key), so the jsonl name alone
    cannot identify a telemetry dir: check the unambiguous artifacts first,
    then the shape of the first parseable jsonl record."""
    for name in (PROM_FILE, HEALTH_FILE, TRACE_FILE):
        if os.path.isfile(os.path.join(path, name)):
            return True
    m = os.path.join(path, METRICS_FILE)
    if os.path.isfile(m):
        with open(m) as f:
            for line in f:
                try:
                    return "metrics" in json.loads(line)
                except ValueError:
                    continue
    return False


def resolve_dir(path: str) -> str:
    """Accept a telemetry dir directly or a run dir containing telemetry/."""
    if _is_telemetry_dir(path):
        return path
    sub = os.path.join(path, "telemetry")
    if os.path.isdir(sub):
        return sub
    return path


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    if not os.path.isfile(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # a torn tail line (killed run) is not an error
    return out


def _series_value(snapshot: Dict, name: str, default=None):
    """Latest-snapshot scalar: sums counters across label sets, takes the
    max-labeled single series otherwise (phase-labeled gauges have one)."""
    m = snapshot.get(name)
    if not m or not m.get("series"):
        return default
    vals = [s.get("value") for s in m["series"] if s.get("value") is not None]
    if not vals:
        return default
    if m.get("type") == "counter":
        return sum(vals)
    return vals[-1]


def _hist_series(snapshot: Dict, name: str) -> Optional[Dict]:
    """Merge a histogram's label series into one (same bounds by construction)."""
    m = snapshot.get(name)
    if not m or m.get("type") != "histogram" or not m.get("series"):
        return None
    merged: Optional[Dict[str, Any]] = None
    for s in m["series"]:
        if merged is None:
            merged = {
                "bounds": list(s["bounds"]),
                "bucket_counts": list(s["bucket_counts"]),
                "count": s["count"],
                "sum": s["sum"],
                "min": s["min"],
                "max": s["max"],
            }
        else:
            merged["bucket_counts"] = [
                a + b
                for a, b in zip(merged["bucket_counts"], s["bucket_counts"])
            ]
            merged["count"] += s["count"]
            merged["sum"] += s["sum"]
            for k, pick in (("min", min), ("max", max)):
                if s[k] is not None:
                    merged[k] = (
                        s[k] if merged[k] is None else pick(merged[k], s[k])
                    )
    return merged


def _series_by_label(
    snapshot: Dict, name: str, label_key: str
) -> Dict[str, float]:
    """Counter value per label (e.g. requests by outcome)."""
    m = snapshot.get(name)
    out: Dict[str, float] = {}
    if not m:
        return out
    for s in m.get("series", []):
        v = s.get("value")
        if v is None:
            continue
        key = s.get("labels", {}).get(label_key)
        if key is not None:
            out[key] = out.get(key, 0.0) + v
    return out


def _unlabeled_value(snapshot: Dict, name: str, default=None):
    """The explicitly-unlabeled series of a gauge that ALSO carries labeled
    series (e.g. serving_queue_depth: per-replica labels + the fleet total
    unlabeled) — _series_value's last-series pick would return whichever
    replica happened to flush last. Falls back to the labeled sum."""
    m = snapshot.get(name)
    if not m or not m.get("series"):
        return default
    labeled = []
    for s in m["series"]:
        if s.get("value") is None:
            continue
        if not s.get("labels"):
            return s["value"]
        labeled.append(s["value"])
    return sum(labeled) if labeled else default


def _stage_latency_section(
    snapshot: Dict, name: str
) -> Dict[str, Dict[str, float]]:
    """p50/p99/mean per `stage` label of the request-stage histogram."""
    m = snapshot.get(name)
    out: Dict[str, Dict[str, float]] = {}
    if not m or m.get("type") != "histogram":
        return out
    for s in m.get("series", []):
        stage = s.get("labels", {}).get("stage")
        if stage is None or not s.get("count"):
            continue
        out[stage] = {
            "count": s["count"],
            "mean": s["sum"] / s["count"],
            "p50": percentile_from_buckets(s, 50.0),
            "p99": percentile_from_buckets(s, 99.0),
        }
    return out


def _serving_section(last: Dict) -> Optional[Dict[str, Any]]:
    """Serving story: outcomes, PER-REASON shed counts (queue_full vs
    deadline vs shutdown...), latency percentiles, trust + breaker state
    including the open-time fraction, micro-batch fill histogram, replica
    supervision and hot-swap counters (None when this run never served —
    training-only telemetry)."""
    from mgproto_tpu_torch.serving import metrics as sm

    if not any(name in last for name in sm.ALL_COUNTERS):
        return None
    section: Dict[str, Any] = {
        "requests_by_outcome": _series_by_label(
            last, sm.REQUESTS, "outcome"
        ),
        "shed_by_reason": _series_by_label(last, sm.SHED, "reason"),
        "abstain_rate": _series_value(last, sm.ABSTAIN_RATE),
        "degraded_requests": _series_value(last, sm.DEGRADED_REQUESTS),
        "fingerprint_mismatches": _series_value(
            last, sm.FINGERPRINT_MISMATCHES
        ),
        # quantized serving: the mismatch counter is pre-
        # registered (explicit 0 = "no artifact/calibration quant skew"),
        # the weight-bytes gauge is nonzero only under a quantized artifact
        "quant_mismatches": _series_value(last, sm.QUANT_MISMATCHES),
        "quant_weight_bytes": _series_value(last, sm.QUANT_WEIGHT_BYTES),
        "device_errors": _series_value(last, sm.DEVICE_ERRORS),
        "breaker_state": _series_value(last, sm.BREAKER_STATE),
        "breaker_transitions": _series_by_label(
            last, sm.BREAKER_TRANSITIONS, "edge"
        ),
        "breaker_open_time_fraction": _series_value(
            last, sm.BREAKER_OPEN_FRACTION
        ),
    }
    hist = _hist_series(last, sm.REQUEST_SECONDS)
    if hist and hist["count"]:
        section["request_mean_seconds"] = hist["sum"] / hist["count"]
        for p in STEP_PERCENTILES:
            section[f"request_p{p:g}_seconds"] = percentile_from_buckets(
                hist, p
            )
        section["request_max_seconds"] = hist["max"]
    # per-stage request latency (obs/reqtrace.py: queue / device / total),
    # present only when request tracing ran
    stages = _stage_latency_section(last, sm.STAGE_SECONDS)
    if stages:
        section["stage_seconds"] = stages
    fill = _hist_series(last, sm.BATCH_FILL_HIST)
    if fill and fill["count"]:
        section["batch_fill"] = {
            "dispatches": fill["count"],
            "mean": fill["sum"] / fill["count"],
            "p50": percentile_from_buckets(fill, 50.0),
            "p90": percentile_from_buckets(fill, 90.0),
            "min": fill["min"],
        }
    # network-plane story, present only when the plane ran
    plane = {
        "dispatches_by_trigger": _series_by_label(
            last, sm.DISPATCHES, "trigger"
        ),
        "replica_restarts": _series_by_label(
            last, sm.REPLICA_RESTARTS, "reason"
        ),
        "replicas_ready": _series_value(last, sm.REPLICAS_READY),
        "replicas_total": _series_value(last, sm.REPLICAS_TOTAL),
        "queue_depth": _unlabeled_value(last, sm.QUEUE_DEPTH),
        "swaps_by_result": _series_by_label(last, sm.SWAPS, "result"),
        "swap_transferred": _series_value(last, sm.SWAP_TRANSFERRED),
    }
    for key, value in plane.items():
        if value not in (None, {}):
            section[key] = value
    return section


def _autoscale_section(last: Dict) -> Optional[Dict[str, Any]]:
    """Elastic-serving story: autoscaler decisions + the AOT
    executable cache's hit/miss/reject ledger. Present whenever the
    serving family is (pre-registered — explicit zeros mean "fixed fleet,
    cold compiles", which an operator should see, not infer); None only
    for telemetry dirs that never served."""
    from mgproto_tpu_torch.serving import metrics as sm

    names = (
        sm.AUTOSCALE_TARGET, sm.AUTOSCALE_EVENTS,
        sm.AOT_HITS, sm.AOT_MISSES, sm.AOT_REJECTS,
    )
    if not any(name in last for name in names):
        return None
    return {
        "replicas_target": _series_value(last, sm.AUTOSCALE_TARGET),
        "events_by_direction": _series_by_label(
            last, sm.AUTOSCALE_EVENTS, "direction"
        ),
        "aot_hits": _series_value(last, sm.AOT_HITS),
        "aot_misses": _series_value(last, sm.AOT_MISSES),
        "aot_rejects_by_reason": _series_by_label(
            last, sm.AOT_REJECTS, "reason"
        ),
        "aot_stores_by_result": _series_by_label(
            last, sm.AOT_STORES, "result"
        ),
    }


def _tenant_nested(
    snapshot: Dict, name: str, inner_key: str
) -> Dict[str, Dict[str, float]]:
    """{tenant: {inner_label: count}} for a tenant-labeled counter."""
    out: Dict[str, Dict[str, float]] = {}
    for s in snapshot.get(name, {}).get("series", []):
        labels = s.get("labels", {})
        t, k = labels.get("tenant"), labels.get(inner_key)
        if t is not None and k is not None and s.get("value"):
            row = out.setdefault(t, {})
            row[k] = row.get(k, 0.0) + s["value"]
    return out


def _tenants_section(last: Dict) -> Optional[Dict[str, Any]]:
    """Multi-tenant serving story: heads mounted on the shared
    trunk, per-tenant request/shed/swap ledgers, head bytes, per-tenant
    latency. The family is pre-registered, so presence alone says nothing;
    the section renders only once a tenant has actually mounted or served
    — a single-tenant fleet stays a single-tenant summary."""
    from mgproto_tpu_torch.serving import metrics as sm

    names = (
        sm.TENANTS_MOUNTED, sm.TENANT_MOUNTS, sm.TENANT_REQUESTS,
        sm.TENANT_SHED, sm.TENANT_SWAPS, sm.TENANT_HEAD_BYTES,
    )
    if not any(name in last for name in names):
        return None
    mounted = _series_value(last, sm.TENANTS_MOUNTED)
    mount_total = _series_value(last, sm.TENANT_MOUNTS)
    requests = _series_by_label(last, sm.TENANT_REQUESTS, "tenant")
    if not (mounted or mount_total or requests):
        return None
    head_bytes: Dict[str, float] = {}
    for s in last.get(sm.TENANT_HEAD_BYTES, {}).get("series", []):
        t = s.get("labels", {}).get("tenant")
        if t is not None and s.get("value") is not None:
            head_bytes[t] = s["value"]
    latency: Dict[str, Dict[str, Any]] = {}
    for s in last.get(sm.TENANT_REQUEST_SECONDS, {}).get("series", []):
        t = s.get("labels", {}).get("tenant")
        if t is None or not s.get("count"):
            continue
        row = latency.get(t)
        if row is None:
            latency[t] = {
                "bounds": list(s["bounds"]),
                "bucket_counts": list(s["bucket_counts"]),
                "count": s["count"],
                "sum": s["sum"],
                "min": s["min"],
                "max": s["max"],
            }
        else:
            row["bucket_counts"] = [
                a + b for a, b in
                zip(row["bucket_counts"], s["bucket_counts"])
            ]
            row["count"] += s["count"]
            row["sum"] += s["sum"]
            for k, pick in (("min", min), ("max", max)):
                if s[k] is not None:
                    row[k] = (
                        s[k] if row[k] is None else pick(row[k], s[k])
                    )
    latency_ms = {
        t: {
            "count": row["count"],
            "mean_ms": round(1e3 * row["sum"] / row["count"], 3),
            "p99_ms": round(
                1e3 * percentile_from_buckets(row, 99.0), 3
            ),
        }
        for t, row in latency.items()
    }
    try:
        from mgproto_tpu_torch.online import metrics as om

        drift_breaches = _series_by_label(
            last, om.DRIFT_BREACHES, "tenant"
        )
    except Exception:
        drift_breaches = {}
    return {
        "mounted": mounted,
        "mount_total": mount_total,
        "unmount_total": _series_value(last, sm.TENANT_UNMOUNTS),
        "requests_by_tenant": requests,
        "outcomes_by_tenant": _tenant_nested(
            last, sm.TENANT_REQUESTS, "outcome"
        ),
        "shed_by_tenant": _tenant_nested(last, sm.TENANT_SHED, "reason"),
        "swaps_by_tenant": _tenant_nested(last, sm.TENANT_SWAPS, "result"),
        "head_bytes_by_tenant": head_bytes,
        "latency_by_tenant": latency_ms,
        "drift_breaches_by_tenant": drift_breaches,
    }


def _drift_section(last: Dict) -> Optional[Dict[str, Any]]:
    """Online-learning drift story: p(x) sketch divergence,
    per-class bank shift top-k, captures by outcome, consolidation +
    republish counts. Follows the resilience-section convention: the
    family is pre-registered by every TelemetrySession, so current runs
    always render it (all zeros = "no drift observed", which an operator
    should see, not infer); None only for pre-online telemetry dirs whose
    snapshots predate the family."""
    from mgproto_tpu_torch.online import metrics as om

    if not any(
        name in last for name in om.ALL_COUNTERS + om.ALL_GAUGES
    ):
        return None
    # per-class shift top-k from the labeled gauge series
    shifts = []
    for s in last.get(om.DRIFT_CLASS_SHIFT, {}).get("series", []):
        cls = s.get("labels", {}).get("class")
        if cls is not None and s.get("value") is not None:
            shifts.append((cls, s["value"]))
    shifts.sort(key=lambda kv: -kv[1])
    section: Dict[str, Any] = {
        "px_divergence": _series_value(last, om.DRIFT_PX_DIVERGENCE),
        "mean_shift_max": _series_value(last, om.DRIFT_SHIFT_MAX),
        "cov_shift_max": _series_value(last, om.DRIFT_COV_SHIFT_MAX),
        "class_shift_topk": {cls: v for cls, v in shifts[:5]},
        "breaches_by_signal": _series_by_label(
            last, om.DRIFT_BREACHES, "signal"
        ),
        "captures_by_outcome": _series_by_label(
            last, om.CAPTURED, "outcome"
        ),
        "capture_evicted": _series_value(last, om.CAPTURE_EVICTED),
        "staged_samples": _series_value(last, om.STAGED),
        "consolidations_by_result": _series_by_label(
            last, om.CONSOLIDATIONS, "result"
        ),
        "consolidated_samples": _series_value(
            last, om.CONSOLIDATED_SAMPLES
        ),
        "class_additions": _series_value(last, om.CLASS_ADDITIONS),
        "active_classes": _series_value(last, om.ACTIVE_CLASSES),
        "republish_by_result": _series_by_label(
            last, om.REPUBLISH, "result"
        ),
    }
    return section


def _trust_section(last: Dict, d: str) -> Optional[Dict[str, Any]]:
    """Trust-verification story: matrix cells evaluated,
    per-pair AUROC, per-cell abstention/answered-accuracy extremes,
    calibration drift on the served sketch, sharded interpretability
    metric values, and the newest trust_report*.json's verdict tally.
    Present whenever the trust_* family is in the snapshot (pre-registered
    — explicit zeros mean "nothing verified this run", which an operator
    should see); None only for pre-trust telemetry dirs."""
    from mgproto_tpu_torch.trust import metrics as tm

    if not any(
        name in last for name in tm.ALL_COUNTERS + tm.ALL_GAUGES
    ):
        return None
    aurocs = _series_by_label(last, tm.PAIR_AUROC, "pair")
    abst = _series_by_label(last, tm.ABSTENTION_RATE, "cell")
    acc = _series_by_label(last, tm.ANSWERED_ACCURACY, "cell")
    section: Dict[str, Any] = {
        "cells_by_kind": _series_by_label(last, tm.MATRIX_CELLS, "kind"),
        "pair_auroc": aurocs,
        "min_pair_auroc": min(aurocs.values()) if aurocs else None,
        "max_abstention_rate": max(abst.values()) if abst else None,
        "min_answered_accuracy": min(acc.values()) if acc else None,
        "px_divergence": _series_value(last, tm.PX_DIVERGENCE),
        "verdicts": _series_by_label(last, tm.VERDICTS, "result"),
        "interp_consistency": _series_value(last, tm.INTERP_CONSISTENCY),
        "interp_stability": _series_value(last, tm.INTERP_STABILITY),
        "interp_purity": _series_value(last, tm.INTERP_PURITY),
    }
    # the newest trust report living beside the metrics, reduced to its
    # verdict line (full rows stay in the report file / check --trust)
    import glob as _glob

    reports = sorted(
        _glob.glob(os.path.join(d, "trust_report*.json")),
        key=os.path.getmtime,
    )
    if reports:
        try:
            with open(reports[-1]) as f:
                rep = json.load(f)
        except (OSError, ValueError):
            rep = None
        if rep and rep.get("trust_report"):
            gates = rep.get("gates") or {}
            section["report"] = os.path.basename(reports[-1])
            section["report_gates"] = {
                "checked": gates.get("checked"),
                "failed": gates.get("failed"),
                "ok": gates.get("ok"),
            }
    return section



def summarize(telemetry_dir: str) -> Dict[str, Any]:
    """The whole summary as one JSON-able dict."""
    d = resolve_dir(telemetry_dir)
    snapshots = _read_jsonl(os.path.join(d, METRICS_FILE))
    health = _read_jsonl(os.path.join(d, HEALTH_FILE))
    last = snapshots[-1].get("metrics", {}) if snapshots else {}

    summary: Dict[str, Any] = {
        "telemetry_dir": os.path.abspath(d),
        "snapshots": len(snapshots),
        "artifacts": {
            name: os.path.isfile(os.path.join(d, name))
            for name in (METRICS_FILE, HEALTH_FILE, TRACE_FILE, PROM_FILE)
        },
    }

    steps: Dict[str, Any] = {
        "steps_total": _series_value(last, "steps_total"),
        "images_total": _series_value(last, "images_total"),
        "step_time_ema_seconds": _series_value(last, "step_time_ema_seconds"),
        "images_per_sec": _series_value(last, "images_per_sec"),
        "epoch_images_per_sec_global": _series_value(
            last, "epoch_images_per_sec_global"
        ),
        "host_transfer_bytes_total": _series_value(
            last, "host_transfer_bytes_total"
        ),
    }
    hist = _hist_series(last, "step_time_seconds")
    if hist:
        steps["step_time_mean_seconds"] = (
            hist["sum"] / hist["count"] if hist["count"] else None
        )
        for p in STEP_PERCENTILES:
            steps[f"step_time_p{p:g}_seconds"] = percentile_from_buckets(
                hist, p
            )
        steps["step_time_max_seconds"] = hist["max"]
    summary["steps"] = steps

    summary["recompiles"] = {
        "jit_recompiles_total": _series_value(last, "jit_recompiles_total"),
        "jit_cache_size": _series_value(last, "jit_cache_size"),
    }

    # EM fast path (compact dirty-class slab, core/em.py): how wide EM ran,
    # whether it ever overflowed the compact width into the dense branch,
    # how much of the epoch the async bank pipeline actually overlapped,
    # and whether the auto-tuner rejected over-budget plans on the way in
    em = {
        EM_ACTIVE_GAUGE: _series_value(last, EM_ACTIVE_GAUGE),
        EM_FALLBACK_COUNTER: _series_value(last, EM_FALLBACK_COUNTER),
        BANK_OVERLAP_GAUGE: _series_value(last, BANK_OVERLAP_GAUGE),
        AUTOTUNE_REJECTED_COUNTER: _series_value(
            last, AUTOTUNE_REJECTED_COUNTER
        ),
    }
    if any(v is not None for v in em.values()):
        summary["em"] = em

    # input pipeline: was the run input-bound, and did
    # the shm batch assembly / u8 wire carry it (wire dtype is in meta)
    data = {
        DATA_WAIT_GAUGE: _series_value(last, DATA_WAIT_GAUGE),
        DATA_SHM_SLABS_GAUGE: _series_value(last, DATA_SHM_SLABS_GAUGE),
        "host_transfer_bytes_total": _series_value(
            last, "host_transfer_bytes_total"
        ),
        "loader_sentinel_rows_total": _series_value(
            last, "loader_sentinel_rows_total"
        ),
    }
    if any(v is not None for v in data.values()):
        summary["data"] = data

    meta_path = os.path.join(d, META_FILE)
    if os.path.isfile(meta_path):
        try:
            with open(meta_path) as f:
                summary["meta"] = json.load(f)
        except ValueError:
            pass

    # perf: the newest stall-budget report in the dir (cli/trace_report.py
    # --out, or copied in beside the metrics): its buckets and byte-ranked
    # movers ride into the one-pager next to the throughput they explain
    perf = _perf_section(d)
    if perf is not None:
        summary["perf"] = perf

    # recovery events (resilience subsystem): retries, sentinel rows,
    # skipped non-finite steps, rollbacks, preemption saves, chaos faults
    from mgproto_tpu_torch.resilience.metrics import ALL_COUNTERS

    resilience = {
        name: _series_value(last, name)
        for name in ALL_COUNTERS
    }
    # fleet health: heartbeat decay is visible here BEFORE a
    # barrier timeout kills the run, next to the skew/straggler story
    resilience[HEARTBEAT_AGE_GAUGE] = _series_value(last, HEARTBEAT_AGE_GAUGE)
    resilience[SKEW_GAUGE] = _series_value(last, SKEW_GAUGE)
    resilience[STRAGGLER_COUNTER] = _series_value(last, STRAGGLER_COUNTER)
    if any(v is not None for v in resilience.values()):
        summary["resilience"] = resilience

    serving = _serving_section(last)
    if serving is not None:
        summary["serving"] = serving

    autoscale = _autoscale_section(last)
    if autoscale is not None:
        summary["autoscale"] = autoscale

    tenants = _tenants_section(last)
    if tenants is not None:
        summary["tenants"] = tenants

    drift = _drift_section(last)
    if drift is not None:
        summary["drift"] = drift

    trust = _trust_section(last, d)
    if trust is not None:
        summary["trust"] = trust

    if health:
        traj = {}
        for key in HEALTH_TRAJECTORY_KEYS:
            vals = [r[key] for r in health if key in r]
            if vals:
                traj[key] = {"first": vals[0], "last": vals[-1]}
        summary["health"] = {
            "records": len(health),
            "first_epoch": health[0].get("epoch"),
            "last_epoch": health[-1].get("epoch"),
            "trajectory": traj,
            "last": {
                k: v
                for k, v in health[-1].items()
                if isinstance(v, (int, float)) and k not in ("time", "epoch")
            },
        }

    trace_path = os.path.join(d, TRACE_FILE)
    if os.path.isfile(trace_path):
        try:
            with open(trace_path) as f:
                events = json.load(f).get("traceEvents", [])
        except ValueError:
            events = None
        if events is not None:
            per_name: Dict[str, Dict[str, float]] = {}
            for e in events:
                s = per_name.setdefault(
                    e.get("name", "?"), {"count": 0, "total_s": 0.0}
                )
                s["count"] += 1
                s["total_s"] += e.get("dur", 0.0) / 1e6
            summary["spans"] = {
                name: {"count": s["count"], "total_s": round(s["total_s"], 4)}
                for name, s in sorted(
                    per_name.items(), key=lambda kv: -kv[1]["total_s"]
                )
            }
    return summary



def _perf_section(d: str) -> Optional[Dict[str, Any]]:
    """The newest `stall_report*.json` in the telemetry dir, reduced to the
    summarize one-pager: bucket fractions, MFU line items, byte source and
    the top byte movers (full rows stay in the report file / --json)."""
    import glob as _glob

    candidates = sorted(
        _glob.glob(os.path.join(d, "stall_report*.json")),
        key=os.path.getmtime,
    )
    if not candidates:
        return None
    path = candidates[-1]
    try:
        with open(path) as f:
            rep = json.load(f)
    except (OSError, ValueError):
        return None
    if not rep.get("stall_report"):
        return None
    out: Dict[str, Any] = {
        "stall_report": os.path.basename(path),
        "source": rep.get("source"),
        "byte_source": rep.get("byte_source"),
        "compute_dtype": rep.get("compute_dtype"),
        "step_time_s": rep.get("step_time_s"),
        "measured_mfu": rep.get("measured_mfu"),
        "attainable_mfu": rep.get("attainable_mfu"),
        "bytes_accessed": rep.get("bytes_accessed"),
    }
    for name, b in (rep.get("buckets") or {}).items():
        out[f"{name}_fraction"] = (b or {}).get("fraction")
    movers = (rep.get("top_byte_movers") or {}).get("rows") or []
    out["top_byte_movers"] = [
        {
            "name": r.get("name"),
            "bucket": r.get("bucket"),
            "bytes_accessed": r.get("bytes_accessed"),
            "bytes_fraction": r.get("bytes_fraction"),
        }
        for r in movers[:5]
    ]
    return out


def _fmt_gb(v: Any) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    return f"{v / 1e9:.2f}GB"


def _fmt_autotune(v: Dict[str, Any]) -> str:
    """One line for the meta table: the chosen plan, its predicted peak vs
    the budget, and the rejection count (full record stays in --json)."""
    plan = v.get("plan") or {}
    per_chip = ""
    if plan.get("bank_bytes_per_chip") is not None:
        per_chip = (
            f" bank/chip={_fmt_gb(plan.get('bank_bytes_per_chip'))}"
            f" opt/chip={_fmt_gb(plan.get('opt_bytes_per_chip'))}"
        )
    return (
        f"plan={plan.get('name', 'none')} "
        f"peak={_fmt_gb(plan.get('peak_bytes'))} "
        f"budget={_fmt_gb(v.get('budget_bytes'))} "
        f"margin={v.get('margin')} "
        f"rejected={v.get('rejected')}" + per_chip
    )


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        if v != 0 and (abs(v) < 1e-3 or abs(v) >= 1e6):
            return f"{v:.3e}"
        return f"{v:.4f}".rstrip("0").rstrip(".")
    return str(v)


def render_table(summary: Dict[str, Any]) -> str:
    rows: List = []

    def section(title: str):
        rows.append(None)
        rows.append((title, ""))

    rows.append(("telemetry dir", summary["telemetry_dir"]))
    rows.append(("snapshots", summary["snapshots"]))
    rows.append((
        "artifacts",
        " ".join(
            f"{n}{'' if ok else '(missing)'}"
            for n, ok in summary["artifacts"].items()
        ),
    ))

    section("steps")
    for k, v in summary.get("steps", {}).items():
        rows.append((k, v))
    section("recompiles")
    for k, v in summary.get("recompiles", {}).items():
        rows.append((k, v))
    if "em" in summary:
        section("em (compact dirty-class fast path)")
        for k, v in summary["em"].items():
            rows.append((k, v))
    if "data" in summary:
        section("data (input pipeline)")
        for k, v in summary["data"].items():
            rows.append((k, v))
    if "meta" in summary:
        section("meta")
        for k, v in sorted(summary["meta"].items()):
            if k == "autotune" and isinstance(v, dict):
                v = _fmt_autotune(v)
            rows.append((k, v))
    if "perf" in summary:
        section("perf (stall attribution + byte-ranked fusion targets)")
        for k, v in summary["perf"].items():
            if k == "top_byte_movers":
                for i, r in enumerate(v):
                    frac = r.get("bytes_fraction")
                    rows.append((
                        f"byte_mover_{i + 1}",
                        f"{r.get('name')} "
                        f"[{_fmt_gb(r.get('bytes_accessed'))}"
                        + (f", {frac:.1%} of step bytes]"
                           if isinstance(frac, float) else "]"),
                    ))
            else:
                rows.append((k, v))
    if "resilience" in summary:
        section("resilience (recovery events)")
        for k, v in summary["resilience"].items():
            rows.append((k, v))
    if "drift" in summary:
        section("drift (online learning)")
        for k, v in summary["drift"].items():
            if isinstance(v, dict):
                v = " ".join(
                    f"{kk}={_fmt(vv)}" for kk, vv in sorted(v.items())
                ) or "-"
            rows.append((k, v))
    if "trust" in summary:
        section("trust (robustness matrix + sharded interpretability)")
        for k, v in summary["trust"].items():
            if isinstance(v, dict):
                v = " ".join(
                    f"{kk}={_fmt(vv)}" for kk, vv in sorted(v.items())
                ) or "-"
            rows.append((k, v))
    if "autoscale" in summary:
        section("autoscale (elastic serving + AOT cache)")
        for k, v in summary["autoscale"].items():
            if isinstance(v, dict):
                v = " ".join(
                    f"{kk}={_fmt(vv)}" for kk, vv in sorted(v.items())
                ) or "-"
            rows.append((k, v))
    if "serving" in summary:
        section("serving")
        for k, v in summary["serving"].items():
            if isinstance(v, dict):
                parts = []
                for kk, vv in sorted(v.items()):
                    if isinstance(vv, dict):  # e.g. stage_seconds per stage
                        inner = ",".join(
                            f"{ik}={_fmt(iv)}" for ik, iv in sorted(vv.items())
                        )
                        parts.append(f"{kk}({inner})")
                    else:
                        parts.append(f"{kk}={_fmt(vv)}")
                v = " ".join(parts) or "-"
            rows.append((k, v))
    if "health" in summary:
        h = summary["health"]
        section(
            f"model health ({h['records']} records, epochs "
            f"{h.get('first_epoch')}..{h.get('last_epoch')})"
        )
        for k, t in h["trajectory"].items():
            rows.append((k, f"{_fmt(t['first'])} -> {_fmt(t['last'])}"))
        for k, v in h["last"].items():
            if k not in h["trajectory"]:
                rows.append((k, v))
    if "spans" in summary:
        section("tracing spans (total wall seconds)")
        for name, s in list(summary["spans"].items())[:12]:
            rows.append((name, f"{s['total_s']} ({s['count']}x)"))

    width = max(len(str(r[0])) for r in rows if r is not None)
    lines = []
    for r in rows:
        if r is None:
            lines.append("")
        else:
            k, v = r
            lines.append(f"{str(k):<{width}}  {_fmt(v)}" if v != "" else str(k))
    return "\n".join(lines)


# ----------------------------------------------------------------- fleet view
# `mgproto-telemetry fleet <dir>`: the pod-scale counterpart of summarize.
# Host 0 writes the canonical metrics.jsonl; every other process writes a
# `.h<pid>` sidecar into the SAME (shared-FS) telemetry dir. The fleet view
# joins them into one per-host table plus the aggregates ROADMAP item 1's
# weak-scaling runs are read through: who is slowest, how skewed are
# arrivals, how much barrier wait each host pays, and whether per-chip


DEFAULT_GATES = (
    ("steps.images_per_sec", "higher", 0.20),
    ("steps.step_time_ema_seconds", "lower", 0.25),
    ("steps.step_time_p99_seconds", "lower", 0.30),
    ("recompiles.jit_recompiles_total", "lower", 0.0),
    ("serving.request_p99_seconds", "lower", 0.30),
    ("serving.breaker_open_time_fraction", "lower", 0.0),
)


def _lookup(summary: Dict[str, Any], dotted: str):
    node: Any = summary
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def build_baseline(summary: Dict[str, Any], gates=None) -> Dict[str, Any]:
    """A baseline record from a known-good run's summary: every gate whose
    key holds a number, frozen with its direction + band. Gate specs are
    (key, direction, rel_tol[, abs_tol]) tuples."""
    entries = []
    for spec in (DEFAULT_GATES if gates is None else gates):
        key, direction, rel_tol = spec[0], spec[1], spec[2]
        abs_tol = spec[3] if len(spec) > 3 else 0.0
        value = _lookup(summary, key)
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        entries.append({
            "key": key,
            "value": float(value),
            "direction": direction,
            "rel_tol": rel_tol,
            "abs_tol": abs_tol,
        })
    return {
        "telemetry_check_baseline": True,
        "telemetry_dir": summary.get("telemetry_dir"),
        "entries": entries,
    }


def check_entry(entry: Dict[str, Any], summary: Dict[str, Any]) -> Dict:
    """One gate: {key, baseline, value, allowed, ok, why}."""
    key = entry["key"]
    base = float(entry["value"])
    direction = entry.get("direction", "lower")
    rel = float(entry.get("rel_tol", 0.0))
    abs_tol = float(entry.get("abs_tol", 0.0))
    value = _lookup(summary, key)
    row = {"key": key, "baseline": base, "value": value,
           "direction": direction}
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        row.update(ok=False, why="metric missing from run summary")
        return row
    value = float(value)
    if direction == "higher":
        allowed = base * (1.0 - rel) - abs_tol
        ok = value >= allowed
        why = "" if ok else f"{value:.6g} < allowed {allowed:.6g}"
    elif direction == "lower":
        allowed = base * (1.0 + rel) + abs_tol
        ok = value <= allowed
        why = "" if ok else f"{value:.6g} > allowed {allowed:.6g}"
    elif direction == "equal":
        allowed = abs(base) * rel + abs_tol
        ok = abs(value - base) <= allowed
        why = "" if ok else f"|{value:.6g} - {base:.6g}| > {allowed:.6g}"
    else:
        row.update(ok=False, why=f"unknown direction {direction!r}")
        return row
    row.update(allowed=allowed, ok=ok, why=why)
    return row


def check(summary: Dict[str, Any], baseline: Dict[str, Any]) -> Dict:
    """Every baseline entry checked; {'ok': bool, 'rows': [...]}."""
    entries = baseline.get("entries", [])
    rows = [check_entry(e, summary) for e in entries]
    return {"ok": all(r["ok"] for r in rows), "checked": len(rows),
            "failed": sum(not r["ok"] for r in rows), "rows": rows}



def trust_gates(record: Dict[str, Any]) -> Dict[str, Any]:
    """Gate a trust-matrix report, re-derived from its RAW numbers (outcome
    counts, correct-on-answered counts, per-sample served scores), never
    from its stored rates or AUROCs:

      * every ID x OoD pair's AUROC re-derived from the raw scores matches
        the recorded value (tamper bound) and clears the report's floor;
      * OoD traffic abstains at least as often as clean ID, per pair;
      * along every corruption family's ladder, abstention rises
        monotonically (within monotone_tol) and ends at or above the
        clean-ID rate;
      * accuracy over answered outcomes holds above the floor at every
        severity (vacuously at full abstention);
      * the clean-ID served-score sketch sits on the calibration's (px
        divergence under the limit);
      * zero dropped requests, zero steady-state recompiles, not degraded."""
    from mgproto_tpu_torch.trust.auroc import binary_auroc

    rows: List[Dict[str, Any]] = []

    def gate(key, ok, why="", baseline_v=None, value=None):
        rows.append({"key": key, "ok": bool(ok), "why": "" if ok else why,
                     "baseline": baseline_v, "value": value, "direction": "trust"})

    def abstain_rate(cell) -> Optional[float]:
        """Abstention over the gated outcomes, from the raw counts."""
        oc = cell.get("outcomes") or {}
        gated = (oc.get("predict") or 0) + (oc.get("abstain") or 0)
        return (oc.get("abstain") or 0) / gated if gated else None

    cfg = record.get("config") or {}
    gate("trust.schema",
         bool(record.get("trust_report")) and bool(record.get("id"))
         and bool(record.get("pairs")) and bool(record.get("ladder")),
         "not a trust report (missing trust_report/id/pairs/ladder)")
    gate("trust.zero_steady_recompiles", record.get("steady_state_recompiles") == 0,
         f"serving recompiled in steady state: {record.get('steady_state_recompiles')}")
    gate("trust.not_degraded", record.get("degraded") is False,
         "engine served in degraded mode — the matrix measured an ungated path")

    # zero dropped: every cell answered exactly what was submitted
    dropped = []
    id_cell = record.get("id") or {}
    all_cells = [("id", id_cell)]
    all_cells += [(f"ood:{p.get('pair')}", p) for p in record.get("pairs") or []]
    for kind, rows_k in (record.get("ladder") or {}).items():
        all_cells += [(f"{kind}:{c.get('severity')}", c) for c in rows_k]
    for name, cell in all_cells:
        if not (cell.get("submitted") == cell.get("returned") == cell.get("n")) \
                or not cell.get("n"):
            dropped.append(name)
    gate("trust.zero_dropped", not dropped,
         f"cells with submitted != returned (or empty): {dropped}")

    div = id_cell.get("px_divergence")
    limit = cfg.get("px_divergence_limit")
    gate("trust.calibration_matches_serving",
         isinstance(div, (int, float)) and isinstance(limit, (int, float)) and div <= limit,
         f"clean-ID served-score divergence {div} vs limit {limit} — the serving path is "
         "not the distribution the calibration measured",
         baseline_v=limit, value=div)

    # per-pair AUROC, re-derived from the raw scores
    id_scores = id_cell.get("scores") or []
    rtol = cfg.get("auroc_rederive_tol", 1e-9)
    floor = cfg.get("auroc_floor")
    id_rate = abstain_rate(id_cell)
    for p in record.get("pairs") or []:
        name = p.get("pair")
        scores = p.get("scores") or []
        recorded = p.get("auroc")
        derived = binary_auroc(id_scores, scores) if id_scores and scores else None
        gate(f"trust.auroc_rederives[{name}]",
             isinstance(recorded, (int, float)) and derived is not None
             and abs(derived - recorded) <= rtol,
             f"recorded AUROC {recorded} vs re-derived {derived} — the stored value does "
             "not follow from the raw scores",
             baseline_v=recorded, value=derived)
        gate(f"trust.auroc_floor[{name}]",
             derived is not None and isinstance(floor, (int, float)) and derived >= floor,
             f"re-derived AUROC {derived} < committed floor {floor}",
             baseline_v=floor, value=derived)
        ood_rate = abstain_rate(p)
        gate(f"trust.ood_abstains_more[{name}]",
             id_rate is not None and ood_rate is not None and ood_rate >= id_rate,
             f"OoD abstention {ood_rate} < ID abstention {id_rate}",
             baseline_v=id_rate, value=ood_rate)

    # the corruption ladder: monotone abstention and the answered-accuracy
    # floor, from the raw counts
    tol = cfg.get("monotone_tol", 0.0)
    acc_floor = cfg.get("answered_accuracy_floor")
    for kind, rows_k in sorted((record.get("ladder") or {}).items()):
        rates = [abstain_rate(c) for c in rows_k]
        mono = (
            bool(rates) and all(r is not None for r in rates)
            and id_rate is not None
            and all(b >= a - tol for a, b in zip(rates, rates[1:]))
            # the tol absorbs between-rung sampling noise only: the heaviest
            # rung must never abstain less than clean traffic
            and rates[-1] >= id_rate
        )
        gate(f"trust.abstention_monotone[{kind}]", mono,
             f"abstention along severities {rates} (clean ID {id_rate}) is not monotone "
             f"within tol {tol}, or the heaviest rung abstains LESS than clean traffic — "
             "degradation is not graceful",
             baseline_v=id_rate, value=rates)
        accs, acc_ok = [], bool(rows_k)
        for c in rows_k:
            answered = c.get("answered") or 0
            correct = c.get("correct_answered")
            if answered == 0:
                accs.append(None)  # full abstention: the risk is vacuous
                continue
            if not isinstance(correct, (int, float)):
                acc_ok = False
                accs.append(None)
                continue
            acc = correct / answered
            accs.append(round(acc, 4))
            if not (isinstance(acc_floor, (int, float)) and acc >= acc_floor):
                acc_ok = False
        gate(f"trust.answered_accuracy_floor[{kind}]", acc_ok,
             f"accuracy-on-answered {accs} drops below the committed floor {acc_floor} "
             "somewhere on the ladder",
             baseline_v=acc_floor, value=accs)
    return {"ok": all(r["ok"] for r in rows), "checked": len(rows),
            "failed": sum(not r["ok"] for r in rows), "rows": rows}


def quant_gates(record: Dict[str, Any]) -> Dict[str, Any]:
    """Gate a quantized-serving record (the JAX package's `check --quant`
    schema: metric "quant", weights, parity, planner, floors, trust.f32,
    trust.<mode>, drill, where <mode> is the quantized weights' mode, the
    first field of perf/quant.py's tag), each verdict re-derived from the
    record's raw numbers, never from stored ratios, AUROCs or fit fields:

      * backbone weight bytes re-summed from the per-leaf rows match the
        recorded totals, and the f32/quantized ratio clears the reduction
        floor;
      * the parity maxima (per-logit and log p(x), the quantized program
        against its dequantized f32 twin) re-derived from the per-sample
        deltas match the recorded maxima and sit inside the tolerance;
      * each serve-bucket ladder re-derived from its program-peak +
        weight-resident terms against the shared budget matches the
        recorded fit list, the quantized ladder is strictly longer than
        the f32 one, and the recorded per-replica drop equals the weight
        terms' difference;
      * every ID x OoD pair's AUROC re-derived from the raw served scores
        of both matrices, each matching its recorded value, with |delta|
        inside the limit; answered accuracy per corruption cell from raw
        counts with |delta| inside its limit; the quantized clean-ID
        sketch on its calibration;
      * the mismatch drill fired: counted, degraded, the swap rejected
        with 'quant_mismatch';
      * zero steady-state recompiles in both matrices.
    The verdicts and their texts are the JAX package's."""
    from mgproto_tpu_torch.perf.quant import QUANT_TAG_INT8
    from mgproto_tpu_torch.trust.auroc import binary_auroc as _auroc

    q = QUANT_TAG_INT8.split(":")[0]  # the record's key of the quantized variant
    rows: List[Dict[str, Any]] = []

    def gate(key, ok, why="", baseline_v=None, value=None):
        rows.append({"key": key, "ok": bool(ok), "why": "" if ok else why,
                     "baseline": baseline_v, "value": value,
                     "direction": "quant"})

    floors = record.get("floors") or {}
    weights = record.get("weights") or {}
    parity = record.get("parity") or {}
    planner = record.get("planner") or {}
    trust = record.get("trust") or {}
    drill = record.get("drill") or {}
    gate("quant.schema",
         record.get("metric") == "quant" and bool(weights.get("rows"))
         and bool(parity) and bool(planner) and bool(floors)
         and bool(trust.get("f32")) and bool(trust.get(q))
         and bool(drill),
         "not a quant record (missing metric/weights/parity/planner/"
         f"floors/trust.f32/trust.{q}/drill)")

    # --- weight bytes: re-sum the per-leaf rows, then the reduction floor
    leaf_rows = weights.get("rows") or []
    f32_sum = sum(int(r.get("f32_bytes") or 0) for r in leaf_rows)
    int8_sum = sum(int(r.get("quant_bytes") or 0) for r in leaf_rows)
    gate("quant.weight_rows_resum",
         leaf_rows and f32_sum == weights.get("f32_total")
         and int8_sum == weights.get("int8_total"),
         f"per-leaf rows re-sum to f32={f32_sum} {q}={int8_sum} but the "
         f"record claims f32={weights.get('f32_total')} "
         f"{q}={weights.get('int8_total')}",
         baseline_v=(weights.get("f32_total"), weights.get("int8_total")),
         value=(f32_sum, int8_sum))
    floor = floors.get("weight_reduction_min")
    reduction = (f32_sum / int8_sum) if int8_sum else None
    gate("quant.weight_reduction_floor",
         reduction is not None and isinstance(floor, (int, float))
         and reduction >= floor,
         f"re-derived weight-bytes reduction {reduction} < committed "
         f"floor {floor}",
         baseline_v=floor,
         value=round(reduction, 3) if reduction else reduction)

    # --- parity: maxima re-derived from the per-sample arrays
    tol = floors.get("tolerance")
    for key, recorded_key in (("logit_delta_max_per_sample",
                               "max_logit_delta"),
                              ("log_px_delta", "max_log_px_delta")):
        deltas = parity.get(key) or []
        derived = max((abs(float(d)) for d in deltas), default=None)
        recorded = parity.get(recorded_key)
        gate(f"quant.parity_rederives[{key}]",
             derived is not None and isinstance(recorded, (int, float))
             and abs(derived - recorded) <= 1e-12,
             f"recorded {recorded_key}={recorded} does not follow from "
             f"the {len(deltas)} per-sample deltas (re-derived {derived})",
             baseline_v=recorded, value=derived)
        gate(f"quant.parity_tolerance[{key}]",
             derived is not None and isinstance(tol, (int, float))
             and derived <= tol,
             f"{q}-vs-dequantized-f32 delta {derived} exceeds the "
             f"committed tolerance {tol}",
             baseline_v=tol, value=derived)

    # --- planner ladder: re-derive fits from the recorded raw terms
    budget = planner.get("budget_bytes")
    fits: Dict[str, List[int]] = {}
    for variant in ("f32", q):
        vrows = (planner.get(variant) or {}).get("rows") or []
        derived_fit = []
        resum_ok = bool(vrows) and isinstance(budget, (int, float))
        for r in vrows:
            total = (int(r.get("program_peak_bytes") or 0)
                     + int(r.get("weight_resident_bytes") or 0))
            if total != r.get("total_bytes"):
                resum_ok = False
            if isinstance(budget, (int, float)) and total <= budget:
                derived_fit.append(int(r.get("batch")))
        fits[variant] = derived_fit
        recorded_fit = planner.get(f"{variant}_buckets_fit")
        gate(f"quant.ladder_rederives[{variant}]",
             resum_ok and derived_fit == recorded_fit,
             f"fit list re-derived from peak+weight terms vs budget "
             f"{budget} is {derived_fit}, record claims {recorded_fit} "
             "(or a row's total_bytes does not equal its terms)",
             baseline_v=recorded_fit, value=derived_fit)
    gate("quant.ladder_grows",
         len(fits.get(q) or []) > len(fits.get("f32") or []),
         f"{q} serve-bucket ladder {fits.get(q)} is not longer than "
         f"f32 {fits.get('f32')} — quantization bought no batch headroom "
         "under the shared budget",
         baseline_v=fits.get("f32"), value=fits.get(q))
    drop = planner.get("per_replica_hbm_drop_bytes")
    w_f32 = (planner.get("f32") or {}).get("weight_resident_bytes")
    w_int8 = (planner.get(q) or {}).get("weight_resident_bytes")
    gate("quant.hbm_drop_rederives",
         isinstance(w_f32, int) and isinstance(w_int8, int)
         and drop == w_f32 - w_int8 and drop > 0,
         f"recorded per-replica HBM drop {drop} != f32 weight-resident "
         f"{w_f32} - {q} {w_int8} (or not positive)",
         baseline_v=drop,
         value=(w_f32 - w_int8) if isinstance(w_f32, int)
         and isinstance(w_int8, int) else None)

    # --- trust deltas: both matrices re-derived, then compared
    def acc(cell) -> Optional[float]:
        answered = cell.get("answered") or 0
        correct = cell.get("correct_answered")
        if not answered or not isinstance(correct, (int, float)):
            return None
        return correct / answered

    reports = {v: trust.get(v) or {} for v in ("f32", q)}
    for variant, rep in reports.items():
        gate(f"quant.zero_steady_recompiles[{variant}]",
             rep.get("steady_state_recompiles") == 0,
             f"{variant} matrix recompiled in steady state: "
             f"{rep.get('steady_state_recompiles')}")
    aurocs: Dict[str, Dict[str, float]] = {"f32": {}, q: {}}
    rtol = (record.get("config") or {}).get("auroc_rederive_tol", 1e-9)
    for variant, rep in reports.items():
        id_scores = (rep.get("id") or {}).get("scores") or []
        for p in rep.get("pairs") or []:
            name = p.get("pair")
            derived = (
                _auroc(id_scores, p.get("scores") or [])
                if id_scores and p.get("scores") else None
            )
            recorded = p.get("auroc")
            gate(f"quant.auroc_rederives[{variant}:{name}]",
                 derived is not None
                 and isinstance(recorded, (int, float))
                 and abs(derived - recorded) <= rtol,
                 f"{variant} recorded AUROC {recorded} does not follow "
                 f"from the raw scores (re-derived {derived})",
                 baseline_v=recorded, value=derived)
            if derived is not None:
                aurocs[variant][name] = derived
    limit = floors.get("auroc_delta_limit")
    for name in sorted(aurocs["f32"]):
        a, b = aurocs["f32"].get(name), aurocs[q].get(name)
        delta = abs(a - b) if a is not None and b is not None else None
        gate(f"quant.auroc_delta[{name}]",
             delta is not None and isinstance(limit, (int, float))
             and delta <= limit,
             f"{q} shifts OoD AUROC by {delta} (f32 {a} vs {q} {b}), "
             f"outside the committed limit {limit}",
             baseline_v=limit, value=delta)
    acc_limit = floors.get("answered_accuracy_delta_limit")
    f32_ladder = reports["f32"].get("ladder") or {}
    int8_ladder = reports[q].get("ladder") or {}
    for kind in sorted(f32_ladder):
        cells_a = {c.get("severity"): c for c in f32_ladder.get(kind) or []}
        cells_b = {c.get("severity"): c
                   for c in int8_ladder.get(kind) or []}
        for sev in sorted(cells_a):
            a, b = acc(cells_a[sev]), acc(cells_b.get(sev) or {})
            # full abstention on either side makes the risk vacuous — the
            # trust suite's own monotone/floor gates cover that cell
            if a is None or b is None:
                continue
            delta = abs(a - b)
            gate(f"quant.answered_accuracy_delta[{kind}:{sev}]",
                 isinstance(acc_limit, (int, float)) and delta <= acc_limit,
                 f"{q} shifts accuracy-on-answered by {delta} "
                 f"(f32 {a} vs {q} {b}) at {kind}:{sev}, outside the "
                 f"committed limit {acc_limit}",
                 baseline_v=acc_limit, value=round(delta, 4))
    div = (reports[q].get("id") or {}).get("px_divergence")
    div_limit = floors.get("px_divergence_limit")
    gate("quant.int8_calibration_matches_serving",
         isinstance(div, (int, float))
         and isinstance(div_limit, (int, float)) and div <= div_limit,
         f"{q} clean-ID served-score divergence {div} vs limit "
         f"{div_limit} — the {q} serving path is not the distribution "
         "its calibration measured",
         baseline_v=div_limit, value=div)

    # --- mismatch drill: fail-closed must have been OBSERVED, not assumed
    gate("quant.mismatch_drill_counted",
         (drill.get("quant_mismatch_total") or 0) >= 1,
         "the quant-skewed calibration never tripped "
         "serving_quant_mismatch_total",
         baseline_v=1, value=drill.get("quant_mismatch_total"))
    gate("quant.mismatch_drill_degraded", drill.get("degraded") is True,
         "the gate did not degrade on quant-config mismatch")
    gate("quant.mismatch_drill_swap_rejected",
         drill.get("swap_reject") == "quant_mismatch",
         f"verify_head returned {drill.get('swap_reject')!r}, expected "
         "'quant_mismatch'",
         baseline_v="quant_mismatch", value=drill.get("swap_reject"))
    return {"ok": all(r["ok"] for r in rows), "checked": len(rows),
            "failed": sum(not r["ok"] for r in rows), "rows": rows}


def stall_report_gates(
    record: Dict[str, Any],
    baseline: Optional[Dict[str, Any]] = None,
    bytes_rel_tol: float = 0.05,
    hbm_abs_tol: float = 0.02,
) -> Dict[str, Any]:
    """Gate a stall-budget report (cli/trace_report.py) — schema sanity
    alone, or byte/stall regression against a baseline report.

    With a baseline, the two reports must share a byte source (comparing
    counted raw bytes against fused ones would gate noise) AND a
    comparable step time (fractions are fractions OF the reported step —
    a slower window dilutes hbm_bound into bubble, so gating across step
    times would pass real regressions), the new report's `bytes_accessed`
    must not exceed the baseline's by more than `bytes_rel_tol` (THE
    byte-regression gate: a change that quietly re-materializes trunk
    traffic fails here), and the
    hbm_bound fraction must not grow past the baseline's by more than
    `hbm_abs_tol`."""
    rows: List[Dict[str, Any]] = []

    def gate(key, ok, why="", baseline_v=None, value=None):
        rows.append({"key": key, "ok": bool(ok), "why": "" if ok else why,
                     "baseline": baseline_v, "value": value,
                     "direction": "stall"})

    gate("stall.schema", bool(record.get("stall_report")),
         "not a stall report (missing stall_report marker)")
    frac_sum = record.get("fraction_sum")
    gate("stall.fractions_sum_to_one",
         isinstance(frac_sum, (int, float)) and abs(frac_sum - 1.0) < 1e-4,
         f"fraction_sum={frac_sum}")
    movers = (record.get("top_byte_movers") or {}).get("rows")
    gate("stall.top_byte_movers_present", bool(movers),
         "report carries no ranked top_byte_movers rows")
    if baseline is not None:
        b_src = (baseline.get("byte_source"), baseline.get("source"))
        n_src = (record.get("byte_source"), record.get("source"))
        gate("stall.byte_source_matches", b_src == n_src,
             f"baseline measured via {b_src}, new via {n_src}",
             baseline_v=str(b_src), value=str(n_src))
        b_t = baseline.get("step_time_s")
        n_t = record.get("step_time_s")
        if isinstance(b_t, (int, float)) and isinstance(n_t, (int, float)):
            gate("stall.step_time_comparable",
                 abs(n_t - b_t) <= 0.05 * abs(b_t),
                 f"step_time_s {n_t:.4g} vs baseline {b_t:.4g} — "
                 "fractions are not comparable across step times; "
                 "regenerate at the baseline's measured step",
                 baseline_v=b_t, value=n_t)
        else:
            gate("stall.step_time_comparable", False,
                 "step_time_s missing from report or baseline",
                 baseline_v=b_t, value=n_t)
        b_bytes = baseline.get("bytes_accessed")
        n_bytes = record.get("bytes_accessed")
        if isinstance(b_bytes, (int, float)) and isinstance(
                n_bytes, (int, float)):
            allowed = b_bytes * (1.0 + bytes_rel_tol)
            gate("stall.bytes_accessed", n_bytes <= allowed,
                 f"{n_bytes:.4g} > allowed {allowed:.4g}",
                 baseline_v=b_bytes, value=n_bytes)
        else:
            gate("stall.bytes_accessed", False,
                 "bytes_accessed missing from report or baseline",
                 baseline_v=b_bytes, value=n_bytes)
        b_hbm = ((baseline.get("buckets") or {}).get("hbm_bound")
                 or {}).get("fraction")
        n_hbm = ((record.get("buckets") or {}).get("hbm_bound")
                 or {}).get("fraction")
        if isinstance(b_hbm, (int, float)) and isinstance(
                n_hbm, (int, float)):
            gate("stall.hbm_bound_fraction", n_hbm <= b_hbm + hbm_abs_tol,
                 f"{n_hbm:.4f} > allowed {b_hbm + hbm_abs_tol:.4f}",
                 baseline_v=b_hbm, value=n_hbm)
        else:
            gate("stall.hbm_bound_fraction", False,
                 "hbm_bound fraction missing", baseline_v=b_hbm,
                 value=n_hbm)
    return {"ok": all(r["ok"] for r in rows), "checked": len(rows),
            "failed": sum(not r["ok"] for r in rows), "rows": rows}


def _print_gate_result(result: Dict[str, Any], json_mode: bool) -> None:
    """Render one gate-suite result ({ok, checked, failed, rows})."""
    if json_mode:
        print(json.dumps(result, indent=2))
        return
    width = max(len(r["key"]) for r in result["rows"])
    for r in result["rows"]:
        status = "ok  " if r["ok"] else "FAIL"
        detail = f" ({r['why']})" if r["why"] else ""
        print(f"{status} {r['key']:<{width}}{detail}")
    print(f"{result['checked']} checked, {result['failed']} failed")


def _drift_drill_gates(record: Dict[str, Any]) -> Dict[str, Any]:
    from mgproto_tpu_torch.online.drill import drift_drill_gates

    return drift_drill_gates(record)


def check_main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mgproto_tpu_torch.cli.telemetry check",
        description="Gate a telemetry dir against a committed baseline, or a record "
                    "(exit 0 = within tolerance / every gate passes, 1 = a regression)")
    p.add_argument("dir", nargs="?", default=None,
                   help="telemetry dir (or a run dir containing telemetry/); optional "
                        "with a record gate")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON (generate with --write-baseline from a known-good "
                        "run, then commit it)")
    p.add_argument("--drift-drill", default=None, metavar="FILE",
                   help="gate a drift-drill record (online/drill.py): detection before "
                        "correction, zero drops and recompiles, poison rejection, accuracy "
                        "dip and recovery — exit 1 on any failure")
    p.add_argument("--trust", default=None, metavar="FILE",
                   help="gate a trust-matrix report (trust/matrix.py): per-pair OoD AUROC "
                        "re-derived from raw scores >= the report's floor, abstention "
                        "monotone in corruption severity, answered-accuracy >= floor at "
                        "every severity, calibration-vs-serving sketch agreement, zero "
                        "dropped requests, zero steady-state recompiles — exit 1 on any "
                        "failure")
    p.add_argument("--quant", default=None, metavar="FILE",
                   help="gate a quantized-serving record: weight bytes re-summed with "
                        ">=3x reduction, parity maxima re-derived inside tolerance, the "
                        "serve-bucket ladders re-derived and longer when quantized, trust "
                        "deltas re-derived inside their limits, the mismatch drill "
                        "fail-closed, zero steady-state recompiles — exit 1 on any failure")
    p.add_argument("--stall-report", default=None, metavar="FILE",
                   help="gate a stall-budget report (cli/trace_report.py output): schema "
                        "sanity, and with --stall-baseline the byte-regression gate — "
                        "bytes_accessed and the hbm_bound fraction must not grow past the "
                        "baseline report's band")
    p.add_argument("--stall-baseline", default=None, metavar="FILE",
                   help="stall report to gate --stall-report against")
    for dest in OTHER_GATES:
        p.add_argument("--" + dest.replace("_", "-"), dest=dest, default=None, metavar="FILE",
                       help="not ported (A9): refused")
    p.add_argument("--write-baseline", action="store_true",
                   help="summarize the dir and WRITE --baseline from it (no checking)")
    p.add_argument("--fleet-gates", action="store_true", help="not ported (A9): refused")
    p.add_argument("--json", action="store_true",
                   help="emit the check result as one JSON object")
    args = p.parse_args(argv)
    for dest in OTHER_GATES:
        if getattr(args, dest) is not None:
            _refuse("check --" + dest.replace("_", "-"))
    if args.fleet_gates:
        _refuse("check --fleet-gates")
    # one JSON document however many suites run: a single suite prints its
    # bare result object
    json_suites: Dict[str, Dict[str, Any]] = {}

    def _emit_suite(name: str, result: Dict[str, Any]) -> None:
        if args.json:
            json_suites[name] = result
        else:
            _print_gate_result(result, False)

    def _flush_json() -> None:
        if not args.json or not json_suites:
            return
        if len(json_suites) == 1:
            print(json.dumps(next(iter(json_suites.values())), indent=2))
        else:
            print(json.dumps(json_suites, indent=2))

    def _read_json(path, what):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise SystemExit(f"cannot read {what} {path}: {e}")

    suites_ok = True
    any_suite = False
    if args.stall_report:
        any_suite = True
        record = _read_json(args.stall_report, "stall report")
        baseline_rep = (_read_json(args.stall_baseline, "stall baseline")
                        if args.stall_baseline else None)
        result = stall_report_gates(record, baseline_rep)
        _emit_suite("stall_report", result)
        suites_ok = suites_ok and result["ok"]
    for flag, what, gates in (("drift_drill", "drift-drill record", _drift_drill_gates),
                              ("trust", "trust report", trust_gates),
                              ("quant", "quant record", quant_gates)):
        path = getattr(args, flag)
        if path:
            any_suite = True
            result = gates(_read_json(path, what))
            _emit_suite(flag, result)
            suites_ok = suites_ok and result["ok"]
    if args.dir is None and any_suite:
        _flush_json()
        return 0 if suites_ok else 1
    if args.dir is None or args.baseline is None:
        raise SystemExit("check needs a telemetry dir AND --baseline (or --drift-drill / "
                         "--stall-report / --trust / --quant FILE alone)")
    if not os.path.isdir(args.dir):
        raise SystemExit(f"not a directory: {args.dir}")
    summary = summarize(args.dir)
    if args.write_baseline:
        baseline = build_baseline(summary)
        if not baseline["entries"]:
            # an empty baseline would pass every later check vacuously
            raise SystemExit("refusing to write an EMPTY baseline: no gate key resolved to a "
                             "number in this summary")
        with open(args.baseline, "w") as f:
            json.dump(baseline, f, indent=2, sort_keys=True)
        print(f"wrote {len(baseline['entries'])} gate entries to {args.baseline}")
        _flush_json()
        return 0 if suites_ok else 1
    baseline = _read_json(args.baseline, "baseline")
    if not baseline.get("telemetry_check_baseline"):
        raise SystemExit(f"{args.baseline} is not a telemetry check baseline (generate one "
                         "with --write-baseline)")
    result = check(summary, baseline)
    if args.json:
        json_suites["baseline"] = result
        _flush_json()
    else:
        width = max((len(r["key"]) for r in result["rows"]), default=3)
        for r in result["rows"]:
            status = "ok  " if r["ok"] else "FAIL"
            detail = f" ({r['why']})" if r["why"] else ""
            print(f"{status} {r['key']:<{width}}  base={_fmt(r['baseline'])} "
                  f"new={_fmt(r['value'])}{detail}")
        print(f"{result['checked']} checked, {result['failed']} failed")
    return 0 if result["ok"] and suites_ok else 1


def main(argv: Optional[list] = None) -> Optional[int]:
    argv = list(sys.argv[1:] if argv is None else argv)
    # `<dir>` alone keeps meaning summarize
    if argv and argv[0] == "check":
        return check_main(argv[1:])
    if argv and argv[0] == "fleet":
        _refuse("fleet")
    if argv and argv[0] == "summarize":
        argv = argv[1:]
    p = argparse.ArgumentParser(
        prog="python -m mgproto_tpu_torch.cli.telemetry",
        description="Summarize a telemetry directory (subcommands: summarize [default], "
                    "check)")
    p.add_argument("dir", help="telemetry dir (or a run dir containing telemetry/)")
    p.add_argument("--json", action="store_true", help="emit the summary as one JSON object")
    args = p.parse_args(argv)
    if not os.path.isdir(args.dir):
        raise SystemExit(f"not a directory: {args.dir}")
    summary = summarize(args.dir)
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(render_table(summary))
    return None


if __name__ == "__main__":
    raise SystemExit(main())
