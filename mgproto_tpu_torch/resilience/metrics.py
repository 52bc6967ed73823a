"""Resilience metric names and their registration (the port's copy of
mgproto_tpu/resilience/metrics.py; imports no torch).

Every recovery event of the resilience subsystem lands in the process-
current registry (`telemetry/registry.py::default_registry`) as a labeled
counter under the JAX package's name and help string: checkpoint write
failures and retries, rollbacks, preemption saves, missed barriers, peer
losses and elastic restores among them. `register_resilience_metrics`
pre-creates the whole family with zero-valued unlabeled series, so a clean
run reports explicit zeros instead of absent series.
"""

from __future__ import annotations

from mgproto_tpu_torch.telemetry.registry import Counter, default_registry

RETRIES = "resilience_retries_total"
SENTINEL_ROWS = "loader_sentinel_rows_total"
WORKER_RESTARTS = "loader_worker_restarts_total"
SKIPPED_STEPS = "train_skipped_steps_total"
ROLLBACKS = "train_rollbacks_total"
PREEMPTION_SAVES = "preemption_saves_total"
CKPT_WRITE_FAILURES = "checkpoint_write_failures_total"
CHAOS_INJECTIONS = "chaos_injections_total"
MISSED_BARRIERS = "missed_barriers_total"
PEER_LOST = "peer_lost_total"
ELASTIC_RESTORES = "elastic_restores_total"

HELP = {
    RETRIES: "retry attempts by scope (loader/checkpoint/distributed_init)",
    SENTINEL_ROWS: "samples replaced by sentinel rows after exhausted retries",
    WORKER_RESTARTS: "loader process-pool restarts after a worker hang/death",
    SKIPPED_STEPS: "train steps whose update was skipped (non-finite loss/grads)",
    ROLLBACKS: "restores to the last good checkpoint by the divergence policy",
    PREEMPTION_SAVES: "preemption-triggered checkpoint saves",
    CKPT_WRITE_FAILURES: "failed checkpoint write attempts (retried)",
    CHAOS_INJECTIONS: "faults injected by the chaos harness, by kind",
    MISSED_BARRIERS: "guarded barriers a peer missed past the timeout, by barrier",
    PEER_LOST: "survivor exits after barrier-timeout failure agreement",
    ELASTIC_RESTORES: "sharded restores onto a different chip/host count than the save",
}

ALL_COUNTERS = tuple(HELP)


def counter(name: str) -> Counter:
    """The named resilience counter in the process-current registry."""
    return default_registry().counter(name, HELP.get(name, ""))


def register_resilience_metrics(registry) -> None:
    """Pre-create the whole counter family with an explicit zero-valued
    unlabeled series."""
    for name in ALL_COUNTERS:
        registry.counter(name, HELP[name]).inc(0.0)
