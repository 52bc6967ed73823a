"""Health and readiness probes over a ServingEngine (counterpart of
mgproto_tpu/serving/health.py).

  * liveness: "is the process wedged?" True while the engine object is
    intact.
  * readiness: "should traffic be routed here?" False until every bucket
    is warmed (first launches would land on a request), while the circuit
    breaker is OPEN, and while the engine is DRAINING (graceful shutdown or
    a blue/green flip: queued work still answers, new work goes elsewhere).
    Half-open is ready: the probe batch is traffic.

Degraded mode is ready (classification still serves) but reported.
"""

from __future__ import annotations

from typing import Any, Dict

from mgproto_tpu_torch.serving.admission import BREAKER_OPEN


class HealthProbe:
    """Probe views over a ServingEngine; holds no request payloads."""

    def __init__(self, engine):
        self.engine = engine

    def liveness(self) -> Dict[str, Any]:
        return {"alive": True}

    def readiness(self) -> Dict[str, Any]:
        e = self.engine
        breaker_open = e.breaker.state == BREAKER_OPEN
        ready = e.warmed_up and not breaker_open and not e.draining
        return {
            "ready": ready,
            "warmed_up": e.warmed_up,
            "draining": e.draining,
            "buckets": list(e.buckets),
            "breaker_state": e.breaker.state,
            "degraded": e.gate.degraded,
            "fingerprint_mismatch": e.gate.fingerprint_mismatch,
            "queue_depth": len(e.queue),
            "queue_capacity": e.queue.capacity,
        }
