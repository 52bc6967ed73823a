"""The one typed response every serving request is answered with
(counterpart of mgproto_tpu/serving/response.py).

The network plane (batcher, replica supervisor, swap, HTTP frontend) builds
and accounts typed responses through this module without importing the
engine, so a frontend can shed typed while the device stack is down.

`record()` is the ONE metrics account of a response leaving the system
(requests-by-outcome counter, latency histogram, degraded counter) and the
one exit of request tracing (obs/reqtrace.py: stage spans, the per-stage
histogram, the opt-in `timings`), and `shed_response()` the plane's
recorded typed shed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from mgproto_tpu_torch.obs import reqtrace as _reqtrace
from mgproto_tpu_torch.serving import metrics as _m

OUTCOME_PREDICT = "predict"
OUTCOME_ABSTAIN = "abstain"
OUTCOME_REJECT = "reject"
OUTCOME_SHED = "shed"

# reject/shed reasons minted by the plane (validation reasons come from
# serving/validate.py, admission reasons from serving/admission.py)
REASON_CIRCUIT_OPEN = "circuit_open"
REASON_DEVICE_ERROR = "device_error"
REASON_SHUTDOWN = "shutdown"  # graceful drain: answered typed, never dropped
REASON_NO_REPLICA = "no_replica"  # every replica dead/unready: typed shed
REASON_REPLICA_LOST = "replica_lost"  # rerouted off a dead replica, no room


@dataclasses.dataclass(frozen=True)
class ServeResponse:
    request_id: str
    outcome: str  # predict | abstain | reject | shed
    prediction: Optional[int] = None
    log_px: Optional[float] = None
    trust: Optional[str] = None  # in_dist | abstain | ungated
    trust_score: Optional[float] = None  # calibrated ID-quantile of log_px
    confidence: Optional[float] = None  # temperature-calibrated max softmax
    degraded: bool = False
    reason: Optional[str] = None  # reject/shed cause
    latency_s: float = 0.0
    # the opt-in timing breakdown of request tracing (obs/reqtrace.py with
    # include_timings=True): total_s / queue_s / device_s / pad_fraction /
    # replica; None, and absent from to_dict(), everywhere else
    timings: Optional[Dict[str, Any]] = None
    # the top activated prototypes behind a PREDICT outcome (an engine
    # serving with explanations); None, and absent from to_dict(), elsewhere
    explain: Optional[Any] = None
    # the tenant lane of the request (serving/tenants.py); None, and absent
    # from to_dict(), on the single-tenant path
    tenant: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for opt in ("timings", "explain", "tenant"):
            if d.get(opt) is None:
                d.pop(opt, None)
        return d


def record(resp: ServeResponse) -> ServeResponse:
    """The one metrics account of a response leaving the system, and the
    request trace's finish when tracing is on."""
    _m.counter(_m.REQUESTS).inc(outcome=resp.outcome)
    _m.histogram(_m.REQUEST_SECONDS).observe(max(resp.latency_s, 0.0), outcome=resp.outcome)
    if resp.tenant is not None:
        # the per-tenant view rides families of its own, so the fleet's
        # series are the same with or without tenants
        _m.counter(_m.TENANT_REQUESTS).inc(tenant=resp.tenant, outcome=resp.outcome)
        _m.histogram(_m.TENANT_REQUEST_SECONDS).observe(
            max(resp.latency_s, 0.0), tenant=resp.tenant, outcome=resp.outcome)
    if resp.degraded and resp.outcome == OUTCOME_PREDICT:
        _m.counter(_m.DEGRADED_REQUESTS).inc()
    if _reqtrace.enabled():
        # the one request-tracing exit: stage spans, histograms, timings
        timings = _reqtrace.finish(resp)
        if timings is not None:
            resp = dataclasses.replace(resp, timings=timings)
    return resp


def shed_response(request_id: str, reason: str, latency_s: float = 0.0,
                  degraded: bool = False, tenant: Optional[str] = None) -> ServeResponse:
    """A recorded typed shed: the plane's answer when no engine can serve
    (a dead replica with no survivors, a graceful shutdown, a lost reroute)."""
    _m.counter(_m.SHED).inc(reason=reason)
    if tenant is not None:
        _m.counter(_m.TENANT_SHED).inc(tenant=tenant, reason=reason)
    return record(ServeResponse(request_id=request_id, outcome=OUTCOME_SHED, reason=reason,
                                degraded=degraded, latency_s=latency_s, tenant=tenant))
