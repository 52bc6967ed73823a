"""The one typed response every serving request is answered with
(trimmed copy of mgproto_tpu/serving/response.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from mgproto_tpu_torch.serving import metrics as _m

OUTCOME_PREDICT = "predict"
OUTCOME_ABSTAIN = "abstain"
OUTCOME_REJECT = "reject"
OUTCOME_SHED = "shed"

REASON_CIRCUIT_OPEN = "circuit_open"
REASON_DEVICE_ERROR = "device_error"


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


def record(resp: ServeResponse) -> ServeResponse:
    """The one metrics account of a response leaving the system."""
    _m.counter(_m.REQUESTS).inc(outcome=resp.outcome)
    _m.histogram(_m.REQUEST_SECONDS).observe(max(resp.latency_s, 0.0), outcome=resp.outcome)
    if resp.degraded and resp.outcome == OUTCOME_PREDICT:
        _m.counter(_m.DEGRADED_REQUESTS).inc()
    return resp

