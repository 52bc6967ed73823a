"""End-to-end request tracing through the serving plane (counterpart of
mgproto_tpu/obs/reqtrace.py).

When enabled, each request is tracked from the moment the frontend (or the
replica supervisor, for the batch faces) mints it, through admission, the
micro-batcher's coalescing wait, the replica it landed on and the device
dispatch; when the response leaves the system (the one
`serving.response.record()` exit) its stages are emitted as
explicit-timestamp spans into the telemetry tracer's Chrome trace:

    frontend  arrival -> response        (whole request, outcome attr)
    batcher   enqueued -> dispatch start (queue wait + linger, trigger attr)
    replica   dispatch start -> response (replica-name lane)
    engine    dispatch start + device_s  (bucket + fill/pad attrs)

plus one `dispatch` span a batch. Every timestamp comes from the PLANE's
injectable clock (`enable(clock=...)`): `time.monotonic` in production, a
virtual clock in tests. Per-stage latencies also land in the
`serving_stage_seconds{stage=queue|device|total}` histogram (rendered by
`cli.telemetry summarize`), and with `include_timings=True` the breakdown
is attached to the ServeResponse itself (`timings`). Spans go to per-lane
tids: the frontend's on 0, each replica's on its own lane from 1.

DISABLED IS FREE: every hook starts with a module-global None check and
mints nothing. Imports no torch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.telemetry.tracing import Tracer, default_tracer

# tid lanes in the exported Chrome trace: frontend spans on lane 0,
# replica/engine spans on a stable per-replica lane starting here
_REPLICA_TID_BASE = 1

# a request minted but never answered (client vanished pre-admission) must
# not leak its record forever; past this many pending records the oldest
# are dropped on the floor (counted) rather than growing unbounded
_MAX_PENDING = 100_000


@dataclasses.dataclass
class _ReqRecord:
    """Everything known about one in-flight request (clock-domain times)."""

    arrival: float
    enqueued: float = -1.0
    dispatch: float = -1.0
    device_s: float = 0.0
    replica: str = ""
    trigger: str = ""
    bucket: int = 0
    fill: float = 0.0


class ReqTraceState:
    def __init__(
        self,
        clock=None,
        tracer: Optional[Tracer] = None,
        include_timings: bool = False,
    ):
        self.clock = clock if clock is not None else time.monotonic
        # resolved once at enable: tests pass their own Tracer, the serve
        # CLI the live TelemetrySession's (the process-current one else)
        self.tracer = tracer if tracer is not None else default_tracer()
        self.include_timings = bool(include_timings)
        self.pending: Dict[str, _ReqRecord] = {}
        self.dropped = 0
        self._replica_tids: Dict[str, int] = {}
        # per-dispatch context (set by the batcher, consumed by the engine):
        # which replica's batcher triggered, why, and when the dispatch
        # window opened on the plane clock
        self.ctx_replica = ""
        self.ctx_trigger = ""
        self.ctx_t0: Optional[float] = None

    def replica_tid(self, name: str) -> int:
        tid = self._replica_tids.get(name)
        if tid is None:
            tid = self._replica_tids[name] = (
                _REPLICA_TID_BASE + len(self._replica_tids)
            )
        return tid


_STATE: Optional[ReqTraceState] = None


def enable(
    clock=None,
    tracer: Optional[Tracer] = None,
    include_timings: bool = False,
) -> ReqTraceState:
    """Turn request tracing on for this process; returns the state (tests
    inspect it). `clock` MUST be the same clock the plane's engines run on."""
    global _STATE
    _STATE = ReqTraceState(
        clock=clock, tracer=tracer, include_timings=include_timings
    )
    return _STATE


def disable() -> None:
    global _STATE
    _STATE = None


def enabled() -> bool:
    return _STATE is not None


# ------------------------------------------------------------------- hooks
def mint(request_id: str, now: Optional[float] = None) -> None:
    """Start a request's trace (frontend HTTP parse, or ReplicaSet.submit
    for frontend-less faces). Idempotent: the first mint wins, so the
    frontend's earlier arrival stamp is never overwritten downstream."""
    st = _STATE
    if st is None or request_id in st.pending:
        return
    if len(st.pending) >= _MAX_PENDING:
        # evict the OLDEST record (dict = insertion order): stale leaks
        # age out and tracing stays live for new traffic forever
        st.pending.pop(next(iter(st.pending)), None)
        st.dropped += 1
    st.pending[request_id] = _ReqRecord(
        arrival=st.clock() if now is None else float(now)
    )


def on_enqueue(request_id: str, enqueued_at: float) -> None:
    """Admission: the request entered a replica's queue (engine.submit)."""
    st = _STATE
    if st is None:
        return
    rec = st.pending.get(request_id)
    if rec is None:
        mint(request_id, now=enqueued_at)
        rec = st.pending.get(request_id)
        if rec is None:
            return
    rec.enqueued = float(enqueued_at)


def dispatch_context(replica: str, trigger: str, t0: float) -> None:
    """Set by the micro-batcher right before `engine.process_pending`: the
    replica lane, the dispatch trigger, and the dispatch-window open time."""
    st = _STATE
    if st is None:
        return
    st.ctx_replica = replica
    st.ctx_trigger = trigger
    st.ctx_t0 = float(t0)


def clear_dispatch_context() -> None:
    """Drop the batcher-set context. The batcher calls this after every
    pump (try/finally around `process_pending`): a dispatch that never
    reached `on_dispatch` — breaker open, empty pop, device error — must
    not leak its t0/replica/trigger into a later context-less dispatch."""
    st = _STATE
    if st is None:
        return
    st.ctx_replica = ""
    st.ctx_trigger = ""
    st.ctx_t0 = None


def on_dispatch(
    request_ids: List[str],
    bucket: int,
    fill: float,
    fallback_t0: Optional[float] = None,
) -> None:
    """The engine dispatched a batch: stamp every member with the dispatch
    window (batcher context when pumped, the engine's own clock otherwise),
    the device time, and the batch's pad state."""
    st = _STATE
    if st is None:
        return
    t0 = st.ctx_t0 if st.ctx_t0 is not None else fallback_t0
    now = st.clock()
    if t0 is None:
        t0 = now
    device_s = max(now - t0, 0.0)
    for rid in request_ids:
        rec = st.pending.get(rid)
        if rec is None:
            continue
        rec.dispatch = float(t0)
        rec.device_s = device_s
        rec.replica = st.ctx_replica
        rec.trigger = st.ctx_trigger
        rec.bucket = int(bucket)
        rec.fill = float(fill)
    # the dispatch itself is a timeline event (coalescing is visible as
    # many requests sharing one dispatch span)
    st.tracer.add_span(
        "dispatch",
        ts=t0,
        dur=device_s,
        tid=st.replica_tid(st.ctx_replica or "engine"),
        replica=st.ctx_replica or None,
        trigger=st.ctx_trigger or None,
        bucket=bucket,
        fill=fill,
        requests=len(request_ids),
    )
    st.ctx_replica = ""
    st.ctx_trigger = ""
    st.ctx_t0 = None


def plane_event(name: str, **attrs) -> None:
    """Instant marker on the plane timeline (replica kill/wedge detection,
    restarts, swap stages/flips) — load-test traces show these as zero-width
    ticks between the request spans."""
    st = _STATE
    if st is None:
        return
    st.tracer.add_span(name, ts=st.clock(), dur=0.0, tid=0, **attrs)


def finish(resp) -> Optional[Dict[str, Any]]:
    """Called by `serving.response.record()` — the one exit point — for
    every response leaving the system. Emits the stage spans + histograms,
    forgets the request, and returns the timing breakdown when the opt-in
    is on (None otherwise, including for untracked requests)."""
    st = _STATE
    if st is None:
        return None
    rec = st.pending.pop(resp.request_id, None)
    if rec is None:
        return None
    now = st.clock()
    total = max(now - rec.arrival, 0.0)
    rid = resp.request_id
    tracer = st.tracer
    tracer.add_span(
        "frontend", ts=rec.arrival, dur=total, tid=0,
        request=rid, outcome=resp.outcome,
    )
    timings: Dict[str, Any] = {"total_s": total}
    hist = _m.histogram(_m.STAGE_SECONDS)
    if rec.enqueued >= 0.0:
        queue_end = rec.dispatch if rec.dispatch >= 0.0 else now
        queue_s = max(queue_end - rec.enqueued, 0.0)
        tracer.add_span(
            "batcher", ts=rec.enqueued, dur=queue_s, tid=0,
            request=rid, trigger=rec.trigger or None,
        )
        timings["queue_s"] = queue_s
        hist.observe(queue_s, stage="queue")
    if rec.dispatch >= 0.0:
        tid = st.replica_tid(rec.replica or "engine")
        tracer.add_span(
            "replica", ts=rec.dispatch, dur=max(now - rec.dispatch, 0.0),
            tid=tid, request=rid, replica=rec.replica or None,
        )
        tracer.add_span(
            "engine", ts=rec.dispatch, dur=rec.device_s, tid=tid,
            request=rid, bucket=rec.bucket, fill=rec.fill,
        )
        timings["device_s"] = rec.device_s
        timings["pad_fraction"] = max(1.0 - rec.fill, 0.0)
        if rec.replica:
            timings["replica"] = rec.replica
        hist.observe(rec.device_s, stage="device")
    hist.observe(total, stage="total")
    return timings if st.include_timings else None
