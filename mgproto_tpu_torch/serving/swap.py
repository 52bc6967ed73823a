"""Blue/green hot swap: promote a new artifact with zero dropped requests
(counterpart of mgproto_tpu/serving/swap.py).

A new artifact (any engine factory) is staged into STANDBY engines, warmed,
and verified against the trust contract before any traffic moves.
Verification fails CLOSED, and the old model keeps serving:

  * `uncalibrated`: no calibration, and the caller did not allow degraded
    serving (the factory's `UncalibratedArtifactError` lands here too);
  * `fingerprint_mismatch`: the calibration was measured under another
    GMM (the port's own `gmm_fingerprint`, so a JAX calibration is one);
  * `quant_mismatch`: the calibration's quant stamp is not the served
    weights' (an f32 calibration on quantized weights, or the other way);
  * `stage_failed`: the factory or the warmup raised.

Only after every standby verifies does traffic flip, one replica at a
time: the old engine drains (readiness false), its queued requests move to
the standby's queue with their deadlines and enqueue times, and the replica
adopts the standby. The set's factory is retargeted, so later restarts
build the new model.

MGPROTO_CHAOS_SERVE_SWAP_BAD_ARTIFACT strips the trust data of the first N
staged standbys (an operator pushing an uncalibrated artifact): the swap
must refuse them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from mgproto_tpu_torch.obs import reqtrace as _reqtrace
from mgproto_tpu_torch.resilience import chaos as _chaos
from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.serving.replica import ReplicaSet

SWAP_COMMITTED = "committed"
SWAP_REJECTED = "rejected"

REJECT_UNCALIBRATED = "uncalibrated"
REJECT_FINGERPRINT = "fingerprint_mismatch"
REJECT_QUANT = "quant_mismatch"
REJECT_STAGE_FAILED = "stage_failed"
REJECT_NOT_WARMED = "not_warmed"


@dataclasses.dataclass(frozen=True)
class SwapReport:
    """What a swap attempt did: always returned, never raised."""

    ok: bool
    reason: str  # SWAP_COMMITTED or a REJECT_* cause
    replicas_swapped: int = 0
    transferred: int = 0  # queued requests moved old -> new
    detail: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def verify_head(gate, require_calibrated: bool = True) -> Optional[str]:
    """The trust half of the promotion gate, shared by the fleet's standbys
    and a tenant's head swap. Fingerprint, then quant, then uncalibrated:
    a gate that degraded itself over a stale calibration or a quant stamp
    reports that operator error, not a missing calibration."""
    if gate.fingerprint_mismatch:
        return REJECT_FINGERPRINT
    if gate.quant_mismatch:
        return REJECT_QUANT
    if gate.degraded and require_calibrated:
        return REJECT_UNCALIBRATED
    return None


def verify_standby(engine, require_calibrated: bool = True) -> Optional[str]:
    """None when the standby may take traffic: warmed and trust-verified."""
    if not getattr(engine, "warmed_up", False):
        return REJECT_NOT_WARMED
    return verify_head(engine.gate, require_calibrated=require_calibrated)


def stage_standby(factory: Callable[[], Any], require_calibrated: bool = True
                  ) -> Tuple[Optional[Any], Optional[str], str]:
    """Build, warm and verify one standby: (engine, None, "") or
    (None, reject_reason, detail)."""
    from mgproto_tpu_torch.serving.engine import UncalibratedArtifactError

    try:
        engine = factory()
        engine.warmup()
    except UncalibratedArtifactError as e:
        return None, REJECT_UNCALIBRATED, str(e)
    except Exception as e:  # unreadable artifact, warmup out of memory, ...
        return None, REJECT_STAGE_FAILED, f"{type(e).__name__}: {e}"
    chaos = _chaos.get_active()
    if chaos is not None and chaos.serve_swap_bad_artifact_due():
        from mgproto_tpu_torch.serving.gate import TrustGate

        engine.gate = TrustGate(None)  # the drill: no trust data
    reason = verify_standby(engine, require_calibrated=require_calibrated)
    if reason is not None:
        return None, reason, ""
    return engine, None, ""


def stage_fleet(count: int, standby_factory: Callable[[], Any],
                require_calibrated: bool = True) -> Tuple[List[Any], Optional[SwapReport]]:
    """Stage and verify `count` standbys, the expensive and trafficless half
    of a swap (it touches no live state, so the frontend runs it off its
    pump). ([], rejection) as soon as one fails: the whole green fleet
    stages before any traffic moves."""
    standbys: List[Any] = []
    for _ in range(max(int(count), 1)):
        engine, reason, detail = stage_standby(standby_factory,
                                               require_calibrated=require_calibrated)
        if engine is None:
            _m.counter(_m.SWAPS).inc(result=SWAP_REJECTED, reason=reason)
            _reqtrace.plane_event("swap_rejected", reason=reason)
            return [], SwapReport(ok=False, reason=reason, detail=detail)
        standbys.append(engine)
    return standbys, None


def flip_fleet(replica_set: ReplicaSet, standby_factory: Callable[[], Any],
               standbys: List[Any]) -> SwapReport:
    """The cheap half: flip replica by replica with queued work moved, then
    retarget the set's factory. Runs where ReplicaSet access is serialized
    (the frontend's pump, the batch driver's thread)."""
    live = [rep for rep in replica_set.replicas if rep.engine is not None]
    transferred = swapped = 0
    for rep, standby in zip(live, standbys):
        old = rep.engine
        old.draining = True  # readiness false: no new routing to blue
        moved = old.queue.drain_all()
        for req in moved:
            # same capacity, empty target: a restore cannot fail, but a
            # False must still never lose the request
            if not standby.queue.restore(req):
                raise RuntimeError("swap transfer overflowed the standby queue")
        transferred += len(moved)
        rep.adopt(standby)
        swapped += 1
    replica_set.engine_factory = standby_factory
    _m.counter(_m.SWAPS).inc(result=SWAP_COMMITTED)
    _m.counter(_m.SWAP_TRANSFERRED).inc(float(transferred))
    _reqtrace.plane_event("swap_committed", replicas=swapped, transferred=transferred)
    return SwapReport(ok=True, reason=SWAP_COMMITTED, replicas_swapped=swapped,
                      transferred=transferred)


def hot_swap(replica_set: ReplicaSet, standby_factory: Callable[[], Any],
             require_calibrated: bool = True) -> SwapReport:
    """Stage a full green fleet, verify it, then flip (module docstring)."""
    live = sum(1 for rep in replica_set.replicas if rep.engine is not None)
    standbys, rejection = stage_fleet(live, standby_factory,
                                      require_calibrated=require_calibrated)
    if rejection is not None:
        return rejection
    return flip_fleet(replica_set, standby_factory, standbys)
