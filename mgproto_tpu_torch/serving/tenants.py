"""Multi-tenant serving: one shared trunk, many heads (counterpart of
mgproto_tpu/serving/tenants.py).

A tenant's HEAD is its calibration, the TrustGate built from it, its
admission quota and, optionally, its online state: a drift monitor and a
trusted-capture reservoir (online/), tenant-labeled. The trunk and the prototypes are shared, so a mount builds
nothing on the card: the engines' model, buckets and warmed shapes are the
same before and after, and `steady_state_recompiles` stays 0.

  * FAIR-SHARE ADMISSION. `quota_for` turns a tenant's weight into its
    share of an admission queue; the queue sheds the tenant's own tail
    (typed `tenant_quota`, serving/admission.py) and gives batch slots to
    the lanes in turn.
  * TENANT-SCOPED BLUE/GREEN. `swap` stages a replacement head and verifies
    it with the fleet swap's fail-closed check (serving/swap.py
    `verify_head`): an uncalibrated or stale-fingerprint head is rejected
    for that tenant while its old head, and every other tenant, serves on.
    MGPROTO_CHAOS_TENANT_BAD_SWAP drills it.
  * PER-TENANT DRIFT AND CAPTURE. `mount(drift_config=, capture_config=)`
    gives a head its own DriftMonitor and TrustedCapture; `on_response`,
    the engine's per-response tap, feeds them, so one tenant's drifting
    traffic breaches that tenant's monitor only. `class_names` claims
    padded class slots through the directory's `class_directory`
    (online/classes.py).

A head's expected fingerprint is the port's own `gmm_fingerprint`, so a
calibration measured by the JAX package mounts degraded and its swap is
refused.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from mgproto_tpu_torch.obs.flightrec import record_event
from mgproto_tpu_torch.resilience import chaos as _chaos
from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.serving.calibration import Calibration
from mgproto_tpu_torch.serving.gate import TrustGate

# typed reject for traffic addressed at a tenant the directory does not hold
REASON_TENANT_UNMOUNTED = "tenant_unmounted"

SWAP_COMMITTED = "committed"
SWAP_REJECTED = "rejected"
REJECT_NOT_MOUNTED = "not_mounted"


def head_fingerprint(calibration: Optional[Calibration]) -> str:
    """sha256 over the calibration's JSON ("" for no calibration)."""
    if calibration is None:
        return ""
    return hashlib.sha256(calibration.to_json().encode()).hexdigest()


def head_nbytes(calibration: Optional[Calibration]) -> int:
    """Bytes of a head's trust data: the float64 quantile sketch, the
    per-class temperatures, the thresholds and the operating point."""
    if calibration is None:
        return 0
    return 8 * (len(calibration.quantile_log_px) + len(calibration.per_class_temperature)
                + len(calibration.thresholds) + 1)


@dataclasses.dataclass
class TenantHead:
    """One tenant's mounted state; `swap` replaces its trust data in place."""

    tenant: str
    calibration: Optional[Calibration]
    gate: TrustGate
    head_fingerprint: str
    head_bytes: int
    quota_weight: float
    mounted_at: float
    drift: Optional[Any] = None  # online.drift.DriftMonitor
    capture: Optional[Any] = None  # online.capture.TrustedCapture
    class_slots: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class MountReport:
    """What one mount cost: head bytes and seconds, and the class slots it
    claimed."""

    tenant: str
    head_fingerprint: str
    head_bytes: int
    mount_seconds: float
    class_slots: Tuple[int, ...] = ()

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["class_slots"] = list(self.class_slots)
        return d


@dataclasses.dataclass(frozen=True)
class TenantSwapReport:
    """One tenant head swap attempt: always returned, never raised."""

    ok: bool
    tenant: str
    reason: str  # SWAP_COMMITTED, a swap.REJECT_* cause or REJECT_NOT_MOUNTED
    head_fingerprint: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class TenantDirectory:
    """The mounted heads and every tenant-scoped operation over them.
    Thread-safe: mounts and swaps come from an operator path while the
    engines' dispatch reads gates; reads are dict lookups under the lock."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 class_directory: Optional[Any] = None):
        self.clock = clock
        # online/classes.py's ClassDirectory: a mount with class_names
        # claims padded slots through it
        self.class_directory = class_directory
        self._lock = threading.Lock()
        self._heads: Dict[str, TenantHead] = {}

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._heads)

    def head_for(self, tenant: str) -> Optional[TenantHead]:
        with self._lock:
            return self._heads.get(tenant)

    def gate_for(self, tenant: str) -> Optional[TrustGate]:
        head = self.head_for(tenant)
        return None if head is None else head.gate

    def __len__(self) -> int:
        with self._lock:
            return len(self._heads)

    def mount(self, tenant: str, calibration: Optional[Calibration],
              quota_weight: float = 1.0, class_names: Sequence[str] = (),
              expected_fingerprint: Optional[str] = None,
              expected_compute_dtype: Optional[str] = None,
              percentile: Optional[float] = None, drift_config: Optional[Any] = None,
              capture_config: Optional[Any] = None,
              num_classes: Optional[int] = None,
              expected_quant: Optional[str] = None) -> MountReport:
        """Mount one tenant head: a gate over `calibration`, a quota weight
        and, given their configs, a drift monitor and a capture reservoir
        (capture needs `num_classes`); `class_names` claim class-bucket
        slots (they stay claimed after an unmount). Raises ValueError on a
        non-positive weight, class names without a class directory, or a
        tenant that is mounted already (`swap` replaces a head)."""
        t0 = self.clock()
        if quota_weight <= 0.0:
            raise ValueError(f"tenant {tenant!r}: quota_weight must be > 0, got {quota_weight}")
        gate = TrustGate(calibration, expected_fingerprint=expected_fingerprint,
                         expected_compute_dtype=expected_compute_dtype, percentile=percentile,
                         expected_quant=expected_quant)
        slots: List[int] = []
        if class_names:
            if self.class_directory is None:
                raise ValueError(f"tenant {tenant!r} asks for class slots {list(class_names)} "
                                 "but the directory has no class-bucket machinery attached")
            for name in class_names:
                existing = self.class_directory.slot_of(str(name))
                slots.append(existing if existing is not None
                             else self.class_directory.add_class(str(name)))
        drift = None
        if drift_config is not None:
            from mgproto_tpu_torch.online.drift import DriftMonitor

            drift = DriftMonitor(calibration, config=drift_config, clock=self.clock,
                                 tenant=tenant)
        capture = None
        if capture_config is not None:
            if num_classes is None:
                raise ValueError(f"tenant {tenant!r}: capture_config needs num_classes")
            from mgproto_tpu_torch.online.capture import TrustedCapture

            capture = TrustedCapture(calibration, num_classes=int(num_classes),
                                     config=capture_config, tenant=tenant)
        head = TenantHead(tenant=str(tenant), calibration=calibration, gate=gate,
                          head_fingerprint=head_fingerprint(calibration),
                          head_bytes=head_nbytes(calibration),
                          quota_weight=float(quota_weight), mounted_at=t0, drift=drift,
                          capture=capture, class_slots=tuple(slots))
        with self._lock:
            if tenant in self._heads:
                raise ValueError(f"tenant {tenant!r} is already mounted; use swap() to "
                                 "replace its head")
            self._heads[str(tenant)] = head
            count = len(self._heads)
        seconds = max(self.clock() - t0, 0.0)
        _m.counter(_m.TENANT_MOUNTS).inc(tenant=head.tenant)
        _m.gauge(_m.TENANTS_MOUNTED).set(float(count))
        _m.gauge(_m.TENANT_HEAD_BYTES).set(float(head.head_bytes), tenant=head.tenant)
        _m.histogram(_m.TENANT_MOUNT_SECONDS).observe(seconds, tenant=head.tenant)
        record_event("tenant_mount", tenant=head.tenant, head_bytes=head.head_bytes,
                     seconds=seconds)
        return MountReport(tenant=head.tenant, head_fingerprint=head.head_fingerprint,
                           head_bytes=head.head_bytes, mount_seconds=seconds,
                           class_slots=head.class_slots)

    def unmount(self, tenant: str) -> bool:
        """Drop a tenant's head; False when it was not mounted."""
        with self._lock:
            head = self._heads.pop(tenant, None)
            count = len(self._heads)
        if head is None:
            return False
        _m.counter(_m.TENANT_UNMOUNTS).inc(tenant=str(tenant))
        _m.gauge(_m.TENANTS_MOUNTED).set(float(count))
        _m.gauge(_m.TENANT_HEAD_BYTES).set(0.0, tenant=str(tenant))
        record_event("tenant_unmount", tenant=str(tenant))
        return True

    def quota_for(self, tenant: str, capacity: int) -> Optional[int]:
        """The tenant's share of a queue of `capacity`: proportional to its
        weight over the mounted tenants, at least 1. None for a tenant that
        is not mounted (the engine rejects it typed)."""
        with self._lock:
            head = self._heads.get(tenant)
            if head is None:
                return None
            total = sum(h.quota_weight for h in self._heads.values())
        share = head.quota_weight / total if total > 0 else 1.0
        return max(1, int(int(capacity) * share))

    def swap(self, tenant: str, calibration: Optional[Calibration],
             expected_fingerprint: Optional[str] = None,
             expected_compute_dtype: Optional[str] = None,
             percentile: Optional[float] = None,
             expected_quant: Optional[str] = None) -> TenantSwapReport:
        """Tenant-scoped blue/green: stage a replacement head, verify it
        (`swap.verify_head`), and only then replace the mounted one. A
        rejection (uncalibrated, a stale fingerprint, a quant stamp that is
        not the served trunk's) leaves the old head serving; no other
        tenant is touched. The head itself is f32 whatever the trunk's
        quant config."""
        from mgproto_tpu_torch.serving.swap import verify_head

        if self.head_for(tenant) is None:
            _m.counter(_m.TENANT_SWAPS).inc(tenant=str(tenant), result=SWAP_REJECTED)
            record_event("tenant_swap_rejected", tenant=str(tenant), reason=REJECT_NOT_MOUNTED)
            return TenantSwapReport(ok=False, tenant=str(tenant), reason=REJECT_NOT_MOUNTED)
        chaos = _chaos.get_active()
        if chaos is not None and chaos.tenant_bad_swap_due():
            calibration = None  # the drill: a head with no trust data
        staged = TrustGate(calibration, expected_fingerprint=expected_fingerprint,
                           expected_compute_dtype=expected_compute_dtype, percentile=percentile,
                           expected_quant=expected_quant)
        reason = verify_head(staged)
        if reason is not None:
            _m.counter(_m.TENANT_SWAPS).inc(tenant=str(tenant), result=SWAP_REJECTED)
            record_event("tenant_swap_rejected", tenant=str(tenant), reason=reason)
            return TenantSwapReport(ok=False, tenant=str(tenant), reason=reason)
        with self._lock:
            head = self._heads.get(tenant)
            if head is None:  # unmounted between the check and the commit
                return TenantSwapReport(ok=False, tenant=str(tenant), reason=REJECT_NOT_MOUNTED)
            head.calibration = calibration
            head.gate = staged
            head.head_fingerprint = head_fingerprint(calibration)
            head.head_bytes = head_nbytes(calibration)
        if head.drift is not None:
            # the monitor now watches for drift away from the new head
            head.drift.rebase(calibration)
        if head.capture is not None:
            head.capture.retarget(calibration)
        _m.counter(_m.TENANT_SWAPS).inc(tenant=str(tenant), result=SWAP_COMMITTED)
        _m.gauge(_m.TENANT_HEAD_BYTES).set(float(head.head_bytes), tenant=str(tenant))
        record_event("tenant_swap_committed", tenant=str(tenant))
        return TenantSwapReport(ok=True, tenant=str(tenant), reason=SWAP_COMMITTED,
                                head_fingerprint=head.head_fingerprint)

    def on_response(self, payload: Any, resp: Any) -> None:
        """The per-response tenant tap, after `record()`: feeds the
        tenant's drift window (and runs its cadence-gated evaluation) and
        its capture reservoir. O(1) a response; never raises."""
        tenant = getattr(resp, "tenant", None)
        if tenant is None:
            return
        head = self.head_for(tenant)
        if head is None:
            return
        if head.drift is not None:
            if resp.log_px is not None:
                head.drift.observe_px(resp.log_px)
            head.drift.evaluate()  # cadence-gated; a no-op between intervals
        if head.capture is not None:
            head.capture.on_response(payload, resp)
