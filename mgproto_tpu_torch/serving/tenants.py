"""Multi-tenant serving: one shared trunk, many heads (counterpart of
mgproto_tpu/serving/tenants.py, without per-tenant drift and capture).

A tenant's HEAD is its calibration, the TrustGate built from it and its
admission quota. The trunk and the prototypes are shared, so a mount builds
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

A head's expected fingerprint is the port's own `gmm_fingerprint`, so a
calibration measured by the JAX package mounts degraded and its swap is
refused. `drift_config`, `capture_config` and `class_names` need the online
plane (ROADMAP A9): given, they raise `NotPortedError`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

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


@dataclasses.dataclass(frozen=True)
class MountReport:
    """What one mount cost: head bytes and seconds."""

    tenant: str
    head_fingerprint: str
    head_bytes: int
    mount_seconds: float

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TenantSwapReport:
    """One tenant head swap attempt: always returned, never raised."""

    ok: bool
    tenant: str
    reason: str  # SWAP_COMMITTED, a swap.REJECT_* cause or REJECT_NOT_MOUNTED
    head_fingerprint: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _refuse_online(tenant: str, **given) -> None:
    named = [k for k, v in given.items() if v]
    if named:
        from mgproto_tpu_torch.cli.common import NotPortedError

        raise NotPortedError(
            f"tenant {tenant!r}: {', '.join(named)} need the online plane, which is not "
            "ported; ROADMAP A9 (online learning)")


class TenantDirectory:
    """The mounted heads and every tenant-scoped operation over them.
    Thread-safe: mounts and swaps come from an operator path while the
    engines' dispatch reads gates; reads are dict lookups under the lock."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
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
              num_classes: Optional[int] = None) -> MountReport:
        """Mount one tenant head: a gate over `calibration` and a quota
        weight. Raises ValueError on a non-positive weight or a tenant that
        is mounted already (`swap` replaces a head)."""
        _refuse_online(tenant, class_names=class_names, drift_config=drift_config,
                       capture_config=capture_config)
        t0 = self.clock()
        if quota_weight <= 0.0:
            raise ValueError(f"tenant {tenant!r}: quota_weight must be > 0, got {quota_weight}")
        gate = TrustGate(calibration, expected_fingerprint=expected_fingerprint,
                         expected_compute_dtype=expected_compute_dtype, percentile=percentile)
        head = TenantHead(tenant=str(tenant), calibration=calibration, gate=gate,
                          head_fingerprint=head_fingerprint(calibration),
                          head_bytes=head_nbytes(calibration),
                          quota_weight=float(quota_weight), mounted_at=t0)
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
        return MountReport(tenant=head.tenant, head_fingerprint=head.head_fingerprint,
                           head_bytes=head.head_bytes, mount_seconds=seconds)

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
             percentile: Optional[float] = None) -> TenantSwapReport:
        """Tenant-scoped blue/green: stage a replacement head, verify it
        (`swap.verify_head`), and only then replace the mounted one. A
        rejection leaves the old head serving; no other tenant is touched."""
        from mgproto_tpu_torch.serving.swap import verify_head

        if self.head_for(tenant) is None:
            _m.counter(_m.TENANT_SWAPS).inc(tenant=str(tenant), result=SWAP_REJECTED)
            return TenantSwapReport(ok=False, tenant=str(tenant), reason=REJECT_NOT_MOUNTED)
        chaos = _chaos.get_active()
        if chaos is not None and chaos.tenant_bad_swap_due():
            calibration = None  # the drill: a head with no trust data
        staged = TrustGate(calibration, expected_fingerprint=expected_fingerprint,
                           expected_compute_dtype=expected_compute_dtype, percentile=percentile)
        reason = verify_head(staged)
        if reason is not None:
            _m.counter(_m.TENANT_SWAPS).inc(tenant=str(tenant), result=SWAP_REJECTED)
            return TenantSwapReport(ok=False, tenant=str(tenant), reason=reason)
        with self._lock:
            head = self._heads.get(tenant)
            if head is None:  # unmounted between the check and the commit
                return TenantSwapReport(ok=False, tenant=str(tenant), reason=REJECT_NOT_MOUNTED)
            head.calibration = calibration
            head.gate = staged
            head.head_fingerprint = head_fingerprint(calibration)
            head.head_bytes = head_nbytes(calibration)
        _m.counter(_m.TENANT_SWAPS).inc(tenant=str(tenant), result=SWAP_COMMITTED)
        _m.gauge(_m.TENANT_HEAD_BYTES).set(float(head.head_bytes), tenant=str(tenant))
        return TenantSwapReport(ok=True, tenant=str(tenant), reason=SWAP_COMMITTED,
                                head_fingerprint=head.head_fingerprint)

    def on_response(self, payload: Any, resp: Any) -> None:
        """The per-response tenant tap: feeds a head's drift and capture
        state, which the port does not hold yet (ROADMAP A9); a no-op."""
