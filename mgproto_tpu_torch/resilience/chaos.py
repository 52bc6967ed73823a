"""Deterministic fault injection for the training, pod and serving drills
(counterpart of mgproto_tpu/resilience/chaos.py but for the loader's and
the straggler's knobs).

Training: two one-shot events, keyed by the global step: a NaN batch
(`nan_at_step`) and a simulated preemption (`preempt_at_step`).
`EpochGuard.wrap_batches` applies them to the placed batch of that step:
the preemption raises the same flag a real SIGTERM sets, and the NaN batch
is poisoned on its device (the JAX package poisons the host images before
placement; the port's uint8 wire has no NaN, so there the augmentation
draws carry it). The step itself is the same with chaos on or off. The one-shot
state lives in the `ChaosState`, so a rollback that replays the same steps
does not inject again; that is what lets a drill end bit-equal to the
clean run.

Pods (several ranks): when the batch of `kill_host_at` is drawn the
targeted rank dies hard (`os._exit(HOST_KILL_EXIT_CODE)`, a host crash),
and at `wedge_host_at` it hangs (a stuck host), both in
`EpochGuard.wrap_batches`; `host_index` names the rank (-1: any process
whose environment carries the knob). Checkpoints: the first
`checkpoint_write_failures` saves fail just before their publish point
(utils/checkpoint.py), each retried in lockstep. One-shot each.

Serving: the engine, the replica supervisor, the fleet swap and the tenant
directory consult the process-active state (`get_active`, `install`):
malformed or NaN payloads at seeded rates, a deadline storm, listed
dispatches that raise a simulated device error, a replica killed or wedged
at an admitted-request index, trust-stripped swap artifacts and tenant
heads, and a storm redirected at one tenant. The online drills draw which
requests become poison (low-p(x) mislabeled junk the capture gate must
refuse; off-manifold junk in the storm tenant's lane that only its drift
monitor may see). Every draw is numpy's
`default_rng([seed, tag, index])` with the JAX package's tags, so one plan
hits the same requests in both packages.

`plan_from_env` reads MGPROTO_CHAOS_SEED, MGPROTO_CHAOS_NAN_AT_STEP,
MGPROTO_CHAOS_PREEMPT_AT_STEP, MGPROTO_CHAOS_CKPT_FAILS,
MGPROTO_CHAOS_{KILL,WEDGE}_HOST_AT, MGPROTO_CHAOS_HOST_INDEX, the
MGPROTO_CHAOS_SERVE_* and
MGPROTO_CHAOS_TENANT_{STORM_AT, BAD_SWAP, POISON_RATE} knobs and
MGPROTO_CHAOS_ONLINE_POISON_RATE, and refuses every other
MGPROTO_CHAOS_* knob of the JAX package, naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# the JAX package's knobs the port does not read yet, by the ROADMAP item
# that ports them
UNPORTED_KNOBS: Dict[str, str] = {
    **{k: "A9 (resilience: the loader's chaos injection)"
       for k in ("MGPROTO_CHAOS_LOADER_IO_RATE", "MGPROTO_CHAOS_LOADER_IO_FAILS")},
    "MGPROTO_CHAOS_SLOW_HOST_MS": "A9 (obs and telemetry: straggler detection)",
}

# the status a chaos-killed rank dies with (os._exit: no cleanup, as a real
# crash); distinct from parallel/multihost.py's PEER_LOST_EXIT_CODE, so a
# post-mortem tells the victim from the survivors
HOST_KILL_EXIT_CODE = 86


class ChaosError(IOError):
    """The injected serving fault (an IOError, as a real device failure's
    path sees it)."""


@dataclasses.dataclass
class ChaosPlan:
    """What to inject. All off by default."""

    # one-shot: NaN images in the batch whose train step has this global index
    nan_at_step: Optional[int] = None
    # one-shot: a simulated SIGTERM when the batch of this global step is drawn
    preempt_at_step: Optional[int] = None
    seed: int = 0  # seeds the serving rates' draws
    # serving: fractions of requests whose payload becomes malformed / NaN
    serve_malformed_rate: float = 0.0
    serve_nan_rate: float = 0.0
    # serving: dispatch indices that raise a simulated device error, once each
    serve_device_errors: Tuple[int, ...] = ()
    # serving: requests [storm_at, storm_at + storm_len) arrive past their deadline
    serve_storm_at: Optional[int] = None
    serve_storm_len: int = 0
    # serving plane, one-shot each: at this admitted-request index the
    # replica the request would route to dies / wedges
    serve_replica_kill_at: Optional[int] = None
    serve_wedge_at: Optional[int] = None
    # the first N fleet swaps stage a trust-stripped artifact (must fail closed)
    serve_swap_bad_artifact: int = 0
    # tenants: from this request index the drill floods one tenant; the
    # first N tenant head swaps stage a trust-stripped head
    tenant_storm_at: Optional[int] = None
    tenant_bad_swap: int = 0
    # online drills: fractions of requests replaced by low-p(x) mislabeled
    # junk (the capture gate must refuse every one), and of the storm
    # tenant's requests replaced by off-manifold junk
    online_poison_rate: float = 0.0
    tenant_poison_rate: float = 0.0
    # the first N checkpoint saves fail before their publish point
    checkpoint_write_failures: int = 0
    # pods, one-shot each: when the batch of this global step is drawn, the
    # targeted rank dies hard / hangs
    kill_host_at: Optional[int] = None
    wedge_host_at: Optional[int] = None
    # the rank the kill and the wedge target; -1 = any process whose
    # environment carries the knob
    host_index: int = -1

    def any_active(self) -> bool:
        return (self.nan_at_step is not None or self.preempt_at_step is not None
                or self.checkpoint_write_failures > 0 or self.kill_host_at is not None
                or self.wedge_host_at is not None
                or self.serve_malformed_rate > 0.0 or self.serve_nan_rate > 0.0
                or bool(self.serve_device_errors)
                or (self.serve_storm_at is not None and self.serve_storm_len > 0)
                or self.serve_replica_kill_at is not None or self.serve_wedge_at is not None
                or self.serve_swap_bad_artifact > 0 or self.tenant_storm_at is not None
                or self.tenant_bad_swap > 0 or self.online_poison_rate > 0.0
                or self.tenant_poison_rate > 0.0)


class ChaosState:
    """A plan and its one-shot bookkeeping (thread-safe). `injections`
    counts what fired, by kind."""

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._nan_fired = False
        self._preempt_fired = False
        self._serve_errors_left = set(int(i) for i in plan.serve_device_errors)
        self._replica_kill_fired = False
        self._wedge_fired = False
        self._bad_swaps_left = int(plan.serve_swap_bad_artifact)
        self._tenant_storm_counted = False
        self._tenant_bad_swaps_left = int(plan.tenant_bad_swap)
        self._ckpt_failures_left = int(plan.checkpoint_write_failures)
        self._host_kill_fired = False
        self._host_wedge_fired = False
        self.injections: Dict[str, int] = {}

    def _count(self, kind: str) -> None:
        with self._lock:
            self.injections[kind] = self.injections.get(kind, 0) + 1

    def corrupt_batch(self, global_step: int, batch):
        """The placed batch (`engine/train.py::DeviceBatch`) of `nan_at_step`
        poisoned once, on its device: NaN augmentation draws on the uint8
        wire (the tail turns every pixel into NaN), else NaN images. Any
        other batch comes back as it is."""
        with self._lock:
            due = (self.plan.nan_at_step is not None and not self._nan_fired
                   and int(global_step) == int(self.plan.nan_at_step))
            if due:
                self._nan_fired = True
        if not due:
            return batch
        self._count("nan_loss")
        if batch.draws is not None:
            return batch._replace(draws=torch.full_like(batch.draws, float("nan")))
        return batch._replace(images=torch.full_like(batch.images, float("nan")))

    def preempt_due(self, global_step: int) -> bool:
        """True exactly once, when the batch of `preempt_at_step` (or a
        later one) is drawn."""
        with self._lock:
            due = (self.plan.preempt_at_step is not None and not self._preempt_fired
                   and int(global_step) >= int(self.plan.preempt_at_step))
            if due:
                self._preempt_fired = True
        if due:
            self._count("preempt_signal")
        return due

    # ------------------------------------------------------------- pods
    def _host_fault_due(self, attr: str, at: Optional[int], global_step: int,
                        process_index: int, kind: str) -> bool:
        if at is None or (self.plan.host_index >= 0 and process_index != self.plan.host_index):
            return False
        with self._lock:
            if getattr(self, attr) or int(global_step) < int(at):
                return False
            setattr(self, attr, True)
        self._count(kind)
        return True

    def host_kill_due(self, global_step: int, process_index: int) -> bool:
        """True once, on the targeted rank, when the batch of
        `kill_host_at` (or a later one) is drawn: the caller hard-exits."""
        return self._host_fault_due("_host_kill_fired", self.plan.kill_host_at, global_step,
                                    process_index, "host_kill")

    def host_wedge_due(self, global_step: int, process_index: int) -> bool:
        """The same at `wedge_host_at`: the caller hangs without exiting."""
        return self._host_fault_due("_host_wedge_fired", self.plan.wedge_host_at, global_step,
                                    process_index, "host_wedge")

    def checkpoint_should_fail(self) -> bool:
        """True for the first `checkpoint_write_failures` checkpoint saves."""
        return self._take("_ckpt_failures_left", "checkpoint_write")

    # ----------------------------------------------------------- serving
    def serve_corrupt_request(self, index: int, payload):
        """Request `index`'s payload, malformed (wrong shape: a typed
        validation reject) or NaN-poisoned (a typed `nonfinite` reject) at
        the plan's rates; malformed wins where both hit."""
        p = self.plan
        if p.serve_malformed_rate <= 0.0 and p.serve_nan_rate <= 0.0:
            return payload
        roll = np.random.default_rng([p.seed, 0x5E12, int(index)]).random()
        if p.serve_malformed_rate > 0.0 and roll < p.serve_malformed_rate:
            self._count("serve_malformed")
            return np.zeros((3, 3), np.float32)
        if p.serve_nan_rate > 0.0 and roll < p.serve_malformed_rate + p.serve_nan_rate:
            try:
                shape = np.asarray(payload, np.float32).shape
            except (ValueError, TypeError):
                return payload  # already malformed: the validator rejects it
            self._count("serve_nan")
            return np.full(shape, np.nan, np.float32)
        return payload

    def serve_storm_due(self, index: int) -> bool:
        """True for requests inside the deadline-storm window."""
        p = self.plan
        if p.serve_storm_at is None or p.serve_storm_len <= 0:
            return False
        due = p.serve_storm_at <= int(index) < p.serve_storm_at + p.serve_storm_len
        if due:
            self._count("serve_deadline_storm")
        return due

    def _one_shot(self, attr: str, at: Optional[int], index: int, kind: str) -> bool:
        with self._lock:
            due = at is not None and not getattr(self, attr) and int(index) >= int(at)
            if due:
                setattr(self, attr, True)
        if due:
            self._count(kind)
        return due

    def serve_replica_kill_due(self, request_index: int) -> bool:
        """True once, when the admitted-request index reaches
        `serve_replica_kill_at`."""
        return self._one_shot("_replica_kill_fired", self.plan.serve_replica_kill_at,
                              request_index, "serve_replica_kill")

    def serve_replica_wedge_due(self, request_index: int) -> bool:
        """True once, when the admitted-request index reaches `serve_wedge_at`."""
        return self._one_shot("_wedge_fired", self.plan.serve_wedge_at, request_index,
                              "serve_replica_wedge")

    def _take(self, attr: str, kind: str) -> bool:
        with self._lock:
            left = getattr(self, attr)
            if left <= 0:
                return False
            setattr(self, attr, left - 1)
        self._count(kind)
        return True

    def serve_swap_bad_artifact_due(self) -> bool:
        """True for the first `serve_swap_bad_artifact` fleet swaps."""
        return self._take("_bad_swaps_left", "serve_swap_bad_artifact")

    def tenant_storm_due(self, request_index: int) -> bool:
        """True for every request from `tenant_storm_at` on (the drill sends
        them to the storm tenant); counted once."""
        p = self.plan
        if p.tenant_storm_at is None or int(request_index) < int(p.tenant_storm_at):
            return False
        with self._lock:
            counted, self._tenant_storm_counted = self._tenant_storm_counted, True
        if not counted:
            self._count("tenant_storm")
        return True

    def tenant_bad_swap_due(self) -> bool:
        """True for the first `tenant_bad_swap` tenant head swaps."""
        return self._take("_tenant_bad_swaps_left", "tenant_bad_swap")

    def _rate_due(self, rate: float, tag: int, index: int, kind: str) -> bool:
        if rate <= 0.0:
            return False
        hit = bool(np.random.default_rng([self.plan.seed, tag, int(index)]).random() < rate)
        if hit:
            self._count(kind)
        return hit

    def online_poison_due(self, request_index: int) -> bool:
        """Whether request `request_index` becomes low-p(x) mislabeled junk
        (the drill substitutes it; this decides and counts)."""
        return self._rate_due(self.plan.online_poison_rate, 0x0150, request_index,
                              "online_poison")

    def tenant_poison_due(self, request_index: int) -> bool:
        """Whether the storm tenant's request `request_index` (counted over
        that tenant's requests) becomes off-manifold junk."""
        return self._rate_due(self.plan.tenant_poison_rate, 0x7EA7, request_index,
                              "tenant_poison")

    def serve_device_error_due(self, dispatch_index: int) -> bool:
        """True once per listed dispatch index."""
        with self._lock:
            if int(dispatch_index) not in self._serve_errors_left:
                return False
            self._serve_errors_left.discard(int(dispatch_index))
        self._count("serve_device_error")
        return True


_ACTIVE: Optional[ChaosState] = None
_ACTIVE_LOCK = threading.Lock()


def get_active() -> Optional[ChaosState]:
    """The process-active chaos state of the serving plane (None: no chaos)."""
    return _ACTIVE


def set_active(state: Optional[ChaosState]) -> Optional[ChaosState]:
    """Install `state` as process-active; returns the previous one."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, state
    return prev


def install(plan: ChaosPlan) -> ChaosState:
    """Wrap `plan` in a ChaosState and make it process-active."""
    state = ChaosState(plan)
    set_active(state)
    return state


def plan_from_env(environ=None) -> Optional[ChaosPlan]:
    """A plan from the MGPROTO_CHAOS_* knobs; None when none is set (a
    production run pays nothing). A knob the port does not read raises
    ValueError naming the ROADMAP item that ports it; none is ignored."""
    env = os.environ if environ is None else environ
    for name, raw in sorted(env.items()):
        if not name.startswith("MGPROTO_CHAOS_") or raw in ("", None) or name in _READ:
            continue
        item = UNPORTED_KNOBS.get(name, "none: the JAX package has no such knob either")
        raise ValueError(f"{name}={raw!r} is not read by the port; ROADMAP item {item}")

    def _get(name, cast, default):
        raw = env.get(name)
        if raw is None or raw == "":
            return default
        try:
            return cast(raw)
        except ValueError:
            raise ValueError(f"{name}={raw!r} is not a valid {cast.__name__}") from None

    def _int_list(raw: str) -> Tuple[int, ...]:
        return tuple(int(v) for v in raw.split(",") if v.strip() != "")

    plan = ChaosPlan(
        nan_at_step=_get("MGPROTO_CHAOS_NAN_AT_STEP", int, None),
        preempt_at_step=_get("MGPROTO_CHAOS_PREEMPT_AT_STEP", int, None),
        seed=_get("MGPROTO_CHAOS_SEED", int, 0),
        serve_malformed_rate=_get("MGPROTO_CHAOS_SERVE_MALFORMED_RATE", float, 0.0),
        serve_nan_rate=_get("MGPROTO_CHAOS_SERVE_NAN_RATE", float, 0.0),
        serve_device_errors=_get("MGPROTO_CHAOS_SERVE_DEVICE_ERRORS", _int_list, ()),
        serve_storm_at=_get("MGPROTO_CHAOS_SERVE_STORM_AT", int, None),
        serve_storm_len=_get("MGPROTO_CHAOS_SERVE_STORM_LEN", int, 0),
        serve_replica_kill_at=_get("MGPROTO_CHAOS_SERVE_REPLICA_KILL_AT", int, None),
        serve_wedge_at=_get("MGPROTO_CHAOS_SERVE_WEDGE_AT", int, None),
        serve_swap_bad_artifact=_get("MGPROTO_CHAOS_SERVE_SWAP_BAD_ARTIFACT", int, 0),
        tenant_storm_at=_get("MGPROTO_CHAOS_TENANT_STORM_AT", int, None),
        tenant_bad_swap=_get("MGPROTO_CHAOS_TENANT_BAD_SWAP", int, 0),
        online_poison_rate=_get("MGPROTO_CHAOS_ONLINE_POISON_RATE", float, 0.0),
        tenant_poison_rate=_get("MGPROTO_CHAOS_TENANT_POISON_RATE", float, 0.0),
        checkpoint_write_failures=_get("MGPROTO_CHAOS_CKPT_FAILS", int, 0),
        kill_host_at=_get("MGPROTO_CHAOS_KILL_HOST_AT", int, None),
        wedge_host_at=_get("MGPROTO_CHAOS_WEDGE_HOST_AT", int, None),
        host_index=_get("MGPROTO_CHAOS_HOST_INDEX", int, -1),
    )
    return plan if plan.any_active() else None


_READ = frozenset(
    ["MGPROTO_CHAOS_SEED", "MGPROTO_CHAOS_NAN_AT_STEP", "MGPROTO_CHAOS_PREEMPT_AT_STEP",
     "MGPROTO_CHAOS_TENANT_STORM_AT", "MGPROTO_CHAOS_TENANT_BAD_SWAP",
     "MGPROTO_CHAOS_TENANT_POISON_RATE", "MGPROTO_CHAOS_ONLINE_POISON_RATE",
     "MGPROTO_CHAOS_CKPT_FAILS", "MGPROTO_CHAOS_KILL_HOST_AT", "MGPROTO_CHAOS_WEDGE_HOST_AT",
     "MGPROTO_CHAOS_HOST_INDEX"]
    + [f"MGPROTO_CHAOS_SERVE_{k}" for k in (
        "MALFORMED_RATE", "NAN_RATE", "DEVICE_ERRORS", "STORM_AT", "STORM_LEN",
        "REPLICA_KILL_AT", "WEDGE_AT", "SWAP_BAD_ARTIFACT")])
