"""Deterministic fault injection for the training drills (the training
subset of mgproto_tpu/resilience/chaos.py).

Two one-shot events, keyed by the global step: a NaN batch
(`nan_at_step`) and a simulated preemption (`preempt_at_step`).
`EpochGuard.wrap_batches` applies them to the placed batch of that step:
the preemption raises the same flag a real SIGTERM sets, and the NaN batch
is poisoned on its device (the JAX package poisons the host images before
placement; the port's uint8 wire has no NaN, so there the augmentation
draws carry it). The step itself is the same with chaos on or off. The one-shot
state lives in the `ChaosState`, so a rollback that replays the same steps
does not inject again; that is what lets a drill end bit-equal to the
clean run.

`plan_from_env` reads MGPROTO_CHAOS_NAN_AT_STEP and
MGPROTO_CHAOS_PREEMPT_AT_STEP, and refuses every other MGPROTO_CHAOS_*
knob of the JAX package, naming the ROADMAP item that ports it. That
includes MGPROTO_CHAOS_SEED: it seeds the JAX package's random events
(loader and checkpoint faults), and neither event here draws anything.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional

import torch

# the JAX package's knobs the port does not read yet, by the ROADMAP item
# that ports them
UNPORTED_KNOBS: Dict[str, str] = {
    **{k: "A9 (resilience: the loader's and the checkpoint's chaos injection)"
       for k in ("MGPROTO_CHAOS_SEED", "MGPROTO_CHAOS_LOADER_IO_RATE",
                 "MGPROTO_CHAOS_LOADER_IO_FAILS", "MGPROTO_CHAOS_CKPT_FAILS")},
    **{k: "A8 (multi-GPU: the multi-host drills)"
       for k in ("MGPROTO_CHAOS_KILL_HOST_AT", "MGPROTO_CHAOS_WEDGE_HOST_AT",
                 "MGPROTO_CHAOS_SLOW_HOST_MS", "MGPROTO_CHAOS_HOST_INDEX")},
    "MGPROTO_CHAOS_ONLINE_POISON_RATE": "A9 (online learning)",
}
_PORTED = ("MGPROTO_CHAOS_NAN_AT_STEP", "MGPROTO_CHAOS_PREEMPT_AT_STEP")
_SERVING = ("MGPROTO_CHAOS_SERVE_", "MGPROTO_CHAOS_TENANT_")


@dataclasses.dataclass
class ChaosPlan:
    """What to inject. All off by default."""

    # one-shot: NaN images in the batch whose train step has this global index
    nan_at_step: Optional[int] = None
    # one-shot: a simulated SIGTERM when the batch of this global step is drawn
    preempt_at_step: Optional[int] = None

    def any_active(self) -> bool:
        return self.nan_at_step is not None or self.preempt_at_step is not None


class ChaosState:
    """A plan and its one-shot bookkeeping (thread-safe). `injections`
    counts what fired, by kind."""

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._nan_fired = False
        self._preempt_fired = False
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


def plan_from_env(environ=None) -> Optional[ChaosPlan]:
    """A plan from the MGPROTO_CHAOS_* knobs; None when none is set (a
    production run pays nothing). A knob the port does not read raises
    ValueError naming the ROADMAP item that ports it; none is ignored."""
    env = os.environ if environ is None else environ
    for name, raw in sorted(env.items()):
        if not name.startswith("MGPROTO_CHAOS_") or raw in ("", None) or name in _PORTED:
            continue
        if name in UNPORTED_KNOBS:
            item = UNPORTED_KNOBS[name]
        elif name.startswith(_SERVING):
            item = "A7 (the serving plane's chaos injection)"
        else:
            item = "none: the JAX package has no such knob either"
        raise ValueError(f"{name}={raw!r} is not read by the port; ROADMAP item {item}")

    def _get(name, default):
        raw = env.get(name)
        if raw is None or raw == "":
            return default
        try:
            return int(raw)
        except ValueError:
            raise ValueError(f"{name}={raw!r} is not a valid int") from None

    plan = ChaosPlan(
        nan_at_step=_get("MGPROTO_CHAOS_NAN_AT_STEP", None),
        preempt_at_step=_get("MGPROTO_CHAOS_PREEMPT_AT_STEP", None),
    )
    return plan if plan.any_active() else None
