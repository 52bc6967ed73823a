"""Class addition without a new input shape: padded class slots
(counterpart of mgproto_tpu/online/classes.py).

The class count C is a shape of the logits [B, C], the GMM [C, K, d] and
the bank [C, cap, d]. The model is BUILT at C rounded up to
`ModelConfig.class_bucket`, and the padded slots are inert until claimed:

  * a padded slot carries exactly zero priors: `head_forward` maps them to
    -inf logits (the prune convention), so it never wins an argmax and adds
    nothing to p(x); the calibration gives such a column temperature 1.0;
  * `ClassDirectory.add_class` takes the next free slot and `claim_slot`
    raises its priors to 1/K, so EM owns it once its bank fills;
  * the serving buckets, the consolidation batch and every kernel launch
    keep their shapes: a new class is data movement only.

A full bucket refuses the addition with `ClassBucketFull`: growing past it
is a rebuild and a republish, an operator's decision.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import torch

from mgproto_tpu_torch.online import metrics as om


class ClassBucketFull(RuntimeError):
    """Every padded slot is claimed."""


def padded_num_classes(num_classes: int, class_bucket: int) -> int:
    """`num_classes` rounded up to a multiple of `class_bucket` (<= 1: as is)."""
    c, b = int(num_classes), int(class_bucket)
    if b <= 1:
        return c
    return ((c + b - 1) // b) * b


def apply_class_bucket(cfg):
    """The Config with its model at the padded class width; `cfg` itself
    when no padding applies."""
    padded = padded_num_classes(cfg.model.num_classes, cfg.model.class_bucket)
    if padded == cfg.model.num_classes:
        return cfg
    return cfg.replace(model=dataclasses.replace(cfg.model, num_classes=padded))


def floor_padded_priors(gmm, active_classes: int):
    """The GMM with exactly zero priors at every slot >= `active_classes`."""
    c = gmm.priors.shape[0]
    mask = torch.arange(c, device=gmm.priors.device) < int(active_classes)
    return gmm._replace(priors=torch.where(mask[:, None], gmm.priors,
                                           torch.zeros_like(gmm.priors)))


def claim_slot(gmm, slot: int):
    """The GMM with slot `slot`'s priors raised to 1/K (a new copy of the
    priors; the other tensors are shared)."""
    k = gmm.priors.shape[1]
    priors = gmm.priors.clone()
    priors[int(slot)] = 1.0 / k
    return gmm._replace(priors=priors)


class ClassDirectory:
    """Which padded slots are live and the external name each carries.
    Thread-safe: additions come from the operator path while the
    consolidation cadence reads."""

    def __init__(self, base_classes: int, padded_classes: int):
        base, padded = int(base_classes), int(padded_classes)
        if padded < base:
            raise ValueError(f"padded class count {padded} < base {base}")
        self.padded_classes = padded
        self._lock = threading.Lock()
        self._names: Dict[int, str] = {i: f"class{i}" for i in range(base)}
        self._next_free = base
        om.gauge(om.ACTIVE_CLASSES).set(float(base))

    @property
    def active_classes(self) -> int:
        with self._lock:
            return len(self._names)

    @property
    def free_slots(self) -> int:
        with self._lock:
            return self.padded_classes - self._next_free

    def slot_of(self, name: str) -> Optional[int]:
        with self._lock:
            for slot, n in self._names.items():
                if n == name:
                    return slot
        return None

    def add_class(self, name: Optional[str] = None) -> int:
        """Claim the next free padded slot; returns its index. Raises
        ClassBucketFull when none is left."""
        with self._lock:
            if self._next_free >= self.padded_classes:
                raise ClassBucketFull(
                    f"all {self.padded_classes} bucketed class slots are claimed; growing "
                    "further requires rebuilding at the next class_bucket (a new model and "
                    "a republish, not an online addition)")
            slot = self._next_free
            self._next_free += 1
            self._names[slot] = name or f"class{slot}"
            count = len(self._names)
        om.counter(om.CLASS_ADDITIONS).inc()
        om.gauge(om.ACTIVE_CLASSES).set(float(count))
        return slot
