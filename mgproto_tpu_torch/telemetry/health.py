"""ModelHealth: per-epoch EM and prototype diagnostics of a train state
(counterpart of mgproto_tpu/telemetry/health.py).

MGProto fails in its model health before its loss shows it: prototypes
collapse onto duplicate means, a mixture's prior entropy goes to zero (one
prototype owns a class), banks never fill (EM never fires), sigmas go
degenerate. The math is `core/em.py::em_health_diagnostics` (torch, on the
state's device; imported at the first record, so this module imports no
torch); this class records it: gauges `model_<key>` in the registry and
one JSONL record a call.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from mgproto_tpu_torch.telemetry.registry import JsonlWriter, MetricRegistry, default_registry

_HEALTH_HELP = {
    "prior_entropy_mean": "mean per-class mixture-prior entropy (nats)",
    "prior_entropy_min": "min per-class mixture-prior entropy (nats)",
    "min_interproto_dist": "smallest intra-class inter-prototype distance",
    "collapse_frac": "fraction of intra-class prototype pairs within tol",
    "sigma_floor_frac": "fraction of sigma entries at/below the floor",
    "memory_occupancy": "mean per-class memory-queue fill fraction",
    "memory_full_frac": "fraction of classes with a full memory queue",
    "memory_updated_frac": "fraction of classes touched since last EM",
}


class ModelHealth:
    """Computes and records the diagnostics; `record(state, epoch=...)`
    returns them as floats. `state` is anything with a `gmm` and a
    `memory` holding every class."""

    def __init__(
        self,
        registry: Optional[MetricRegistry] = None,
        writer: Optional[JsonlWriter] = None,
        collapse_tol: float = 1e-3,
        sigma_floor: float = 1e-3,
    ):
        self.registry = registry if registry is not None else default_registry()
        self.writer = writer
        self.collapse_tol = collapse_tol
        self.sigma_floor = sigma_floor
        self.history: list = []

    def record(self, state: Any, epoch: Optional[int] = None, **extra) -> Dict[str, float]:
        import torch

        from mgproto_tpu_torch.core.em import em_health_diagnostics

        vals = em_health_diagnostics(state.gmm, state.memory, collapse_tol=self.collapse_tol,
                                     sigma_floor=self.sigma_floor)
        host = torch.stack(list(vals.values())).double().cpu().tolist()  # one device read
        out = {k: float(v) for k, v in zip(vals, host)}
        for k, v in out.items():
            self.registry.gauge(f"model_{k}", _HEALTH_HELP.get(k, "")).set(v)
        rec: Dict[str, Any] = {"time": time.time()}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        rec.update(extra)
        rec.update(out)
        self.history.append(rec)
        if self.writer is not None:
            self.writer.write(rec)
        return out
