"""ID-score calibration (trimmed copy of mgproto_tpu/serving/calibration.py).

A calibration carries percentile thresholds of held-out ID log p(x), a
101-point quantile sketch, per-class logit temperatures, the compute dtype
the scores were measured under and `gmm_fingerprint`, a digest of the GMM
they were measured against. The trust gate fails closed on a mismatch.

The fingerprint is this package's own: sha256 over the shapes, dtypes and
bytes of means/sigmas/priors/keep. It does not equal the JAX package's
digest (which also hashes a JAX tree structure), so a calibration belongs to
the package that measured it; a JAX calibration served here degrades the
engine instead of gating with it. The JSON format is the same.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

CALIBRATION_FORMAT = "mgproto-calibration-v1"
DEFAULT_PERCENTILES: Tuple[float, ...] = (1.0, 5.0, 10.0)
DEFAULT_PERCENTILE = 5.0
_SKETCH_POINTS = 101


class CalibrationError(ValueError):
    """Malformed/missing/incompatible calibration payload."""


def gmm_fingerprint(gmm) -> str:
    """sha256 over means/sigmas/priors/keep (shape, dtype and exact bytes,
    in that order). EM, push and prune all change it."""
    h = hashlib.sha256(b"mgproto_tpu_torch.GMMState")
    for name in ("means", "sigmas", "priors", "keep"):
        arr = np.ascontiguousarray(getattr(gmm, name).detach().cpu().numpy())
        h.update(f"{name}{arr.shape}{arr.dtype}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Calibration:
    percentile: float
    threshold_log_px: float
    thresholds: Dict[str, float]
    quantile_log_px: Tuple[float, ...]
    per_class_temperature: Tuple[float, ...]
    gmm_fingerprint: str
    num_id_samples: int
    source: str = ""
    compute_dtype: str = ""
    # the JAX package's int8 stamp; this package serves f32 weights only
    quant_config: str = ""

    @staticmethod
    def from_scores(
        id_log_px: np.ndarray,
        id_logits: np.ndarray,
        fingerprint: str,
        percentile: float = DEFAULT_PERCENTILE,
        percentiles: Sequence[float] = DEFAULT_PERCENTILES,
        source: str = "",
        compute_dtype: str = "",
    ) -> "Calibration":
        """From per-sample held-out ID scores: log p(x) [N] and class
        log-likelihoods [N, C], host-side float64."""
        scores = np.asarray(id_log_px, np.float64).ravel()
        if scores.size == 0:
            raise CalibrationError("cannot calibrate from zero ID samples")
        if not np.isfinite(scores).all():
            raise CalibrationError("non-finite ID log p(x) scores")
        pcts = sorted(set(float(p) for p in percentiles) | {float(percentile)})
        thresholds = {f"{p:g}": float(np.percentile(scores, p)) for p in pcts}
        sketch = tuple(
            float(v)
            for v in np.percentile(scores, np.linspace(0.0, 100.0, _SKETCH_POINTS))
        )
        logits = np.asarray(id_logits, np.float64)
        finite_cols = np.isfinite(logits).all(axis=0)
        temps = np.ones(logits.shape[1], np.float64)
        if finite_cols.any():
            stds = np.maximum(logits[:, finite_cols].std(axis=0), 1e-6)
            temps[finite_cols] = stds / float(stds.mean())
        return Calibration(
            percentile=float(percentile),
            threshold_log_px=thresholds[f"{float(percentile):g}"],
            thresholds=thresholds,
            quantile_log_px=sketch,
            per_class_temperature=tuple(float(t) for t in temps),
            gmm_fingerprint=str(fingerprint),
            num_id_samples=int(scores.size),
            source=source,
            compute_dtype=str(compute_dtype),
        )

    def id_quantile_of(self, log_px: float) -> float:
        """Where a score sits in the ID distribution (0..1)."""
        q = np.linspace(0.0, 1.0, len(self.quantile_log_px))
        return float(np.interp(log_px, self.quantile_log_px, q))

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["format"] = CALIBRATION_FORMAT
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @staticmethod
    def from_dict(d: Dict) -> "Calibration":
        if d.get("format") != CALIBRATION_FORMAT:
            raise CalibrationError(f"unknown calibration format {d.get('format')!r}")
        try:
            return Calibration(
                percentile=float(d["percentile"]),
                threshold_log_px=float(d["threshold_log_px"]),
                thresholds={k: float(v) for k, v in d["thresholds"].items()},
                quantile_log_px=tuple(float(v) for v in d["quantile_log_px"]),
                per_class_temperature=tuple(float(t) for t in d["per_class_temperature"]),
                gmm_fingerprint=str(d["gmm_fingerprint"]),
                num_id_samples=int(d["num_id_samples"]),
                source=str(d.get("source", "")),
                compute_dtype=str(d.get("compute_dtype", "")),
                quant_config=str(d.get("quant_config", "")),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise CalibrationError(f"malformed calibration payload: {e}")

    @staticmethod
    def from_json(text: str) -> "Calibration":
        try:
            d = json.loads(text)
        except ValueError as e:
            raise CalibrationError(f"calibration is not valid JSON: {e}")
        return Calibration.from_dict(d)


def calibrate(evaluator, id_batches: Iterable, percentile: float = DEFAULT_PERCENTILE,
              source: str = "") -> Calibration:
    """A Calibration from held-out ID image batches ([b, H, W, 3] each),
    scored through the same Evaluator the engine serves with."""
    px, logits = [], []
    for images in id_batches:
        out = evaluator(images)
        px.append(out.log_px.cpu().numpy())
        logits.append(out.logits.cpu().numpy())
    return Calibration.from_scores(
        np.concatenate(px), np.concatenate(logits),
        fingerprint=gmm_fingerprint(evaluator.gmm),
        percentile=percentile,
        source=source,
        compute_dtype=evaluator.cfg.model.compute_dtype,
    )
