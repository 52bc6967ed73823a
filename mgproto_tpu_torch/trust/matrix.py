"""The serving-path robustness matrix: OoD pairs x the corruption ladder,
gated (counterpart of mgproto_tpu/trust/matrix.py).

The paper's trust claims are properties of the deployed decision function:
calibrated thresholds, typed predict/abstain outcomes, pad-to-bucket
batches. So every cell runs through the port's ServingEngine (warmed
buckets, calibration, TrustGate, typed responses), not a bespoke loop; on
the card each dispatch runs the score_pool and epilogue kernels.

Cells:
  * the clean-ID cell: the coverage and accuracy anchor, and the
    calibration-drift probe (the served log p(x) against the calibration's
    own quantile sketch);
  * one cell per ID x OoD dataset pair: the pair's AUROC over served
    log p(x) (`binary_auroc`) and the abstention contrast;
  * one cell per (corruption kind, severity 1..5) of the ID set
    (ops/corrupt.py, run on the engine's device one chunk at a time, seeds
    offset by the row): the risk-coverage curve.

Requests go in bucket-sized chunks with ids "<cell>:<row>"; the report
keeps per-sample scalars only (scores rounded to `score_decimals`,
outcomes), never images, and the raw numbers beside the derived rates, so
`cli/telemetry.py::trust_gates` re-derives every verdict and a tampered
rate or AUROC is caught against its own raw data. `steady_state_recompiles`
keeps the JAX key; here it is the engine's dispatches at an unwarmed bucket
(`check_cold_dispatches`), taken after warmup and at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from mgproto_tpu_torch.serving.response import OUTCOME_ABSTAIN, OUTCOME_PREDICT
from mgproto_tpu_torch.trust import metrics as _tm
from mgproto_tpu_torch.trust.auroc import binary_auroc

TRUST_REPORT_FORMAT = "mgproto-trust-report-v1"


@dataclasses.dataclass(frozen=True)
class MatrixConfig:
    """The ladder's shape and the floors the check holds the report to. The
    floors are part of the report (its config block): the check re-derives
    the raw numbers and holds them to the bar the run states."""

    kinds: Tuple[str, ...] = ("noise", "blur", "contrast", "pixelate")
    severities: Tuple[int, ...] = (1, 2, 3, 4, 5)
    seed: int = 0
    auroc_floor: float = 0.70  # every ID x OoD pair must separate this well
    answered_accuracy_floor: float = 0.70  # at every severity
    monotone_tol: float = 0.02  # abstention may dip this much between rungs
    px_divergence_limit: float = 0.25  # clean-ID served-vs-calibration drift
    auroc_rederive_tol: float = 1e-9  # recorded vs re-derived (tamper bound)
    score_decimals: int = 5  # stored per-sample score precision


def px_sketch_divergence(scores: np.ndarray, calibration) -> Optional[float]:
    """Mean |served quantile - calibration quantile| over the interior
    sketch points, in calibration-IQR units (online/drift.py's units). None
    without scores or with a degenerate sketch."""
    s = np.asarray(scores, np.float64).ravel()
    if s.size == 0 or calibration is None:
        return None
    ref = np.asarray(calibration.quantile_log_px, np.float64)
    iqr = ref[75] - ref[25] if ref.size >= 101 else float(np.ptp(ref))
    if not np.isfinite(iqr) or iqr <= 0:
        return None
    qs = np.linspace(0.0, 100.0, ref.size)[1:-1]  # interior points
    served = np.percentile(s, qs)
    return float(np.mean(np.abs(served - ref[1:-1])) / iqr)


def _cell_from_responses(responses, labels: Optional[np.ndarray],
                         decimals: int) -> Dict[str, Any]:
    """One cell's raw accounting from its typed responses: outcome counts,
    correct-on-answered, and the served log p(x) of the gated outcomes
    (rejects and sheds carry no score)."""
    outcomes: Dict[str, int] = {}
    scores: List[float] = []
    answered = correct = 0
    for i, r in enumerate(responses):
        outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1
        if r.log_px is not None:
            scores.append(round(float(r.log_px), decimals))
        if r.outcome == OUTCOME_PREDICT:
            answered += 1
            if labels is not None and r.prediction == int(labels[i]):
                correct += 1
    gated = outcomes.get(OUTCOME_PREDICT, 0) + outcomes.get(OUTCOME_ABSTAIN, 0)
    return {
        "n": len(responses),
        "outcomes": outcomes,
        "answered": answered,
        "correct_answered": correct if labels is not None else None,
        # derived for the reader; the check re-derives them from the raws
        "abstain_rate": outcomes.get(OUTCOME_ABSTAIN, 0) / gated if gated else None,
        "answered_accuracy": (correct / answered
                              if (labels is not None and answered) else None),
        "scores": scores,
    }


def serve_cell(engine, images: np.ndarray, labels: Optional[np.ndarray] = None,
               request_prefix: str = "cell", deadline_s: Optional[float] = None,
               decimals: int = 5) -> Dict[str, Any]:
    """One cell through the engine in bucket-sized chunks, accounted. Every
    submitted request must come back exactly once: `submitted` and
    `returned` ride in the cell."""
    chunk = engine.buckets[-1]
    responses = []
    submitted = 0
    for lo in range(0, len(images), chunk):
        part = images[lo:lo + chunk]
        ids = [f"{request_prefix}:{lo + i}" for i in range(len(part))]
        submitted += len(part)
        responses.extend(engine.serve_all(list(part), deadline_s=deadline_s, request_ids=ids))
    cell = _cell_from_responses(responses, labels, decimals)
    cell["submitted"] = submitted
    cell["returned"] = len(responses)
    return cell


def corrupt_chunks(images: np.ndarray, kind: str, severity: int, seed: int, chunk: int,
                   device) -> np.ndarray:
    """The ID set corrupted one `chunk` at a time on `device`, the seeds of
    a chunk offset by its first row; back as a host f32 array."""
    import torch

    from mgproto_tpu_torch.ops.corrupt import make_corrupt_fn, per_sample_seeds

    fn = make_corrupt_fn(kind, int(severity))
    out = np.empty_like(images)
    for lo in range(0, len(images), chunk):
        part = torch.from_numpy(images[lo:lo + chunk]).to(device)
        seeds = per_sample_seeds(seed, len(part), offset=lo)
        out[lo:lo + len(part)] = fn(part, seeds).cpu().numpy()
    return out


def run_matrix(engine, id_images: np.ndarray, id_labels: np.ndarray,
               ood_sets: Dict[str, np.ndarray], config: MatrixConfig = MatrixConfig(),
               interp: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """The whole matrix as one report dict (module docstring). `engine`: a
    calibrated ServingEngine, warmed here if it was not; the ladder corrupts
    its chunks on the engine's device (CUDA when the engine does not know
    its own). `interp` merges an interpretability record into the report."""
    from mgproto_tpu_torch.cli.telemetry import trust_gates
    from mgproto_tpu_torch.numerics import resolve_device

    device = resolve_device(engine.device)
    if not engine.warmed_up:
        engine.warmup()
    # steady state begins after warmup
    engine.check_cold_dispatches()

    id_images = np.ascontiguousarray(id_images, np.float32)
    id_labels = np.asarray(id_labels)
    decimals = config.score_decimals
    calibration = engine.gate.calibration
    report: Dict[str, Any] = {
        "trust_report": True,
        "format": TRUST_REPORT_FORMAT,
        "config": {
            "kinds": list(config.kinds),
            "severities": [int(s) for s in config.severities],
            "seed": int(config.seed),
            "auroc_floor": config.auroc_floor,
            "answered_accuracy_floor": config.answered_accuracy_floor,
            "monotone_tol": config.monotone_tol,
            "px_divergence_limit": config.px_divergence_limit,
            "auroc_rederive_tol": config.auroc_rederive_tol,
            "buckets": [int(b) for b in engine.buckets],
            "percentile": calibration.percentile if calibration is not None else None,
            "threshold_log_px": engine.gate.threshold if calibration is not None else None,
        },
    }

    # the clean-ID anchor and the calibration-drift probe
    id_cell = serve_cell(engine, id_images, id_labels, request_prefix="id", decimals=decimals)
    id_cell["px_divergence"] = px_sketch_divergence(np.asarray(id_cell["scores"]), calibration)
    report["id"] = id_cell
    _tm.counter(_tm.MATRIX_CELLS).inc(kind="id")
    _tm.gauge(_tm.ABSTENTION_RATE).set(id_cell["abstain_rate"] or 0.0, cell="id:0")
    if id_cell["answered_accuracy"] is not None:
        _tm.gauge(_tm.ANSWERED_ACCURACY).set(id_cell["answered_accuracy"], cell="id:0")
    if id_cell["px_divergence"] is not None:
        _tm.gauge(_tm.PX_DIVERGENCE).set(id_cell["px_divergence"])

    # the ID x OoD pairs
    pairs = []
    id_scores = np.asarray(id_cell["scores"], np.float64)
    for name in sorted(ood_sets):
        cell = serve_cell(engine, np.asarray(ood_sets[name], np.float32), None,
                          request_prefix=f"ood:{name}", decimals=decimals)
        cell["pair"] = name
        cell["auroc"] = binary_auroc(id_scores, np.asarray(cell["scores"], np.float64))
        pairs.append(cell)
        _tm.counter(_tm.MATRIX_CELLS).inc(kind="ood")
        _tm.gauge(_tm.PAIR_AUROC).set(cell["auroc"], pair=name)
        _tm.gauge(_tm.ABSTENTION_RATE).set(cell["abstain_rate"] or 0.0, cell=f"ood:{name}")
    report["pairs"] = pairs

    # the corruption ladder: a risk-coverage curve per kind
    ladder: Dict[str, List[Dict[str, Any]]] = {}
    for kind in config.kinds:
        rows = []
        for severity in config.severities:
            corrupted = corrupt_chunks(id_images, kind, severity, config.seed,
                                       engine.buckets[-1], device)
            cell = serve_cell(engine, corrupted, id_labels,
                              request_prefix=f"{kind}:{severity}", decimals=decimals)
            cell["severity"] = int(severity)
            rows.append(cell)
            _tm.counter(_tm.MATRIX_CELLS).inc(kind=kind)
            _tm.gauge(_tm.ABSTENTION_RATE).set(cell["abstain_rate"] or 0.0,
                                               cell=f"{kind}:{severity}")
            if cell["answered_accuracy"] is not None:
                _tm.gauge(_tm.ANSWERED_ACCURACY).set(cell["answered_accuracy"],
                                                     cell=f"{kind}:{severity}")
        ladder[kind] = rows
    report["ladder"] = ladder

    # the serving path's invariants, from the engine itself
    report["steady_state_recompiles"] = int(engine.check_cold_dispatches())
    report["degraded"] = bool(engine.gate.degraded)
    if interp:
        report["interp"] = dict(interp)
        for key, gname in (("consistency", _tm.INTERP_CONSISTENCY),
                           ("stability", _tm.INTERP_STABILITY),
                           ("purity", _tm.INTERP_PURITY)):
            if isinstance(interp.get(key), (int, float)):
                _tm.gauge(gname).set(float(interp[key]))

    # the same derivations `check --trust` applies, for the reader
    report["gates"] = trust_gates(report)
    for row in report["gates"]["rows"]:
        _tm.counter(_tm.VERDICTS).inc(result="pass" if row["ok"] else "fail")
    return report
