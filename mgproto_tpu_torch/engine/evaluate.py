"""Test and OoD passes (counterpart of mgproto_tpu/engine/evaluate.py).

`evaluate`: accuracy, mean CE and the mean prototype pair distance.
`evaluate_with_ood`: an OoD threshold from the ID test set's scores and, per
OoD set, the fraction of its samples scored in-distribution (`FPR95_i`),
its AUROC against the ID set, and the AUROC of other scoring rules.

One process, so nothing is gathered across hosts. Each batch runs through
`Trainer.eval_step` (the state's model in eval mode under inference mode,
its train mode put back after; on CUDA the score_pool and BN epilogue
kernels); per-sample scores come back to the host, where the loader's pad
rows (label -1) are dropped and the percentile and CE bookkeeping runs in
float64 numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from mgproto_tpu_torch.core.mgproto import GMMState
from mgproto_tpu_torch.trust.auroc import binary_auroc


def prototype_pair_distance(gmm: GMMState) -> float:
    """Mean pairwise squared distance over ALL prototypes, the zero diagonal
    included in the mean (the reference's `list_of_distances`)."""
    means = gmm.means.detach().cpu().numpy()
    p = means.astype(np.float64).reshape(-1, means.shape[-1])
    sq = (p**2).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (p @ p.T)
    return float(np.maximum(d2, 0.0).mean())


def _run_eval(trainer, state, batches) -> Tuple[np.ndarray, np.ndarray, float, int, np.ndarray]:
    """One forward per batch: (per-sample log p(x), per-sample correct
    flags, CE summed over batches, the count of batches with a labelled row,
    the per-sample class log-likelihood matrix [N, C]).

    A batch is a bare image array (unlabelled OoD) or a tuple (images,
    labels[, ids, ...]); rows with label -1 (the loader's pad and sentinel
    rows) are dropped here."""
    log_pxs, corrects, valids, logit_rows = [], [], [], []
    ce_total, n_batches = 0.0, 0
    for batch in batches:
        if isinstance(batch, tuple):
            images, labels = batch[0], np.asarray(batch[1])
        else:
            images, labels = batch, None
        out = trainer.eval_step(state, images, labels)
        logits = out.logits.cpu().numpy().astype(np.float64)
        if labels is None:
            valid = np.ones(logits.shape[0], bool)
        else:
            valid = labels >= 0
            lse = _logsumexp(logits)
            lbl = np.where(valid, labels, 0)
            if valid.any():
                ce_total += float(np.mean((lse - logits[np.arange(len(lbl)), lbl])[valid]))
                n_batches += 1
        log_pxs.append(out.log_px.cpu().numpy())
        corrects.append(out.correct.cpu().numpy())
        valids.append(valid)
        logit_rows.append(logits)
    n_c = int(state.gmm.num_classes)
    log_px = np.concatenate(log_pxs) if log_pxs else np.zeros((0,), np.float32)
    correct = np.concatenate(corrects) if corrects else np.zeros((0,), bool)
    valid = np.concatenate(valids) if valids else np.zeros((0,), bool)
    logits_all = np.concatenate(logit_rows) if logit_rows else np.zeros((0, n_c))
    return log_px[valid], correct[valid].astype(bool), ce_total, n_batches, logits_all[valid]


def evaluate(trainer, state, batches, log=print) -> Tuple[float, Dict]:
    """Accuracy pass over (images, labels[, ids]) host batches. Returns
    (accuracy, {'acc', 'cross_entropy', 'p_avg_pair_dist'})."""
    _, correct, ce_total, n_batches, _ = _run_eval(trainer, state, batches)
    acc = float(correct.mean()) if correct.size else 0.0
    pdist = prototype_pair_distance(state.gmm)
    log(f"\ttest acc: \t\t{acc * 100}%")
    log(f"\tp dist pair: \t{pdist}")
    return acc, {
        "acc": acc,
        "cross_entropy": ce_total / max(n_batches, 1),
        "p_avg_pair_dist": pdist,
    }


def evaluate_with_ood(
    trainer,
    state,
    id_batches,
    ood_batch_iters: Sequence[Iterable],
    percentile: float = 5.0,
    score_rule: str = "sum",
    log=print,
) -> Tuple[float, Dict]:
    """OoD pass. The threshold is the `percentile`-th percentile of the ID
    set's score, and `FPR95_i` the fraction of OoD set i scored above it.

    `score_rule`:
      "sum"   (default, the reference's) thresholds SUM_c p(x|c) of the ID
              set in exp space but scores each OoD sample by its MEAN_c
              p(x|c): a C-fold asymmetry kept for parity;
      "max"   max_c log p(x|c) on both sides, in log space;
      "paper" log p(x) on both sides.
    `ood_thresh` is an exp-space density for "sum", a log-density otherwise.
    `AUROC_i` (on log p(x)) and `score_variants_i` (`ood_score_variants`)
    come from the same forward pass."""
    if score_rule not in ("sum", "max", "paper"):
        raise ValueError(f"score_rule must be 'sum', 'max' or 'paper', got {score_rule!r}")
    id_log_px, correct, _, _, id_logits = _run_eval(trainer, state, id_batches)
    acc = float(correct.mean()) if correct.size else 0.0
    log(f"\tTest Acc: \t{acc * 100}")

    num_classes = state.gmm.num_classes
    # float64 on the host for a stable percentile; "max" and "paper" stay in
    # log space, where exp would underflow to 0 below about -745
    if score_rule == "sum":
        id_score = np.exp(id_log_px.astype(np.float64))
    elif score_rule == "paper":
        id_score = id_log_px.astype(np.float64)
    else:
        id_score = id_logits.max(-1)
    ood_thresh = float(np.percentile(id_score, percentile))

    results: Dict = {"acc": acc, "ood_thresh": ood_thresh, "score_rule": score_rule}
    for i, ood_batches in enumerate(ood_batch_iters, start=1):
        ood_log_px, _, _, _, ood_logits = _run_eval(trainer, state, ood_batches)
        if score_rule == "sum":
            ood_score = np.exp(ood_log_px.astype(np.float64)) / num_classes
        elif score_rule == "paper":
            ood_score = ood_log_px.astype(np.float64)
        else:
            ood_score = ood_logits.max(-1)
        fpr = float((ood_score > ood_thresh).mean()) if ood_score.size else 0.0
        results[f"FPR95_{i}"] = fpr
        log(f"\tFPR95_{i}: \t{fpr}")
        if ood_log_px.size:
            auroc = binary_auroc(id_log_px, ood_log_px)
            results[f"AUROC_{i}"] = auroc
            log(f"\tAUROC_{i}: \t{auroc}")
            results[f"score_variants_{i}"] = {
                k: round(v, 6) for k, v in ood_score_variants(id_logits, ood_logits).items()
            }
            log(f"\tscore_variants_{i}: \t{results[f'score_variants_{i}']}")
    return acc, results


def _logsumexp(x: np.ndarray, axis: int = -1) -> np.ndarray:
    m = x.max(axis=axis, keepdims=True)
    return (m + np.log(np.exp(x - m).sum(axis=axis, keepdims=True))).squeeze(axis)


def ood_score_variants(
    id_logits: np.ndarray,
    ood_logits: np.ndarray,
    temperatures: Sequence[float] = (0.5, 2.0, 5.0),
) -> Dict[str, float]:
    """AUROC of OoD scoring rules over class log-likelihood matrices [N, C]:
      sum    log sum_c p(x|c);
      max    max_c log p(x|c);
      temp_T T * log sum_c exp(log p(x|c) / T)."""
    out: Dict[str, float] = {}

    def auroc_of(fn) -> float:
        return binary_auroc(fn(id_logits), fn(ood_logits))

    out["sum"] = auroc_of(lambda L: _logsumexp(L))
    out["max"] = auroc_of(lambda L: L.max(-1))
    for t in temperatures:
        out[f"temp_{t:g}"] = auroc_of(lambda L: t * _logsumexp(L / t))
    return out
