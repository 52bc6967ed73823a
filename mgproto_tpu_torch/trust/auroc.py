"""Midrank AUROC, numpy only (the port's copy of mgproto_tpu/trust/auroc.py).

AUROC = P(pos > neg) + 0.5 P(pos == neg), the Mann-Whitney U statistic on
midranks: exact tie handling, no sklearn."""

from __future__ import annotations

import numpy as np


def binary_auroc(pos_scores: np.ndarray, neg_scores: np.ndarray) -> float:
    """AUROC of positive over negative scores; nan when either side is empty."""
    pos = np.asarray(pos_scores, np.float64).ravel()
    neg = np.asarray(neg_scores, np.float64).ravel()
    if not pos.size or not neg.size:
        return float("nan")
    both = np.concatenate([pos, neg])
    order = np.argsort(both, kind="mergesort")
    ranks = np.empty_like(both)
    ranks[order] = np.arange(1, both.size + 1, dtype=np.float64)
    # midranks for ties
    sorted_vals = both[order]
    i = 0
    while i < sorted_vals.size:
        j = i
        while j + 1 < sorted_vals.size and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    u = ranks[: pos.size].sum() - pos.size * (pos.size + 1) / 2.0
    return float(u / (pos.size * neg.size))
