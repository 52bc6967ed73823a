"""Top-T spatial mining pool in log domain (counterpart of mgproto_tpu/ops/pooling.py)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PooledActivations(NamedTuple):
    """log_act [B, C, K, T] top-T log-densities (sorted desc); top1_idx
    [B, C, K] flat spatial index (h * W + w) of each prototype's best patch;
    top1_feat [B, C, K, d] the feature vector there."""

    log_act: torch.Tensor
    top1_idx: torch.Tensor
    top1_feat: torch.Tensor


def top_t(x: torch.Tensor, t: int):
    """Top-t along the last axis, sorted descending, ties to the LOWEST
    index — `lax.top_k`'s order. `torch.topk` promises no order among ties,
    so this is a stable descending sort cut to its first t entries."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :t], idx[..., :t]


def top_t_pool(
    log_prob: torch.Tensor, features: torch.Tensor, mine_T: int
) -> PooledActivations:
    """log_prob [B, C, K, H, W] per-patch log-densities; features [B, H, W, d]."""
    b, c, k, h, w = log_prob.shape
    vals, idx = top_t(log_prob.reshape(b, c, k, h * w), mine_T)
    top1 = idx[..., 0]
    feats_flat = features.reshape(b, h * w, -1)
    gathered = torch.gather(
        feats_flat, 1,
        top1.reshape(b, c * k, 1).expand(-1, -1, feats_flat.shape[-1]),
    )
    return PooledActivations(
        log_act=vals, top1_idx=top1, top1_feat=gathered.reshape(b, c, k, -1)
    )


def one_hot_rows(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[B, C] bool, `jax.nn.one_hot`'s rows: a label outside [0, C), such as
    the loader's sentinel -1, gives a zero row (torch's one_hot raises)."""
    return labels.long()[:, None] == torch.arange(num_classes, device=labels.device)


def mine_mask_activations(
    log_act: torch.Tensor, labels: Optional[torch.Tensor]
) -> torch.Tensor:
    """Hard-mining mask: non-ground-truth prototypes keep their top-1
    activation at every level, ground-truth ones their t-th best.
    log_act [B, C, K, T]; labels [B] or None (eval: unchanged). A label
    outside [0, C), the loader's sentinel -1, has no ground-truth class: its
    row keeps the top-1 everywhere (`one_hot_rows`)."""
    if labels is None:
        return log_act
    c = log_act.shape[1]
    is_gt = one_hot_rows(labels, c)
    keep = is_gt[:, :, None, None]
    return torch.where(keep, log_act, log_act[..., :1].expand_as(log_act))


def dedup_first_occurrence(idx: torch.Tensor) -> torch.Tensor:
    """[..., K] bool mask, True where idx[i] != idx[j] for all j < i."""
    k = idx.shape[-1]
    eq = idx[..., :, None] == idx[..., None, :]
    earlier = torch.ones(k, k, dtype=torch.bool, device=idx.device).tril(-1)
    return ~(eq & earlier).any(-1)
