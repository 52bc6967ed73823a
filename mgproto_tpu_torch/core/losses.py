"""Classification and auxiliary losses (counterpart of mgproto_tpu/core/losses.py).

Cross-entropy on the class log-likelihoods, the mining loss over levels
t >= 1, and the six aux losses on the embedding (`AUX_LOSSES`, chosen by
`LossConfig.aux_loss`): Proxy-Anchor (the default) and Proxy-NCA, which
train proxies (`PROXY_BASED`), and the pair losses Multi-Similarity,
contrastive, semihard triplet and N-pair. Each is the JAX function's
arithmetic op for op.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mgproto_tpu_torch.core.mgproto import l2_normalize
from mgproto_tpu_torch.ops.pooling import one_hot_rows


def wrap_labels(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Labels as the JAX package gathers with them: `take_along_axis` wraps a
    negative index, so the loader's sentinel label -1 reads class C-1.

    This copies a JAX quirk on purpose: a sentinel row (zero image, label
    -1) trains its CE terms toward class C-1, as it does there. Parity with
    the JAX step is the contract."""
    labels = labels.long()
    return torch.where(labels < 0, labels + num_classes, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax CE over class log-likelihoods [B, C]; label -1 reads C-1
    (`wrap_labels`)."""
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(1, wrap_labels(labels, logits.shape[-1])[:, None]).mean()


def mine_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over mining levels t >= 1 of logits [B, C, T]; label -1 reads
    C-1 (`wrap_labels`)."""
    t = logits.shape[-1]
    if t <= 1:
        return logits.new_zeros(())
    lp = torch.log_softmax(logits[..., 1:], dim=1)  # [B, C, T-1]
    idx = wrap_labels(labels, logits.shape[1])[:, None, None].expand(-1, 1, t - 1)
    return -lp.gather(1, idx).mean()


def init_proxies(generator: torch.Generator, num_classes: int, sz_embed: int) -> torch.Tensor:
    """Kaiming-normal proxies, std sqrt(2 / sz_embed), drawn on the CPU."""
    return torch.randn(num_classes, sz_embed, generator=generator) * math.sqrt(2.0 / sz_embed)


def proxy_anchor(
    embeddings: torch.Tensor, labels: torch.Tensor, proxies: torch.Tensor,
    margin: float = 0.1, beta: float = 32.0,
) -> torch.Tensor:
    """Proxy-Anchor loss (Kim et al., CVPR 2020): the positive term averages
    over proxies with positives in the batch, the negative term over all
    classes. A label -1 row has no positive (`one_hot_rows`)."""
    num_classes = proxies.shape[0]
    cos = l2_normalize(embeddings) @ l2_normalize(proxies).T  # [B, C]
    pos_mask = one_hot_rows(labels, num_classes).to(cos.dtype)
    neg_mask = 1.0 - pos_mask
    pos_exp = torch.exp(-beta * (cos - margin))
    neg_exp = torch.exp(beta * (cos + margin))
    with_pos = pos_mask.sum(0) > 0  # [C]
    num_valid = torch.clamp_min(with_pos.sum(), 1)
    p_sim_sum = (pos_exp * pos_mask).sum(0)
    n_sim_sum = (neg_exp * neg_mask).sum(0)
    pos_term = (torch.log1p(p_sim_sum) * with_pos).sum() / num_valid
    neg_term = torch.log1p(n_sim_sum).sum() / num_classes
    return pos_term + neg_term


def proxy_nca(
    embeddings: torch.Tensor, labels: torch.Tensor, proxies: torch.Tensor,
    softmax_scale: float = 32.0,
) -> torch.Tensor:
    """Proxy-NCA (Movshovitz-Attias et al., ICCV 2017): CE over scaled
    negative squared distances to the L2-normalized proxies."""
    x = l2_normalize(embeddings)
    p = l2_normalize(proxies)
    d2 = ((x[:, None, :] - p[None, :, :]) ** 2).sum(-1)  # [B, C]
    return cross_entropy(-softmax_scale * d2, labels)


class _PairMasks(NamedTuple):
    pos: torch.Tensor  # [B, B] same label, i != j
    neg: torch.Tensor  # [B, B] different label


def _pair_masks(labels: torch.Tensor) -> _PairMasks:
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    return _PairMasks(pos=same & ~eye, neg=~same)


def _pair_dists(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [B, B], the squared sum floored at 1e-12."""
    return torch.sqrt(torch.clamp_min(((x[:, None] - x[None, :]) ** 2).sum(-1), 1e-12))


def multi_similarity(
    embeddings: torch.Tensor, labels: torch.Tensor, thresh: float = 0.5,
    epsilon: float = 0.1, scale_pos: float = 2.0, scale_neg: float = 50.0,
) -> torch.Tensor:
    """Multi-Similarity loss with its pair miner (Wang et al., CVPR 2019)."""
    x = l2_normalize(embeddings)
    s = x @ x.T  # [B, B]
    m = _pair_masks(labels)
    neg_inf = torch.finfo(s.dtype).min
    # the miner: negatives harder than (min pos sim - eps), positives harder
    # than (max neg sim + eps)
    min_pos = torch.where(m.pos, s, torch.full_like(s, -neg_inf)).amin(1)  # [B]
    max_neg = torch.where(m.neg, s, torch.full_like(s, neg_inf)).amax(1)
    pos_keep = m.pos & (s < (max_neg + epsilon)[:, None])
    neg_keep = m.neg & (s > (min_pos - epsilon)[:, None])
    pos_sum = (torch.exp(-scale_pos * (s - thresh)) * pos_keep).sum(1)
    neg_sum = (torch.exp(scale_neg * (s - thresh)) * neg_keep).sum(1)
    has_any = (pos_keep.sum(1) > 0) | (neg_keep.sum(1) > 0)
    per_anchor = torch.log1p(pos_sum) / scale_pos + torch.log1p(neg_sum) / scale_neg
    return (per_anchor * has_any).sum() / torch.clamp_min(has_any.sum(), 1)


def contrastive(
    embeddings: torch.Tensor, labels: torch.Tensor, pos_margin: float = 0.0,
    neg_margin: float = 0.5,
) -> torch.Tensor:
    """Pairwise contrastive loss on euclidean distances (Hadsell et al. 2006)."""
    d = _pair_dists(embeddings)
    m = _pair_masks(labels)
    pos = torch.clamp_min(d - pos_margin, 0.0)
    neg = torch.clamp_min(neg_margin - d, 0.0)
    pos_loss = (pos * m.pos).sum() / torch.clamp_min(m.pos.sum(), 1)
    neg_loss = (neg * m.neg).sum() / torch.clamp_min(m.neg.sum(), 1)
    return pos_loss + neg_loss


def triplet_semihard(
    embeddings: torch.Tensor, labels: torch.Tensor, margin: float = 0.1,
) -> torch.Tensor:
    """Triplet loss over the semihard triplets: negatives with
    d_ap < d_an < d_ap + margin."""
    d = _pair_dists(embeddings)
    m = _pair_masks(labels)
    d_ap = d[:, :, None]  # anchor-positive [B, B, 1]
    d_an = d[:, None, :]  # anchor-negative [B, 1, B]
    valid = m.pos[:, :, None] & m.neg[:, None, :]
    semihard = valid & (d_an > d_ap) & (d_an < d_ap + margin)
    losses = torch.clamp_min(d_ap - d_an + margin, 0.0)
    return (losses * semihard).sum() / torch.clamp_min(semihard.sum(), 1)


def npair(embeddings: torch.Tensor, labels: torch.Tensor, l2_reg: float = 0.0) -> torch.Tensor:
    """N-pair loss (Sohn, NeurIPS 2016): for each anchor with a positive in
    the batch, CE over inner-product logits against the other samples, with
    the first positive as the target."""
    b = embeddings.shape[0]
    logits = embeddings @ embeddings.T  # [B, B]
    m = _pair_masks(labels)
    eye = torch.eye(b, dtype=torch.bool, device=embeddings.device)
    has_pos = m.pos.any(1)
    target = m.pos.int().argmax(1)  # the first positive (0 when none)
    masked = torch.where(eye, torch.full_like(logits, torch.finfo(logits.dtype).min), logits)
    logp = torch.log_softmax(masked, dim=1)
    per_anchor = -logp.gather(1, target[:, None])[:, 0]
    loss = (per_anchor * has_pos).sum() / torch.clamp_min(has_pos.sum(), 1)
    return loss + l2_reg * (embeddings ** 2).sum(-1).mean()


AUX_LOSSES = {
    "proxy_anchor": proxy_anchor,
    "proxy_nca": proxy_nca,
    "ms": multi_similarity,
    "contrastive": contrastive,
    "triplet": triplet_semihard,
    "npair": npair,
}

# the losses that take trainable proxies as their third argument
PROXY_BASED = frozenset({"proxy_anchor", "proxy_nca"})


def aux_loss(name: str, embeddings: torch.Tensor, labels: torch.Tensor, proxies=None):
    """The configured aux loss (`LossConfig.aux_loss`, checked when the
    train state is made); `proxies` for the proxy-based ones."""
    if name in PROXY_BASED:
        return AUX_LOSSES[name](embeddings, labels, proxies)
    return AUX_LOSSES[name](embeddings, labels)
