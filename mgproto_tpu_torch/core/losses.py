"""Classification and auxiliary losses (counterpart of mgproto_tpu/core/losses.py).

Cross-entropy on the class log-likelihoods, the mining loss over levels
t >= 1, and the Proxy-Anchor aux loss on the embedding. The JAX package's
five other aux losses are not ported yet.
"""

from __future__ import annotations

import math

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
