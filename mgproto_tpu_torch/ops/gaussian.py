"""Diagonal-Gaussian prototype scoring (counterpart of mgproto_tpu/ops/gaussian.py).

    log N(x; mu, sigma) = -d/2 log(2 pi) - sum_d log sigma_d
                          - 1/2 sum_d ((x_d - mu_d) / sigma_d)^2

evaluated by the same quadratic expansion as the JAX package: one [N, d] x
[d, P] matmul for the cross term plus rank-1 broadcasts, all in float32.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)

DEFAULT_SIGMA_EPS = 1e-10


def precompute_diag_gaussian(means: torch.Tensor, sigmas: torch.Tensor, eps: float):
    """Flatten [..., d] prototypes to [P, d] and return
      (m_scaled [P, d] = mu / sigma^2,
       inv_var  [P, d] = 1 / sigma^2,
       const    [P]    = -d/2 log(2pi) - sum log sigma - 1/2 mu.(mu/sigma^2))
    so that  log N(x) = const + x @ m_scaled.T - 1/2 (x*x) @ inv_var.T."""
    d = means.shape[-1]
    m = means.float().reshape(-1, d)
    s = (sigmas.float() + eps).reshape(-1, d)
    inv_var = 1.0 / (s * s)
    m_scaled = m * inv_var
    const = (
        -0.5 * d * _LOG_2PI
        - torch.log(s).sum(-1)
        - 0.5 * (m * m_scaled).sum(-1)
    )
    return m_scaled, inv_var, const


def diag_gaussian_log_prob(
    x: torch.Tensor,
    means: torch.Tensor,
    sigmas: torch.Tensor,
    eps: float = DEFAULT_SIGMA_EPS,
) -> torch.Tensor:
    """[N, d] features -> [N, *leading] log-densities under every prototype."""
    x = x.float()
    lead = means.shape[:-1]
    m_scaled, inv_var, const = precompute_diag_gaussian(means, sigmas, eps)
    x_quad = torch.matmul(x * x, inv_var.T)
    cross = torch.matmul(x, m_scaled.T)
    out = const[None, :] + cross - 0.5 * x_quad
    return out.reshape(x.shape[0], *lead)


def mixture_log_likelihood(
    log_prob: torch.Tensor, log_priors: torch.Tensor
) -> torch.Tensor:
    """log p(x|c) = logsumexp_k [log pi_{c,k} + log N(x; mu_{c,k})].
    log_prob [..., C, K], log_priors [C, K] (-inf for pruned slots)."""
    return torch.logsumexp(log_prob + log_priors, dim=-1)


def class_log_prob(
    x: torch.Tensor, means: torch.Tensor, sigmas: torch.Tensor,
    eps: float = DEFAULT_SIGMA_EPS,
) -> torch.Tensor:
    """Per-class log-densities with a leading class axis (the JAX package's
    `vmap` of `diag_gaussian_log_prob` over classes): x [A, N, d],
    means/sigmas [A, K, d] -> [A, N, K]."""
    a, k, d = means.shape
    m_scaled, inv_var, const = precompute_diag_gaussian(means, sigmas, eps)
    m_scaled, inv_var, const = m_scaled.reshape(a, k, d), inv_var.reshape(a, k, d), const.reshape(a, k)
    x = x.float()
    x_quad = torch.matmul(x * x, inv_var.transpose(1, 2))
    cross = torch.matmul(x, m_scaled.transpose(1, 2))
    return const[:, None, :] + cross - 0.5 * x_quad


def e_step(
    x: torch.Tensor, means: torch.Tensor, sigmas: torch.Tensor,
    priors: torch.Tensor, eps: float = 1e-10,
):
    """EM E-step for a slab of class mixtures (mgproto_tpu's `e_step`
    vmapped over classes). x [A, N, d], means/sigmas [A, K, d], priors
    [A, K] -> (mean log-likelihood [A], log-responsibilities [A, N, K])."""
    weighted = class_log_prob(x, means, sigmas) + torch.log(priors + eps)[:, None, :]
    log_norm = torch.logsumexp(weighted, dim=-1, keepdim=True)  # [A, N, 1]
    return log_norm[..., 0].mean(-1), weighted - log_norm


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, d] x [..., M, d] -> [..., N, M] squared euclidean distances."""
    return ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)


def momentum_update(old: torch.Tensor, new: torch.Tensor, momentum: float) -> torch.Tensor:
    """EMA update: momentum * old + (1 - momentum) * new."""
    return momentum * old + (1.0 - momentum) * new
