"""EM over the memory bank: the only trainer of prototype means and priors
(counterpart of mgproto_tpu/core/em.py, without the class-sharded path).

Per touched class with a FULL queue, `num_em_loop` rounds of
  E-step:  responsibilities under the current means and priors;
  M-step:  additively smoothed responsibilities give new priors; the MEANS
           take one Adam step on the responsibility-weighted NLL plus a
           diversity cost; sigmas are never trained;
  priors:  EMA with tau.
All classes of a slab are processed at once, with ONE Adam step per round on
the whole [C, K, d] means tensor; inactive classes are masked out of the
loss and their means pinned exactly at the end (`torch.where`).

  * COMPACT DIRTY-CLASS EM (`max_active_classes` > 0): the <= width dirty
    classes are gathered into an [A, N, d] slab (a stable descending sort of
    the dirty mask, so ties go to ascending class id, as `lax.top_k`). When
    more than `width` classes are dirty the call takes the dense path and
    reports `compact_fallback = 1`.
  * FUSED E-STEP (`fused_estep`, ops/em_kernels.py): the E-step as raw
    sufficient statistics (the em_estep kernel on CUDA), smoothed here in
    statistics space; the m-step objective is then evaluated from them
    (`_m_step_objective_stats`, the same math as `_m_step_objective`).
  * REFERENCE STEPPING (`reference_stepping`, `_reference_em_update`): the
    reference's control flow, a sequential pass over the active classes in
    order with one Adam step per (class, round) on the WHOLE means tensor,
    plain E-step. Takes precedence over compaction and the kernel.

The gates are host-side Python: `bank_update` reads the divergence-guard
flag and the EM gate's counts from the device in one transfer.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from mgproto_tpu_torch.config import EMConfig
from mgproto_tpu_torch.core.memory import Memory, clear_updated, memory_push, push_plan
from mgproto_tpu_torch.core.mgproto import GMMState
from mgproto_tpu_torch.numerics import use_kernel
from mgproto_tpu_torch.ops.em_kernels import em_estep_stats
from mgproto_tpu_torch.ops.gaussian import (
    class_log_prob,
    e_step,
    momentum_update,
    pairwise_sq_dists,
    precompute_diag_gaussian,
)
from mgproto_tpu_torch.perf.precision import assert_f32_stats


class EMAux(NamedTuple):
    loss: torch.Tensor  # final-round masked m-step objective (scalar)
    num_active: int  # classes that ran EM this call
    log_likelihood: torch.Tensor  # mean E-step log-likelihood over active classes
    compact_fallback: int  # 1 when the compact path overflowed into the dense one


class BankAux(NamedTuple):
    """What the bank phase reports to the step metrics."""

    num_active: int  # classes EM touched (0 when gated off)
    compact_fallback: int
    em: Optional[EMAux]  # the EM call's aux, None when EM did not run


def make_mean_optimizer(means: torch.Tensor, cfg: EMConfig) -> torch.optim.Adam:
    """Adam on the [C, K, d] means tensor (made a leaf that requires grad;
    the optimizer updates it in place)."""
    return torch.optim.Adam([means.requires_grad_(True)], lr=cfg.mean_lr)


def resolve_em_config(cfg: EMConfig, num_classes: int, global_batch: int) -> EMConfig:
    """Resolve `max_active_classes=-1` (auto) to min(C, global batch)."""
    if cfg.max_active_classes != -1:
        return cfg
    return dataclasses.replace(
        cfg, max_active_classes=min(num_classes, max(int(global_batch), 1))
    )


def _diversity(mu: torch.Tensor) -> torch.Tensor:
    """Mean off-diagonal exp(-||mu_i - mu_j||^2) per class: mu [A, K, d] -> [A]."""
    k = mu.shape[1]
    off = 1.0 - torch.eye(k, dtype=mu.dtype, device=mu.device)
    return (torch.exp(-pairwise_sq_dists(mu, mu)) * off).sum((-1, -2)) / off.sum()


def _class_objective(mu, x, resp, pi_old, sigmas, lam, eps=1e-10):
    """One class's m-step objective (JAX `_class_objective`): mu/sigmas
    [K, d], x [N, d], resp [N, K], pi_old [K]."""
    ll = class_log_prob(x[None], mu[None], sigmas[None])[0] + torch.log(pi_old + eps)
    weighted_nll = -(resp * ll).sum(-1).mean()
    return weighted_nll + lam * _diversity(mu[None])[0]


def _m_step_objective(means, x, resp, pi_old, sigmas, active, lam, eps=1e-10):
    """Masked sum over classes of the responsibility-weighted NLL plus
    lam * diversity. means/sigmas [A, K, d], x [A, N, d], resp [A, N, K],
    pi_old [A, K], active [A] float."""
    ll = class_log_prob(x, means, sigmas) + torch.log(pi_old + eps)[:, None, :]
    weighted_nll = -(resp * ll).sum(-1).mean(-1)
    return ((weighted_nll + lam * _diversity(means)) * active).sum()


def _m_step_objective_stats(means, s, sx, sxx, pi_old, sigmas, active, lam, n, eps=1e-10):
    """`_m_step_objective` from SMOOTHED sufficient statistics (s [A, K],
    sx/sxx [A, K, d]) instead of resp [A, N, K]:
      sum_n r logN = s*const + <mu/sigma^2, sx> - 0.5 <1/sigma^2, sxx>."""
    a, k, d = means.shape
    m_scaled, inv_var, const = precompute_diag_gaussian(means, sigmas, eps)
    m_scaled, inv_var, const = m_scaled.reshape(a, k, d), inv_var.reshape(a, k, d), const.reshape(a, k)
    ll_sum = (
        s * (const + torch.log(pi_old + eps))
        + (m_scaled * sx).sum(-1)
        - 0.5 * (inv_var * sxx).sum(-1)
    )  # [A, K]
    weighted_nll = -ll_sum.sum(-1) / n
    return ((weighted_nll + lam * _diversity(means)) * active).sum()


def _em_rounds(means, mean_opt, pi_slab, x_slab, sigmas_slab, active_slab, idx,
               cfg: EMConfig, cap: int, eps: float, fused: bool):
    """`num_em_loop` rounds over a slab of classes, shared by the dense
    (idx=None: the slab is every class) and compact (idx [A]) paths. `means`
    is the FULL [C, K, d] leaf the mean optimizer steps in place, once per
    round, with the slab gradient scattered in. Returns (pi_slab, last loss,
    last masked mean log-likelihood)."""
    active_f = active_slab.float()
    n_active = torch.clamp_min(active_f.sum(), 1.0)
    n, k = x_slab.shape[1], sigmas_slab.shape[1]
    alpha = cfg.alpha
    for _ in range(cfg.num_em_loop):
        mu_slab = means.detach() if idx is None else means.detach()[idx]
        if fused:
            ll, s_raw, sx_raw, sxx_raw = em_estep_stats(x_slab, mu_slab, sigmas_slab, pi_slab, eps)
            # smoothing in statistics space: raw responsibilities sum to 1
            # over K, so the smoothing denominator is 1 + K*alpha and
            # sum_n x / sum_n x^2 come back as sums of sx / sxx over K
            denom = 1.0 + k * alpha
            s = (s_raw + n * alpha) / denom
            sx = (sx_raw + alpha * sx_raw.sum(1, keepdim=True)) / denom
            sxx = (sxx_raw + alpha * sxx_raw.sum(1, keepdim=True)) / denom
            pi_unnorm = s + eps

            def obj(m_slab, s=s, sx=sx, sxx=sxx, pi_old=pi_slab):
                return _m_step_objective_stats(
                    m_slab, s, sx, sxx, pi_old, sigmas_slab, active_f,
                    cfg.diversity_lambda, n, eps)
        else:
            ll, log_resp = e_step(x_slab, mu_slab, sigmas_slab, pi_slab)
            resp = torch.exp(log_resp)
            resp = (resp + alpha) / (resp + alpha).sum(-1, keepdim=True)
            pi_unnorm = resp.sum(1) + eps

            def obj(m_slab, resp=resp, pi_old=pi_slab):
                return _m_step_objective(
                    m_slab, x_slab, resp, pi_old, sigmas_slab, active_f,
                    cfg.diversity_lambda)

        with torch.enable_grad():
            loss = obj(means if idx is None else means[idx])
            (grad,) = torch.autograd.grad(loss, means)
        means.grad = grad
        mean_opt.step()
        pi_slab = torch.where(
            active_slab[:, None], momentum_update(pi_slab, pi_unnorm / cap, cfg.tau), pi_slab
        )
        ll_mean = (ll * active_f).sum() / n_active
    return pi_slab, loss.detach(), ll_mean


def _active(memory: Memory) -> torch.Tensor:
    return memory.updated & (memory.length == memory.capacity)


def _dense_em_update(gmm, memory, mean_opt, cfg, eps, fused):
    active = _active(memory)
    old = gmm.means.detach().clone()
    priors, loss, ll_mean = _em_rounds(
        gmm.means, mean_opt, gmm.priors, memory.feats, gmm.sigmas, active, None,
        cfg, memory.capacity, eps, fused,
    )
    with torch.no_grad():
        gmm.means.copy_(torch.where(active[:, None, None], gmm.means, old))
    return gmm._replace(priors=priors), loss, ll_mean


def _compact_em_update(gmm, memory, mean_opt, cfg, eps, width, fused):
    active = _active(memory)
    # stable descending sort of the dirty mask: dirty classes first, ties to
    # ascending class id (lax.top_k's order); the tail slots carry clean
    # classes, inert through slab_active
    idx = torch.sort(active.int(), descending=True, stable=True).indices[:width]
    slab_active = active[idx]
    old = gmm.means.detach().clone()
    pi_slab, loss, ll_mean = _em_rounds(
        gmm.means, mean_opt, gmm.priors[idx], memory.feats[idx], gmm.sigmas[idx],
        slab_active, idx, cfg, memory.capacity, eps, fused,
    )
    with torch.no_grad():
        gmm.means.copy_(torch.where(active[:, None, None], gmm.means, old))
    return gmm._replace(priors=gmm.priors.index_copy(0, idx, pi_slab)), loss, ll_mean


def _reference_em_update(gmm, memory, mean_opt, cfg, eps):
    """Reference-exact stepping (JAX `_reference_em_update`): the active
    classes in ascending order, each with `num_em_loop` rounds of plain
    E-step, smoothed responsibilities, ONE Adam step of the mean optimizer
    on the whole [C, K, d] means tensor (the gradient is zero outside the
    class's slice, so the other classes drift under the moments and the
    step count advances once per (class, round), as under the reference's
    one torch Adam), and the tau-momentum prior update. Returns (gmm, loss,
    ll): the sum over active classes of their last round's objective, and
    the mean over them of their last round's E-step log-likelihood. The
    active classes are read from the device once."""
    cap = memory.capacity
    active = _active(memory)
    classes = torch.nonzero(active).flatten().tolist()
    means, priors = gmm.means, gmm.priors.clone()
    losses, lls = [], []
    for c in classes:
        xc, sig_c = memory.feats[c], gmm.sigmas[c]
        pi_old = priors[c]
        for _ in range(cfg.num_em_loop):
            ll_c, log_resp = e_step(xc[None], means.detach()[c][None], sig_c[None], pi_old[None])
            resp = torch.exp(log_resp[0])
            resp = (resp + cfg.alpha) / (resp + cfg.alpha).sum(-1, keepdim=True)
            pi_unnorm = resp.sum(0) + eps
            with torch.enable_grad():
                loss = _class_objective(means[c], xc, resp, pi_old, sig_c,
                                        cfg.diversity_lambda, eps)
                (grad,) = torch.autograd.grad(loss, means)
            means.grad = grad
            mean_opt.step()
            pi_old = momentum_update(pi_old, pi_unnorm / cap, cfg.tau)
        priors[c] = pi_old
        losses.append(loss.detach())
        lls.append(ll_c[0])
    zero = means.new_zeros(())
    total = torch.stack(losses).sum() if losses else zero
    ll_mean = torch.stack(lls).sum() / max(len(lls), 1) if lls else zero
    return gmm._replace(priors=priors), total, ll_mean


def em_update(
    gmm: GMMState, memory: Memory, mean_opt: torch.optim.Adam, cfg: EMConfig,
    eps: float = 1e-10, num_active: Optional[int] = None,
) -> Tuple[GMMState, Memory, EMAux]:
    """One full EM call. `gmm.means` must be the mean optimizer's parameter:
    it is updated in place (and pinned for inactive classes). `num_active`
    (the count of updated & full classes) is read from the device when not
    given. Reference stepping when `cfg.reference_stepping`; otherwise
    dense when compaction is off (`max_active_classes` <= 0 or >= C) or
    more than `width` classes are active, compact otherwise."""
    if num_active is None:
        num_active = int(_active(memory).sum())
    if cfg.reference_stepping:
        gmm, loss, ll = _reference_em_update(gmm, memory, mean_opt, cfg, eps)
        return gmm, clear_updated(memory), EMAux(
            loss=loss, num_active=num_active, log_likelihood=ll, compact_fallback=0)
    fused = use_kernel(cfg.fused_estep, memory.feats.device)
    c = memory.num_classes
    width = cfg.max_active_classes
    fallback = 0
    if 0 < width < c and num_active <= width:
        gmm, loss, ll = _compact_em_update(gmm, memory, mean_opt, cfg, eps, width, fused)
    else:
        fallback = int(0 < width < c)
        gmm, loss, ll = _dense_em_update(gmm, memory, mean_opt, cfg, eps, fused)
    return gmm, clear_updated(memory), EMAux(
        loss=loss, num_active=num_active, log_likelihood=ll, compact_fallback=fallback,
    )


def bank_update(
    gmm: GMMState, memory: Memory, mean_opt: torch.optim.Adam, cfg: EMConfig,
    feats: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
    step: int, update_gmm: bool, finite: torch.Tensor,
) -> Tuple[GMMState, Memory, BankAux, bool]:
    """The bank phase of one train step: memory enqueue + gated EM.

    `finite` (the trunk's loss/grad finiteness, a device bool) freezes both
    the enqueue and EM. EM also needs the epoch flag `update_gmm`, the step
    interval phase (`step` is the pre-increment counter) and a non-empty
    bank. The flag and the counts the gates need are read from the device
    in ONE transfer, the step's only host sync; the host-side `finite` is
    returned for the caller's optimizer gate. The mixture, the bank and the
    enqueue candidates must be f32 whatever the trunk's dtype
    (perf/precision.py)."""
    for t, what in ((gmm.means, "gmm.means"), (gmm.priors, "gmm.priors"),
                    (memory.feats, "memory bank feats"), (feats, "memory enqueue candidates")):
        assert_f32_stats(t, what)
    _, _, _, counts = push_plan(memory, classes, valid)
    cap = memory.capacity
    length = torch.clamp_max(memory.length + counts, cap)
    active = (memory.updated | (counts > 0)) & (length == cap)
    probe = torch.stack([finite.long(), active.sum().long(), length.sum().long()])
    ok, n_active, total = probe.tolist()
    if not ok:
        return gmm, memory, BankAux(0, 0, None), False
    memory = memory_push(memory, feats, classes, valid)
    if not (update_gmm and step % cfg.update_interval == 0 and total > 0):
        return gmm, memory, BankAux(0, 0, None), True
    gmm, memory, aux = em_update(gmm, memory, mean_opt, cfg, num_active=n_active)
    return gmm, memory, BankAux(aux.num_active, aux.compact_fallback, aux), True
