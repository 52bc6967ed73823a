"""EM over the memory bank: the only trainer of prototype means and priors
(counterpart of mgproto_tpu/core/em.py).

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

CLASS-SHARDED EM (`mesh`, the JAX `_sharded_em_update`): each rank holds a
slab of the classes (parallel/sharding.py) and runs the whole dispatch
above on it (its own compaction at width min(width, C/nm), its slice of
the mean-Adam moments, the E-step kernel on its slab); the gate's counts
are summed over the model group first, so every rank of it takes the same
branch, and only the four EMAux scalars are summed after. Reference
stepping steps one Adam over every class in order, which no slab can do
alone: under a mesh the group gathers the classes, every rank runs the
same sequential pass, and each keeps its slab.
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
from mgproto_tpu_torch.parallel.collectives import all_gather, all_reduce_sum
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


def em_health_diagnostics(gmm: GMMState, memory: Memory, collapse_tol: float = 1e-3,
                          sigma_floor: float = 1e-3, eps: float = 1e-10) -> dict:
    """EM and prototype health scalars (the JAX `em_health_diagnostics`),
    as 0-d f32 tensors on the state's device; telemetry's ModelHealth reads
    them once an epoch. Over a whole state (every class):

      prior_entropy_mean/min: per-class entropy (nats) of the renormalized
        priors; 0 means one prototype owns the class.
      min_interproto_dist: the smallest intra-class distance between
        prototype means; 0 means duplicate prototypes.
      collapse_frac: the share of intra-class prototype pairs closer than
        `collapse_tol`.
      sigma_floor_frac: the share of sigma entries at or below `sigma_floor`.
      memory_occupancy: the mean fill of the per-class queues.
      memory_full_frac: the share of classes with a full queue (EM's gate).
      memory_updated_frac: the share of classes touched since the last EM.
    """
    with torch.no_grad():
        priors = gmm.priors
        p = priors / torch.clamp(priors.sum(-1, keepdim=True), min=eps)
        ent = -torch.where(p > 0, p * torch.log(p + eps), torch.zeros_like(p)).sum(-1)  # [C]
        c, k = gmm.num_classes, gmm.k_per_class
        if k > 1:
            means = gmm.means.detach()
            sq = pairwise_sq_dists(means, means)  # [C, K, K]
            off = ~torch.eye(k, dtype=torch.bool, device=means.device)
            sq_off = torch.where(off, sq, torch.full_like(sq, float("inf")))
            min_d = torch.sqrt(torch.clamp(sq_off.min(), min=0.0))
            n_pairs = off.sum().to(torch.float32) * c
            collapse = (sq_off < collapse_tol ** 2).sum().to(torch.float32) / n_pairs
        else:  # a one-component mixture has no pairs to collapse
            min_d = torch.zeros((), device=priors.device)
            collapse = torch.zeros((), device=priors.device)
        cap = memory.capacity
        return {
            "prior_entropy_mean": ent.mean(),
            "prior_entropy_min": ent.min(),
            "min_interproto_dist": min_d,
            "collapse_frac": collapse,
            "sigma_floor_frac": (gmm.sigmas <= sigma_floor).to(torch.float32).mean(),
            "memory_occupancy": (memory.length.to(torch.float32) / cap).mean(),
            "memory_full_frac": (memory.length == cap).to(torch.float32).mean(),
            "memory_updated_frac": memory.updated.to(torch.float32).mean(),
        }


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
    eps: float = 1e-10, num_active: Optional[int] = None, mesh=None,
) -> Tuple[GMMState, Memory, EMAux]:
    """One full EM call. `gmm.means` must be the mean optimizer's parameter:
    it is updated in place (and pinned for inactive classes). `num_active`
    (the count of updated & full classes) is read from the device when not
    given. Reference stepping when `cfg.reference_stepping`; otherwise
    dense when compaction is off (`max_active_classes` <= 0 or >= C) or
    more than `width` classes are active, compact otherwise. `mesh` (given
    only when its model axis splits the classes): `gmm`, `memory` and
    `mean_opt` are this rank's slab, `num_active` its own count, and the
    returned EMAux is the model group's (`_sharded_em_update`)."""
    if num_active is None:
        num_active = int(_active(memory).sum())
    if mesh is not None:
        return _sharded_em_update(gmm, memory, mean_opt, cfg, eps, num_active, mesh)
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


def _sharded_em_update(gmm, memory, mean_opt, cfg, eps, num_active, mesh):
    """EM on this rank's class slab, then the EMAux scalars summed over the
    model group: the loss, the active count and the fallbacks (the count
    of ranks whose slab overflowed its width), and the log-likelihood as
    the active-weighted mean (the JAX `_sharded_em_update`)."""
    if cfg.reference_stepping:
        return _sharded_reference_em(gmm, memory, mean_opt, cfg, eps, mesh)
    c_loc = memory.num_classes
    local_cfg = dataclasses.replace(
        cfg, max_active_classes=min(max(cfg.max_active_classes, 0), c_loc))
    gmm, memory, aux = em_update(gmm, memory, mean_opt, local_cfg, eps, num_active)
    n_local = float(aux.num_active)
    scalars = torch.stack([
        aux.loss.detach().float(), aux.log_likelihood.float() * max(n_local, 1.0),
        torch.full((), n_local, device=aux.loss.device),
        torch.full((), float(aux.compact_fallback), device=aux.loss.device)])
    loss, ll_num, n, fallback = all_reduce_sum(scalars, mesh.model_group)
    n_int, fb = (int(v) for v in torch.stack([n, fallback]).tolist())
    return gmm, memory, EMAux(loss=loss, num_active=n_int,
                              log_likelihood=ll_num / max(n_int, 1), compact_fallback=fb)


def _sharded_reference_em(gmm, memory, mean_opt, cfg, eps, mesh):
    """Reference stepping under a mesh: the model group's slabs gathered,
    the sequential pass over every class on each rank alike (a temporary
    Adam on the gathered means with the gathered moments), then this rank's
    slab of the means, priors, moments and bank flags kept."""
    group = mesh.model_group
    c_loc = memory.num_classes
    c0 = mesh.model_index * c_loc
    full = GMMState(*(all_gather(t.detach(), 0, group).clone() for t in gmm))
    full_mem = Memory(*(all_gather(t, 0, group) for t in memory))
    st = mean_opt.state.get(gmm.means)
    group_cfg = {k: v for k, v in mean_opt.param_groups[0].items() if k != "params"}
    opt = torch.optim.Adam([full.means.requires_grad_(True)], **group_cfg)
    if st:
        opt.state[full.means] = {"step": st["step"].clone(),
                                 **{m: all_gather(st[m], 0, group).clone()
                                    for m in ("exp_avg", "exp_avg_sq")}}
    full, full_mem, aux = em_update(full, full_mem, opt, cfg, eps)
    sl = slice(c0, c0 + c_loc)
    with torch.no_grad():
        gmm.means.copy_(full.means[sl])
    fst = opt.state.get(full.means)
    if fst:
        mean_opt.state[gmm.means] = {"step": fst["step"].clone(),
                                     **{m: fst[m][sl].clone() for m in ("exp_avg", "exp_avg_sq")}}
    # the gathered bank's count is the group's: aux is already the group's
    return gmm._replace(priors=full.priors[sl].clone()), clear_updated(memory), aux


def bank_update(
    gmm: GMMState, memory: Memory, mean_opt: torch.optim.Adam, cfg: EMConfig,
    feats: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
    step: int, update_gmm: bool, finite: torch.Tensor, mesh=None,
) -> Tuple[GMMState, Memory, BankAux, bool]:
    """The bank phase of one train step: memory enqueue + gated EM.

    `finite` (the trunk's loss/grad finiteness, a device bool) freezes both
    the enqueue and EM. EM also needs the epoch flag `update_gmm`, the step
    interval phase (`step` is the pre-increment counter) and a non-empty
    bank. The flag and the counts the gates need are read from the device
    in ONE transfer, the step's only host sync; the host-side `finite` is
    returned for the caller's optimizer gate. The mixture, the bank and the
    enqueue candidates must be f32 whatever the trunk's dtype
    (perf/precision.py).

    `mesh` (given only when its model axis splits the classes): the
    candidates are the global batch's, `gmm`, `memory` and `mean_opt` this
    rank's slab; a candidate of another slab's class is dropped here, the
    gate's counts are the model group's sums (`finite` is already the same
    on every rank), and EM runs on the slab (`em_update`)."""
    for t, what in ((gmm.means, "gmm.means"), (gmm.priors, "gmm.priors"),
                    (memory.feats, "memory bank feats"), (feats, "memory enqueue candidates")):
        assert_f32_stats(t, what)
    if mesh is not None:
        classes = classes - mesh.model_index * memory.num_classes
    _, _, _, counts = push_plan(memory, classes, valid)
    cap = memory.capacity
    length = torch.clamp_max(memory.length + counts, cap)
    active = (memory.updated | (counts > 0)) & (length == cap)
    local = torch.stack([active.sum(), length.sum()]).double()
    group = None if mesh is None else mesh.model_group
    probe = torch.cat([finite.double()[None], local, all_reduce_sum(local, group)])
    ok, n_active, _, _, total = (int(v) for v in probe.tolist())
    if not ok:
        return gmm, memory, BankAux(0, 0, None), False
    memory = memory_push(memory, feats, classes, valid)
    if not (update_gmm and step % cfg.update_interval == 0 and total > 0):
        return gmm, memory, BankAux(0, 0, None), True
    gmm, memory, aux = em_update(gmm, memory, mean_opt, cfg, num_active=n_active, mesh=mesh)
    return gmm, memory, BankAux(aux.num_active, aux.compact_fallback, aux), True
