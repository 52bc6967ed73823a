"""Fused Gaussian prototype scoring + top-T spatial pool: `score_pool`.

Counterpart of mgproto_tpu/ops/fused_scoring.py. The unfused math
(ops/gaussian.py density, then a top-T over space) materializes a
[B*HW, P] density matrix only to reduce it over HW; the CUDA kernel
(csrc/score_pool.cu, which replaces the Pallas `_fwd_kernel`) keeps it out
of device memory and writes only the [B, P, T] values and indices.

Gradient contract (the JAX package's custom VJP): prototypes are constants
here, so the backward returns a gradient for `feat` only,

    grad_feat[n] = sum_p w[n, p] * (mu_p / sigma_p^2 - x_n / sigma_p^2),
    w[n, p]      = sum_t g[p, t] * [idx[p, t] == n],

computed by csrc/score_pool_bwd.cu (which replaces the Pallas `_bwd_kernel`)
from the saved features and indices: the live (nonzero) entries of g are
sorted by patch, and every sum is taken in a fixed order without float
atomics, so the result is deterministic.

On a CUDA tensor `score_pool` launches the kernels (or raises); on a CPU
tensor it runs the plain versions, `score_pool_plain` and
`score_pool_bwd_plain`, through the same autograd Function. Either way the
work is reported to an active cost counter (obs/opcount.py) as the
kernel's analytic FLOPs and bytes (`score_pool_cost`, `score_pool_bwd_cost`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mgproto_tpu_torch.obs import opcount
from mgproto_tpu_torch.ops import _build
from mgproto_tpu_torch.ops.gaussian import DEFAULT_SIGMA_EPS, precompute_diag_gaussian
from mgproto_tpu_torch.ops.pooling import top_t


# what the CUDA kernels take: csrc/score_pool.cu keeps each top-T list in
# registers and a [2d, 128] prototype slab in shared memory
KERNEL_MAX_T = 32
KERNEL_MAX_D = 64


def _check_kernel_widths(t_levels, d):
    if t_levels > KERNEL_MAX_T or d > KERNEL_MAX_D:
        raise ValueError(
            f"score_pool kernels take at most T={KERNEL_MAX_T} levels and d={KERNEL_MAX_D}, "
            f"got T={t_levels}, d={d}"
        )


def score_pool_cost(b: int, hw: int, p: int, d: int, t_levels: int):
    """(FLOPs, bytes) of one forward: two products of d per (patch,
    prototype) pair for the mean and the variance terms; the features and
    the prototype constants read once, the values and int32 indices
    written once."""
    return 4.0 * b * hw * p * d, 4.0 * (b * hw * d + 2 * p * d + p) + 8.0 * b * p * t_levels


def score_pool_bwd_cost(b: int, hw: int, p: int, d: int, t_levels: int):
    """(FLOPs, bytes) of one backward, counted from the shapes alone: every
    one of the B*P*T upstream entries live (a zero entry costs the kernel
    nothing, so this is the dense case); g and idx read, the features and
    the prototype constants read, the feature gradient written."""
    return 4.0 * b * p * t_levels * d, 4.0 * (2 * b * p * t_levels + 2 * b * hw * d + 2 * p * d)


def _plain_fwd(feat, m_scaled, inv_var, const, t_levels: int):
    x = feat.float()
    dens = (
        const[None, :, None]
        + torch.matmul(m_scaled, x.transpose(1, 2))
        - 0.5 * torch.matmul(inv_var, (x * x).transpose(1, 2))
    )  # [B, P, HW]
    return top_t(dens, t_levels)


def score_pool_plain(
    feat: torch.Tensor, means: torch.Tensor, sigmas: torch.Tensor,
    t_levels: int, eps: float = DEFAULT_SIGMA_EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused reference: densities [B, P, HW], then the top-T over HW
    (sorted descending, ties to the lowest index)."""
    return _plain_fwd(feat, *precompute_diag_gaussian(means, sigmas, eps), t_levels)


def score_pool_bwd_plain(g, idx, feat, m_scaled, inv_var):
    """The backward's plain version: w [B, HW, P] by scatter_add of
    g [B, P, T] at idx [B, P, T], then grad = w @ msc - x * (w @ ivar)."""
    b, hw, _ = feat.shape
    w = torch.zeros(b, g.shape[1], hw, dtype=torch.float32, device=g.device)
    w = w.scatter_add_(2, idx.long(), g.float()).transpose(1, 2)
    return torch.matmul(w, m_scaled) - feat.float() * torch.matmul(w, inv_var)


def _check_f32(name, t, shape, device):
    if (t.dtype != torch.float32 or not t.is_contiguous()
            or tuple(t.shape) != shape or t.device != device):
        raise ValueError(
            f"score_pool kernel: {name} must be a contiguous float32 {shape} tensor on {device}"
        )


def launch_score_pool(feat, m_scaled, inv_var, const, t_levels: int):
    """Launch the CUDA kernel on prepared constants (`precompute_diag_gaussian`
    of the prototypes): feat [B, HW, d], m_scaled/inv_var [P, d], const [P],
    all contiguous float32 on one CUDA device. Returns (vals [B, P, T]
    float32, idx [B, P, T] int32). Counts one launch."""
    b, hw, d = feat.shape
    p = m_scaled.shape[0]
    for name, t, shape in (("feat", feat, (b, hw, d)), ("m_scaled", m_scaled, (p, d)),
                           ("inv_var", inv_var, (p, d)), ("const", const, (p,))):
        _check_f32(name, t, shape, feat.device)
    if not 1 <= t_levels <= hw:
        raise ValueError(f"t_levels={t_levels} must be in [1, HW={hw}]")
    _check_kernel_widths(t_levels, d)
    lib = _build.load("score_pool")
    vals = torch.empty(b, p, t_levels, dtype=torch.float32, device=feat.device)
    idx = torch.empty(b, p, t_levels, dtype=torch.int32, device=feat.device)
    code = lib.score_pool_fwd(
        feat.data_ptr(), m_scaled.data_ptr(), inv_var.data_ptr(),
        const.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        b, hw, p, d, t_levels,
        torch.cuda.current_stream(feat.device).cuda_stream,
    )
    _build.check(lib, code, "score_pool_fwd launch")
    score_pool.launches += 1
    return vals, idx


def launch_score_pool_bwd(g, idx, feat, m_scaled, inv_var):
    """Launch the backward kernel: g [B, P, T] float32 and idx [B, P, T]
    int32 (the forward's: each prototype's T indices distinct), feat
    [B, HW, d], m_scaled/inv_var [P, d], contiguous on one CUDA device.
    Returns grad_feat [B, HW, d] float32, deterministic (no float atomics).
    Counts one launch (the kernel's compaction and accumulation passes)."""
    b, hw, d = feat.shape
    p, t_levels = g.shape[1], g.shape[2]
    for name, t, shape in (("g", g, (b, p, t_levels)), ("feat", feat, (b, hw, d)),
                           ("m_scaled", m_scaled, (p, d)), ("inv_var", inv_var, (p, d))):
        _check_f32(name, t, shape, feat.device)
    if (idx.dtype != torch.int32 or not idx.is_contiguous()
            or idx.shape != g.shape or idx.device != feat.device):
        raise ValueError(f"score_pool_bwd kernel: idx must be a contiguous int32 {tuple(g.shape)} tensor")
    _check_kernel_widths(t_levels, d)
    lib = _build.load("score_pool_bwd")
    out = torch.empty(b, hw, d, dtype=torch.float32, device=feat.device)
    # the kernels' worst-case scratch: every entry live, every patch a hub
    scratch = torch.empty(lib.score_pool_bwd_scratch_bytes(b, hw, p, d, t_levels),
                          dtype=torch.uint8, device=feat.device)
    code = lib.score_pool_bwd(
        g.data_ptr(), idx.data_ptr(), feat.data_ptr(), m_scaled.data_ptr(),
        inv_var.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, hw, p, d, t_levels,
        torch.cuda.current_stream(feat.device).cuda_stream,
    )
    _build.check(lib, code, "score_pool_bwd launch")
    score_pool_bwd.launches += 1
    return out


def score_pool_bwd(g, idx, feat, m_scaled, inv_var):
    """The feature gradient: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    with opcount.counted("score_pool_bwd", *score_pool_bwd_cost(*feat.shape[:2], *m_scaled.shape,
                                                                 g.shape[2])):
        if feat.device.type == "cpu":
            return score_pool_bwd_plain(g, idx, feat, m_scaled, inv_var)
        return launch_score_pool_bwd(g.float().contiguous(), idx.contiguous(), feat, m_scaled,
                                     inv_var)


score_pool_bwd.launches = 0  # kernel launches since the last reset


class _ScorePoolFn(torch.autograd.Function):
    """Forward and backward of `score_pool`; the prototype constants are
    inputs without gradient."""

    @staticmethod
    def forward(ctx, feat, m_scaled, inv_var, const, t_levels):
        with opcount.counted("score_pool", *score_pool_cost(*feat.shape[:2], *m_scaled.shape,
                                                            t_levels)):
            if feat.device.type == "cpu":
                # int32 indices, as the kernel writes them: one program on
                # either device (the widening below, the saved tensor)
                vals, idx = _plain_fwd(feat, m_scaled, inv_var, const, t_levels)
                idx = idx.int()
            else:
                vals, idx = launch_score_pool(feat, m_scaled, inv_var, const, t_levels)
        ctx.save_for_backward(feat, m_scaled, inv_var, idx)
        ctx.mark_non_differentiable(idx)
        return vals, idx

    @staticmethod
    def backward(ctx, g_vals, _g_idx):
        feat, m_scaled, inv_var, idx = ctx.saved_tensors
        return score_pool_bwd(g_vals, idx, feat, m_scaled, inv_var), None, None, None, None


def score_pool(
    feat: torch.Tensor, means: torch.Tensor, sigmas: torch.Tensor,
    t_levels: int, eps: float = DEFAULT_SIGMA_EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused density + top-T pool; differentiable in `feat` only.

    Args:
      feat:   [B, HW, d] float32 patch features (already L2-normalized).
      means:  [..., d] prototype means (leading shape flattens to P).
      sigmas: [..., d] prototype stds.
      t_levels: T mining levels.
    Returns:
      (vals [B, P, T] float32 top-T log-densities sorted descending,
       idx  [B, P, T] int64 flat spatial indices, ties to the lowest).
    """
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"score_pool runs on cuda or cpu, not {feat.device}")
    if means.shape[-1] != feat.shape[-1] or sigmas.shape != means.shape:
        raise ValueError(
            f"prototype shapes {tuple(means.shape)}/{tuple(sigmas.shape)} do not "
            f"match feature width {feat.shape[-1]}"
        )
    consts = precompute_diag_gaussian(means.detach(), sigmas.detach(), eps)
    if feat.device.type == "cuda":
        consts = tuple(t.contiguous() for t in consts)
    vals, idx = _ScorePoolFn.apply(feat, *consts, t_levels)
    return vals, idx.long()


score_pool.launches = 0  # kernel launches since the last reset
