"""Fused Gaussian prototype scoring + top-T spatial pool: `score_pool`.

Counterpart of mgproto_tpu/ops/fused_scoring.py. The unfused math
(ops/gaussian.py density, then a top-T over space) materializes a
[B*HW, P] density matrix only to reduce it over HW; the CUDA kernel
(csrc/score_pool.cu, which replaces the Pallas `_fwd_kernel`) keeps it out
of device memory and writes only the [B, P, T] values and indices.

On a CUDA tensor `score_pool` launches the kernel (or raises); on a CPU
tensor it runs `score_pool_plain`, the unfused math. Forward only: the
feature gradient comes with the training slice, so a CUDA input that needs a
gradient is refused rather than silently detached.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mgproto_tpu_torch.ops import _build
from mgproto_tpu_torch.ops.gaussian import DEFAULT_SIGMA_EPS, precompute_diag_gaussian
from mgproto_tpu_torch.ops.pooling import top_t


def score_pool_plain(
    feat: torch.Tensor, means: torch.Tensor, sigmas: torch.Tensor,
    t_levels: int, eps: float = DEFAULT_SIGMA_EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused reference: densities [B, P, HW], then the top-T over HW
    (sorted descending, ties to the lowest index)."""
    m_scaled, inv_var, const = precompute_diag_gaussian(means, sigmas, eps)
    x = feat.float()
    dens = (
        const[None, :, None]
        + torch.matmul(m_scaled, x.transpose(1, 2))
        - 0.5 * torch.matmul(inv_var, (x * x).transpose(1, 2))
    )  # [B, P, HW]
    return top_t(dens, t_levels)


def launch_score_pool(feat, m_scaled, inv_var, const, t_levels: int):
    """Launch the CUDA kernel on prepared constants (`precompute_diag_gaussian`
    of the prototypes): feat [B, HW, d], m_scaled/inv_var [P, d], const [P],
    all contiguous float32 on one CUDA device. Returns (vals [B, P, T]
    float32, idx [B, P, T] int32). Counts one launch."""
    b, hw, d = feat.shape
    p = m_scaled.shape[0]
    for name, t, shape in (("feat", feat, (b, hw, d)), ("m_scaled", m_scaled, (p, d)),
                           ("inv_var", inv_var, (p, d)), ("const", const, (p,))):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape or t.device != feat.device):
            raise ValueError(
                f"score_pool kernel: {name} must be a contiguous float32 {shape} "
                f"tensor on {feat.device}"
            )
    if not 1 <= t_levels <= hw:
        raise ValueError(f"t_levels={t_levels} must be in [1, HW={hw}]")
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


def score_pool(
    feat: torch.Tensor, means: torch.Tensor, sigmas: torch.Tensor,
    t_levels: int, eps: float = DEFAULT_SIGMA_EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused density + top-T pool.

    Args:
      feat:   [B, HW, d] float32 patch features (already L2-normalized).
      means:  [..., d] prototype means (leading shape flattens to P).
      sigmas: [..., d] prototype stds.
      t_levels: T mining levels.
    Returns:
      (vals [B, P, T] float32 top-T log-densities sorted descending,
       idx  [B, P, T] int64 flat spatial indices, ties to the lowest).
    """
    if feat.device.type == "cpu":
        return score_pool_plain(feat, means, sigmas, t_levels, eps)
    if feat.device.type != "cuda":
        raise ValueError(f"score_pool runs on cuda or cpu, not {feat.device}")
    if torch.is_grad_enabled() and feat.requires_grad:
        raise NotImplementedError(
            "score_pool's backward kernel is not ported yet; call it under "
            "torch.no_grad()/inference_mode() or on a tensor without grad"
        )
    if means.shape[-1] != feat.shape[-1] or sigmas.shape != means.shape:
        raise ValueError(
            f"prototype shapes {tuple(means.shape)}/{tuple(sigmas.shape)} do not "
            f"match feature width {feat.shape[-1]}"
        )
    m_scaled, inv_var, const = precompute_diag_gaussian(means, sigmas, eps)
    vals, idx = launch_score_pool(
        feat, m_scaled.contiguous(), inv_var.contiguous(), const.contiguous(), t_levels
    )
    return vals, idx.long()


score_pool.launches = 0  # kernel launches since the last reset
