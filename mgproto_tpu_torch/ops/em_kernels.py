"""Fused EM E-step: responsibilities reduced to sufficient statistics.

Counterpart of mgproto_tpu/ops/em_kernels.py. Evaluated the plain way, each
EM round materializes per-class [N, K] log-density and responsibility
matrices; the CUDA kernels (csrc/em_estep.cu, which replace the Pallas
`_estep_kernel`) keep the E-step on chip and write only

    s   [A, K]    = sum_n r[n, k]
    sx  [A, K, d] = sum_n r[n, k] * x[n]
    sxx [A, K, d] = sum_n r[n, k] * x[n]^2
    ll  [A]       = mean_n logsumexp_k

A class's rows are split into fixed blocks of 64, each block's partial
statistics go to a scratch tensor that `launch_em_estep` allocates, and a
second launch adds them in block order: deterministic, no float atomics,
and a class gets the same bits in any slab of classes. The kernels take
K <= 32 and d a multiple of 4 up to 64; other shapes are refused.

Responsibilities are constants in the m-step (core/em.py evaluates the
objective from these statistics), so nothing differentiates through here.
The statistics are RAW (unsmoothed); core/em.py applies the smoothing.

On CUDA tensors `em_estep_stats` launches the kernels (or raises); on CPU
tensors it runs `em_estep_stats_plain`. Either way an active cost counter
(obs/opcount.py) is told the kernel's analytic FLOPs and bytes
(`em_estep_cost`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mgproto_tpu_torch.obs import opcount
from mgproto_tpu_torch.ops import _build
from mgproto_tpu_torch.ops.gaussian import DEFAULT_SIGMA_EPS, precompute_diag_gaussian

MAX_K = 32  # components per class the kernel takes
MAX_D = 64  # widest feature the kernel takes (a multiple of 4)


def em_estep_cost(a: int, n: int, d: int, k: int):
    """(FLOPs, bytes) of one E-step over A classes: two products of d per
    (row, component) pair for the density and two for Σr·x and Σr·x²; the
    rows and the prototype constants read once, ll, Σr, Σr·x and Σr·x²
    written once."""
    return (8.0 * a * n * k * d,
            4.0 * (a * n * d + 2 * a * k * d + a * k) + 4.0 * (a + a * k + 2 * a * k * d))


def _prepare(means, sigmas, priors, eps):
    """(msc, ivar [A, K, d], const [A, K]) with the log prior plus eps folded
    into the density constant (the JAX package's host-side fold)."""
    a, k, d = means.shape
    m_scaled, inv_var, const = precompute_diag_gaussian(means, sigmas, eps)
    const = const.reshape(a, k) + torch.log(priors.float() + eps)
    return m_scaled.reshape(a, k, d), inv_var.reshape(a, k, d), const


def em_estep_stats_plain(x, means, sigmas, priors, eps: float = DEFAULT_SIGMA_EPS):
    """The plain version: the same statistics by matmuls, a softmax over K
    and reductions over N."""
    msc, ivar, const = _prepare(means, sigmas, priors, eps)
    x = x.float()
    xx = x * x
    w = const[:, None, :] + torch.matmul(x, msc.transpose(1, 2)) \
        - 0.5 * torch.matmul(xx, ivar.transpose(1, 2))  # [A, N, K]
    log_norm = torch.logsumexp(w, dim=-1, keepdim=True)
    resp = torch.exp(w - log_norm)
    rt = resp.transpose(1, 2)  # [A, K, N]
    return log_norm[..., 0].mean(-1), resp.sum(1), torch.matmul(rt, x), torch.matmul(rt, xx)


def launch_em_estep(x, msc, ivar, const):
    """Launch the CUDA kernel: x [A, N, d], msc/ivar [A, K, d], const [A, K]
    (log prior folded in), contiguous float32 on one CUDA device, K <= 32,
    d a multiple of 4 up to 64. Returns (ll [A], s [A, K], sx [A, K, d],
    sxx [A, K, d]). The two kernels of an E-step count as one launch."""
    a, n, d = x.shape
    k = msc.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"em_estep kernel takes 1 <= K <= {MAX_K} components, not {k}")
    if d % 4 or not 4 <= d <= MAX_D:
        raise ValueError(f"em_estep kernel takes d a multiple of 4 up to {MAX_D}, not {d}")
    for name, t, shape in (("x", x, (a, n, d)), ("msc", msc, (a, k, d)),
                           ("ivar", ivar, (a, k, d)), ("const", const, (a, k))):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape or t.device != x.device):
            raise ValueError(
                f"em_estep kernel: {name} must be a contiguous float32 {shape} tensor on {x.device}"
            )
    lib = _build.load("em_estep")
    f32 = dict(dtype=torch.float32, device=x.device)
    ll, s = torch.empty(a, **f32), torch.empty(a, k, **f32)
    sx, sxx = torch.empty(a, k, d, **f32), torch.empty(a, k, d, **f32)
    scratch = torch.empty(lib.em_estep_scratch_bytes(a, n, d, k) // 4, **f32)
    code = lib.em_estep(
        x.data_ptr(), msc.data_ptr(), ivar.data_ptr(), const.data_ptr(),
        ll.data_ptr(), s.data_ptr(), sx.data_ptr(), sxx.data_ptr(), scratch.data_ptr(),
        a, n, d, k, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "em_estep launch")
    em_estep_stats.launches += 1
    return ll, s, sx, sxx


def em_estep_stats(
    x: torch.Tensor, means: torch.Tensor, sigmas: torch.Tensor,
    priors: torch.Tensor, eps: float = DEFAULT_SIGMA_EPS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused E-step over a class slab.

    Args:
      x:      [A, N, d] per-class memory features (full queues).
      means:  [A, K, d] mixture means; sigmas [A, K, d] stds.
      priors: [A, K] mixture priors.
    Returns:
      (ll [A] mean log-likelihood, s [A, K], sx [A, K, d], sxx [A, K, d]
       RAW responsibility statistics).
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"em_estep runs on cuda or cpu, not {x.device}")
    with opcount.counted("em_estep", *em_estep_cost(*x.shape, means.shape[1])):
        if x.device.type == "cpu":
            return em_estep_stats_plain(x, means, sigmas, priors, eps)
        msc, ivar, const = _prepare(means, sigmas, priors, eps)
        return launch_em_estep(x.float().contiguous(), msc.contiguous(), ivar.contiguous(),
                               const.contiguous())


em_estep_stats.launches = 0  # E-steps launched on the card since the last reset
