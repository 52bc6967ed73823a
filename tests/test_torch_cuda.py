"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Tests marked `cuda` need an NVIDIA Hopper GPU and `nvcc`; elsewhere they
skip. This file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: score_pool values atol 1e-4 (f32 FMA chain vs cuBLAS summation
order, |values| <= ~60); where the two pick different indices the plain
density at the kernel's index must equal the kernel's value within the same
atol (a near-tie, not a wrong pick). The epilogue kernel does f32 math and
rounds once, so it is held against the plain version computed in f32 and
rounded to the activation dtype: atol 1e-5 (FMA contraction), plus one bf16
ulp (rtol 2^-7) in bf16.
"""

import pytest
import torch

from mgproto_tpu_torch.ops import fused_epilogue as fe
from mgproto_tpu_torch.ops.fused_scoring import score_pool, score_pool_plain
from mgproto_tpu_torch.ops.gaussian import precompute_diag_gaussian

ATOL = 1e-4


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _score_inputs(b, hw, c, k, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    feat = torch.nn.functional.normalize(torch.randn(b, hw, d, generator=g), dim=-1)
    means = torch.nn.functional.normalize(torch.rand(c, k, d, generator=g), dim=-1)
    sigmas = 0.3 + 0.2 * torch.rand(c, k, d, generator=g)
    return feat.cuda(), means.cuda(), sigmas.cuda()


def _densities(feat, means, sigmas):
    m, iv, const = precompute_diag_gaussian(means, sigmas, 1e-10)
    return (const[None, :, None] + m @ feat.transpose(1, 2)
            - 0.5 * iv @ (feat * feat).transpose(1, 2))  # [B, P, HW]


def assert_score_pool_close(vals, idx, pvals, pidx, dens, atol=ATOL):
    """Values agree; a differing index is a near-tie (the plain density at
    the kernel's pick equals the kernel's value)."""
    torch.testing.assert_close(vals, pvals, rtol=0, atol=atol)
    picked = torch.gather(dens, 2, idx)
    torch.testing.assert_close(picked, vals, rtol=0, atol=atol)
    for row in idx.reshape(-1, idx.shape[-1]):
        assert row.unique().numel() == row.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [196, 784])
def test_score_pool_kernel_matches_plain(hw):
    _need_cuda()
    feat, means, sigmas = _score_inputs(2, hw, 30, 10, 64)  # P = 300, ragged tile
    before = score_pool.launches
    vals, idx = score_pool(feat, means, sigmas, 20)
    assert score_pool.launches == before + 1
    pvals, pidx = score_pool_plain(feat, means, sigmas, 20)
    assert_score_pool_close(vals, idx, pvals, pidx, _densities(feat, means, sigmas))


@pytest.mark.cuda
def test_score_pool_kernel_ties_to_lowest_index():
    _need_cuda()
    g = torch.Generator().manual_seed(1)
    base = torch.randint(-4, 5, (2, 7, 8), generator=g).float() / 8
    feat = base.repeat(1, 7, 1).cuda()  # row n = base[n % 7]: exact ties
    means = (torch.randint(-4, 5, (3, 4, 8), generator=g).float() / 8).cuda()
    sigmas = torch.full((3, 4, 8), 0.5).cuda()
    vals, idx = score_pool(feat, means, sigmas, 10)
    pvals, pidx = score_pool_plain(feat, means, sigmas, 10)
    assert torch.equal(idx, pidx)
    assert torch.equal(vals, pvals)


@pytest.mark.cuda
def test_score_pool_refuses_grad():
    _need_cuda()
    feat, means, sigmas = _score_inputs(1, 16, 2, 3, 8)
    with pytest.raises(NotImplementedError):
        score_pool(feat.requires_grad_(), means, sigmas, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -7)])
def test_epilogue_kernel_matches_plain(dtype, rtol):
    _need_cuda()
    g = torch.Generator().manual_seed(2)
    c = 128
    x = torch.randn(3, 14, 14, c, generator=g).to(dtype).cuda().permute(0, 3, 1, 2)
    r = torch.randn(3, 14, 14, c, generator=g).to(dtype).cuda().permute(0, 3, 1, 2)
    mean, bias = (0.1 * torch.randn(c, generator=g)).cuda(), (0.1 * torch.randn(c, generator=g)).cuda()
    var, scale = (0.5 + torch.rand(c, generator=g)).cuda(), (0.5 + torch.rand(c, generator=g)).cuda()
    before = fe.fused_bn_epilogue.launches
    out = fe.fused_bn_epilogue(x, mean, var, scale, bias, r)
    assert fe.fused_bn_epilogue.launches == before + 1
    assert out.dtype == dtype and out.is_contiguous(memory_format=torch.channels_last)
    ref = fe.epilogue_reference(x, mean, var, scale, bias, r, 1e-5, torch.float32).to(dtype)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-5)


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty(1, 16, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        score_pool(meta, torch.empty(2, 3, 8, device="meta"),
                   torch.empty(2, 3, 8, device="meta"), 4)
    x = torch.empty(1, 8, 2, 2, device="meta").to(memory_format=torch.channels_last)
    stat = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fe.fused_bn_epilogue(x, stat, stat, stat, stat, x)
