"""The port's ops (mgproto_tpu_torch.ops) against the JAX package's.

Inputs are made with numpy from a seed and handed to both sides. The JAX
Pallas kernels run in interpret mode on the CPU, as tests/test_fused_*.py
run them. Tolerances:
  * f32 densities and pooled values: atol 1e-4 — XLA and ATen sum the
    d-long dot products in different orders; values are O(10).
  * bf16 epilogue: rtol 2e-2, atol 3e-2 (a few bf16 ulps at |y| <= 4) — the
    plain version rounds to bf16 after every op, the kernel once.
  * score_pool feature gradient: atol 1e-5 x max |JAX gradient| (|grad|
    ~ 1/sigma^2 ~ 10) — the JAX VJP sums by HIGHEST-precision matmuls, the
    port by scatter_add and ATen matmuls.
  * E-step statistics: rtol 1e-5 against the largest magnitude of each
    output (s, sx, sxx), ll atol 1e-4 (|ll| ~ 50).
  * BatchNorm train mode: output, input gradient and running statistics
    atol 1e-5 (f32 reductions in another order).
The CUDA kernels themselves are held against these plain versions in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgproto_tpu.models.common import BatchNorm as JaxBatchNorm
from mgproto_tpu.ops import fused_epilogue as jfe
from mgproto_tpu.ops import gaussian as jg
from mgproto_tpu.ops import pooling as jp
from mgproto_tpu.ops.em_kernels import em_estep_stats as jax_em_estep_stats
from mgproto_tpu.ops.fused_scoring import score_pool as jax_score_pool
from mgproto_tpu_torch.models.common import BatchNorm
from mgproto_tpu_torch.ops import fused_epilogue as tfe
from mgproto_tpu_torch.ops import gaussian as tg
from mgproto_tpu_torch.ops import pooling as tp
from mgproto_tpu_torch.ops.em_kernels import em_estep_stats, em_estep_stats_plain
from mgproto_tpu_torch.ops.fused_scoring import (
    score_pool,
    score_pool_bwd,
    score_pool_bwd_plain,
    score_pool_plain,
)

ATOL = 1e-4


def _protos(rng, c, k, d):
    means = rng.normal(size=(c, k, d)).astype(np.float32)
    means /= np.linalg.norm(means, axis=-1, keepdims=True)
    sigmas = rng.uniform(0.3, 0.5, size=(c, k, d)).astype(np.float32)
    return means, sigmas


def _feat(rng, b, hw, d):
    f = rng.normal(size=(b, hw, d)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_gaussian_matches_jax():
    rng = np.random.default_rng(0)
    means, sigmas = _protos(rng, 5, 4, 16)
    x = _feat(rng, 1, 30, 16)[0]
    for j, t in zip(jg.precompute_diag_gaussian(means, sigmas, 1e-10),
                    tg.precompute_diag_gaussian(_t(means), _t(sigmas), 1e-10)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-5)
    lp_j = np.asarray(jg.diag_gaussian_log_prob(x, means, sigmas))
    lp_t = tg.diag_gaussian_log_prob(_t(x), _t(means), _t(sigmas)).numpy()
    assert lp_t.shape == lp_j.shape == (30, 5, 4)
    np.testing.assert_allclose(lp_t, lp_j, atol=ATOL)
    priors = rng.uniform(size=(5, 4)).astype(np.float32)
    log_priors = np.where(priors > 0.3, np.log(priors), -np.inf).astype(np.float32)
    np.testing.assert_allclose(
        tg.mixture_log_likelihood(_t(lp_j), _t(log_priors)).numpy(),
        np.asarray(jg.mixture_log_likelihood(lp_j, log_priors)), atol=1e-5,
    )


@pytest.mark.parametrize("h,w", [(4, 4), (7, 7)])
def test_pooling_matches_jax(h, w):
    rng = np.random.default_rng(1)
    b, c, k, d, t = 2, 3, 4, 8, 4
    lp = rng.normal(size=(b, c, k, h, w)).astype(np.float32)
    lp[0, 0, 0] = 1.5  # a whole map of ties: lowest indices first
    feats = rng.normal(size=(b, h, w, d)).astype(np.float32)
    pj = jp.top_t_pool(lp, feats, t)
    pt = tp.top_t_pool(_t(lp), _t(feats), t)
    np.testing.assert_array_equal(pt.log_act.numpy(), np.asarray(pj.log_act))
    np.testing.assert_array_equal(pt.top1_idx.numpy(), np.asarray(pj.top1_idx))
    np.testing.assert_array_equal(pt.top1_feat.numpy(), np.asarray(pj.top1_feat))
    labels = np.array([2, 0], np.int32)
    np.testing.assert_array_equal(
        tp.mine_mask_activations(pt.log_act, _t(labels)).numpy(),
        np.asarray(jp.mine_mask_activations(pj.log_act, labels)),
    )
    idx = rng.integers(0, 3, size=(b, c, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        tp.dedup_first_occurrence(_t(idx)).numpy(),
        np.asarray(jp.dedup_first_occurrence(idx)),
    )


def _jax_unfused(feat, means, sigmas, t):
    b, hw, d = feat.shape
    lp = jg.diag_gaussian_log_prob(feat.reshape(-1, d), means, sigmas)
    lp = lp.reshape(b, hw, -1).transpose(0, 2, 1)
    return jax.lax.top_k(lp, t)


@pytest.mark.parametrize("hw,c,k", [(16, 4, 3), (49, 30, 10)])  # P = 12, 300
def test_score_pool_plain_matches_jax(hw, c, k):
    rng = np.random.default_rng(2)
    b, d, t = 2, 16, 4
    feat = _feat(rng, b, hw, d)
    means, sigmas = _protos(rng, c, k, d)
    vals, idx = score_pool_plain(_t(feat), _t(means), _t(sigmas), t)
    assert vals.shape == idx.shape == (b, c * k, t)
    vu, iu = _jax_unfused(feat, means, sigmas, t)
    vf, if_ = jax_score_pool(jnp.asarray(feat), means, sigmas, t, 1e-10, True)
    for v_ref, i_ref in ((vu, iu), (vf, if_)):
        np.testing.assert_allclose(vals.numpy(), np.asarray(v_ref), atol=ATOL)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
    # on a CPU tensor the public wrapper is the plain version
    v2, i2 = score_pool(_t(feat), _t(means), _t(sigmas), t)
    np.testing.assert_array_equal(v2.numpy(), vals.numpy())
    np.testing.assert_array_equal(i2.numpy(), idx.numpy())


def _tie_inputs():
    """Dyadic inputs whose densities are exact in f32 in any summation order:
    every patch value repeats at 7 positions, so each prototype's top-T is
    made of exact ties."""
    rng = np.random.default_rng(3)
    b, hw, d, c, k = 2, 49, 8, 3, 4
    base = rng.integers(-4, 5, size=(b, 7, d)).astype(np.float32) / 8
    feat = np.concatenate([base] * 7, axis=1)  # row n = base[n % 7]
    means = rng.integers(-4, 5, size=(c, k, d)).astype(np.float32) / 8
    sigmas = np.full((c, k, d), 0.5, np.float32)
    return feat, means, sigmas


def test_score_pool_ties_break_to_lowest_index():
    feat, means, sigmas = _tie_inputs()
    t = 10
    vals, idx = score_pool_plain(_t(feat), _t(means), _t(sigmas), t)
    _, iu = _jax_unfused(feat, means, sigmas, t)
    _, if_ = jax_score_pool(jnp.asarray(feat), means, sigmas, t, 1e-10, True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(iu))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(if_))
    v, i = vals.numpy(), idx.numpy()
    tied = v[..., 1:] == v[..., :-1]
    assert tied.any()
    assert (i[..., 1:][tied] > i[..., :-1][tied]).all()  # ascending within ties
    assert (i[..., 0] < 7).all()  # the best value's first occurrence


def _epilogue_inputs(dtype, shape=(2, 9, 9, 64), seed=4):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    r = rng.normal(size=shape).astype(np.float32)
    mean = rng.normal(scale=0.1, size=c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    bias = rng.normal(scale=0.1, size=c).astype(np.float32)
    jx, jr = jnp.asarray(x, dtype), jnp.asarray(r, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    # [B, H, W, C] storage read as NCHW: channels_last, the trunk's layout
    tx = _t(x).to(tdt).permute(0, 3, 1, 2)
    tr = _t(r).to(tdt).permute(0, 3, 1, 2)
    return (jx, jr, tx, tr), tuple(map(_t, (mean, var, scale, bias))), (mean, var, scale, bias)


@pytest.mark.parametrize("dtype,rtol,atol", [
    (jnp.float32, 1e-5, 1e-5), (jnp.bfloat16, 2e-2, 3e-2),
])
def test_epilogue_plain_matches_jax_kernel(dtype, rtol, atol):
    (jx, jr, tx, tr), tstats, jstats = _epilogue_inputs(dtype)
    ref = jfe.fused_bn_epilogue(jx, *jstats, jr, interpret=True)
    out = tfe.fused_bn_epilogue(tx, *tstats, tr)
    assert out.dtype == tx.dtype
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(
        out.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(ref.astype(jnp.float32)), rtol=rtol, atol=atol,
    )


def test_epilogue_refuses_a_layout_it_would_have_to_copy():
    (_, _, tx, tr), tstats, _ = _epilogue_inputs(jnp.float32)
    with pytest.raises(ValueError, match="channels_last"):
        tfe.fused_bn_epilogue(tx.contiguous(), *tstats, tr.contiguous())


def test_cpu_tensors_leave_launch_counters_at_zero():
    score_pool.launches = 0
    score_pool_bwd.launches = 0
    em_estep_stats.launches = 0
    tfe.fused_bn_epilogue.launches = 0
    rng = np.random.default_rng(5)
    means, sigmas = _protos(rng, 2, 3, 8)
    feat = _t(_feat(rng, 1, 16, 8)).requires_grad_()
    vals, _ = score_pool(feat, _t(means), _t(sigmas), 4)
    vals.sum().backward()
    em_estep_stats(_t(_feat(rng, 2, 16, 8)), _t(means), _t(sigmas), torch.full((2, 3), 1 / 3))
    (_, _, tx, tr), tstats, _ = _epilogue_inputs(jnp.float32)
    tfe.fused_bn_epilogue(tx, *tstats, tr)
    assert score_pool.launches == score_pool_bwd.launches == 0
    assert em_estep_stats.launches == 0
    assert tfe.fused_bn_epilogue.launches == 0


@pytest.mark.parametrize("hw,c,k", [(16, 4, 3), (49, 30, 10)])  # P = 12, 300
def test_score_pool_feature_gradient_matches_jax_vjp(hw, c, k):
    """The autograd Function's backward (plain version on the CPU) against
    the JAX custom VJP, whose backward is the Pallas `_bwd_kernel` run in
    interpret mode; and the plain backward formula on its own."""
    rng = np.random.default_rng(6)
    b, d, t = 2, 16, 4
    feat = _feat(rng, b, hw, d)
    means, sigmas = _protos(rng, c, k, d)
    g = rng.normal(size=(b, c * k, t)).astype(np.float32)

    def f(x):
        return jax_score_pool(x, means, sigmas, t, 1e-10, True)[0]

    vals_j, vjp = jax.vjp(f, jnp.asarray(feat))
    (grad_j,) = vjp(jnp.asarray(g))
    tf = _t(feat).requires_grad_()
    vals, idx = score_pool(tf, _t(means), _t(sigmas), t)
    vals.backward(_t(g))
    np.testing.assert_allclose(vals.detach().numpy(), np.asarray(vals_j), atol=ATOL)
    grad_j = np.asarray(grad_j)
    tol = 1e-5 * np.abs(grad_j).max()
    np.testing.assert_allclose(tf.grad.numpy(), grad_j, rtol=0, atol=tol)
    msc, ivar, _ = tg.precompute_diag_gaussian(_t(means), _t(sigmas), 1e-10)
    direct = score_pool_bwd_plain(_t(g), idx.int(), _t(feat), msc, ivar)
    np.testing.assert_allclose(direct.numpy(), grad_j, rtol=0, atol=tol)


@pytest.mark.parametrize("a,n,k,d", [(3, 40, 3, 8), (2, 64, 10, 16)])
def test_em_estep_stats_matches_jax(a, n, k, d):
    rng = np.random.default_rng(7)
    x = _feat(rng, a, n, d)
    means, sigmas = _protos(rng, a, k, d)
    priors = rng.uniform(0.05, 1.0, size=(a, k)).astype(np.float32)
    priors /= priors.sum(-1, keepdims=True)
    ref = jax_em_estep_stats(x, means, sigmas, priors, 1e-10, interpret=True)
    out = em_estep_stats(_t(x), _t(means), _t(sigmas), _t(priors))
    plain = em_estep_stats_plain(_t(x), _t(means), _t(sigmas), _t(priors))
    ll_j = np.asarray(ref[0])
    for got in (out, plain):
        np.testing.assert_allclose(got[0].numpy(), ll_j, atol=1e-4)
        for o, r in zip(got[1:], ref[1:]):
            r = np.asarray(r)
            np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())
    assert torch.allclose(out[1].sum(-1), torch.full((a,), float(n)), atol=1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_batchnorm_train_mode_matches_flax(fused):
    """Train-mode BatchNorm (plain and as the epilogue's tail) against flax:
    output, input gradient (through the batch statistics) and the new
    running statistics with flax's biased variance."""
    rng = np.random.default_rng(8)
    shape, c = (3, 5, 5, 16), 16
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    r = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(scale=0.1, size=c).astype(np.float32)}
    stats = {"mean": rng.normal(scale=0.1, size=c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    if fused:
        jmod = jfe.BNEpilogue()

        def apply(v, xx):
            return jmod.apply(v, xx, r, use_running_average=False, mutable=["batch_stats"])
    else:
        jmod = JaxBatchNorm()

        def apply(v, xx):
            return jmod.apply(v, xx, use_running_average=False, mutable=["batch_stats"])
    variables = {"params": params, "batch_stats": stats}
    (y_j, new_j), vjp = jax.vjp(lambda xx: apply(variables, xx), jnp.asarray(x))
    (gx_j,) = vjp((jnp.asarray(g), jax.tree_util.tree_map(jnp.zeros_like, new_j)))

    bn = (tfe.BNEpilogue(c) if fused else BatchNorm(c)).train()
    bn.load_state_dict({
        "weight": _t(params["scale"]), "bias": _t(params["bias"]),
        "running_mean": _t(stats["mean"]), "running_var": _t(stats["var"]),
        "num_batches_tracked": torch.tensor(0),
    })
    tx = _t(x).permute(0, 3, 1, 2).requires_grad_()
    y = bn(tx, _t(r).permute(0, 3, 1, 2)) if fused else bn(tx)
    y.backward(_t(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx_j), atol=1e-5)
    bs = new_j["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(bs["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(bs["var"]), atol=1e-5)
    # torch's own BatchNorm2d moves the running variance by N/(N-1) more
    n = x.size // c
    unbiased = 0.9 * stats["var"] + 0.1 * x.reshape(-1, c).var(0, ddof=1)
    assert np.abs(bn.running_var.numpy() - unbiased).max() > 1e-3 / n

