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
ulp (rtol 2^-7) in bf16. The score_pool backward and the E-step statistics:
atol 1e-5 x the largest magnitude of the plain output (summation order), ll
atol 1e-4; both are also bitwise-equal across two launches, and the E-step
gives a class the same bits in any slab of classes. Autograd
through the kernels against autograd through the plain versions: the same
tolerances on the gradients.
"""

import pytest
import torch

from mgproto_tpu_torch.ops import _build
from mgproto_tpu_torch.ops import fused_epilogue as fe
from mgproto_tpu_torch.ops.em_kernels import em_estep_stats, em_estep_stats_plain, launch_em_estep
from mgproto_tpu_torch.ops.fused_scoring import (
    KERNEL_MAX_D,
    KERNEL_MAX_T,
    launch_score_pool,
    launch_score_pool_bwd,
    score_pool,
    score_pool_bwd,
    score_pool_bwd_plain,
    score_pool_plain,
)
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
    srt, _ = idx.sort(-1)
    assert bool((srt[..., 1:] != srt[..., :-1]).all()), "an index repeats within a top-T list"


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


def _close_to_plain(got, want, scale=1e-5):
    torch.testing.assert_close(got, want, rtol=0, atol=scale * want.abs().max().item())


@pytest.mark.cuda
def test_score_pool_gradient_flows():
    """The forward and backward kernels under autograd, against autograd of
    the plain version on the same (near-tie-free) indices."""
    _need_cuda()
    feat, means, sigmas = _score_inputs(2, 49, 7, 10, 64, seed=3)  # P = 70
    g = torch.randn(2, 70, 20, generator=torch.Generator().manual_seed(4)).cuda()
    fwd, bwd = score_pool.launches, score_pool_bwd.launches
    x = feat.clone().requires_grad_()
    vals, idx = score_pool(x, means, sigmas, 20)
    vals.backward(g)
    assert (score_pool.launches, score_pool_bwd.launches) == (fwd + 1, bwd + 1)
    xp = feat.clone().requires_grad_()
    pvals, pidx = score_pool_plain(xp, means, sigmas, 20)
    assert torch.equal(idx, pidx)
    pvals.backward(g)
    _close_to_plain(x.grad, xp.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [196, 784])
def test_score_pool_bwd_kernel_matches_plain_and_is_deterministic(hw):
    _need_cuda()
    feat, means, sigmas = _score_inputs(3, hw, 30, 10, 64, seed=5)  # P = 300, ragged tile
    _, idx = score_pool(feat, means, sigmas, 20)
    msc, ivar, _ = (t.contiguous() for t in precompute_diag_gaussian(means, sigmas, 1e-10))
    g = torch.randn(3, 300, 20, generator=torch.Generator().manual_seed(6)).cuda()
    idx32 = idx.int().contiguous()
    out = launch_score_pool_bwd(g, idx32, feat, msc, ivar)
    again = launch_score_pool_bwd(g, idx32, feat, msc, ivar)
    assert torch.equal(out, again)
    _close_to_plain(out, score_pool_bwd_plain(g, idx32, feat, msc, ivar))
    assert torch.equal(score_pool_bwd(g, idx32, feat, msc, ivar), out)


P_RAGGED = 2037  # 2000 + 37: the last prototype tile of either kernel is partial


def _ragged_inputs(b, hw, seed):
    """Flagship-width features and a ragged prototype count (C = 2037, K = 1)."""
    return _score_inputs(b, hw, P_RAGGED, 1, 64, seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 20])
@pytest.mark.parametrize("hw", [49, 196, 784])
@pytest.mark.parametrize("b", [1, 8, 80])
def test_score_pool_kernel_at_flagship_widths(b, hw, t):
    """The forward at the serve and train batch sizes, every feature-map
    size the configurations give, T = 1 and 20, and a ragged P."""
    _need_cuda()
    feat, means, sigmas = _ragged_inputs(b, hw, seed=10 + hw + t)
    before = score_pool.launches
    vals, idx = score_pool(feat, means, sigmas, t)
    again, idx2 = score_pool(feat, means, sigmas, t)
    assert score_pool.launches == before + 2
    assert vals.shape == (b, P_RAGGED, t) and torch.isfinite(vals).all()
    assert torch.equal(vals, again) and torch.equal(idx, idx2)
    pvals, pidx = score_pool_plain(feat, means, sigmas, t)
    assert_score_pool_close(vals, idx, pvals, pidx, _densities(feat, means, sigmas))


def _bwd_case(b, hw, t, g_kind, hub, seed):
    """Inputs of the backward: the forward's indices and a gradient that is
    dense, mined (the train step's pattern: a sample's own class keeps all
    T levels, every other prototype its top-1) or zero. `hub` makes every
    feature row of a sample equal, so every prototype picks the same T
    patches (ties go to the lowest indices)."""
    feat, means, sigmas = _ragged_inputs(b, hw, seed)
    if hub:
        feat = feat[:, :1].expand(b, hw, feat.shape[-1]).contiguous()
    _, idx = score_pool(feat, means, sigmas, t)
    msc, ivar, _ = (x.contiguous() for x in precompute_diag_gaussian(means, sigmas, 1e-10))
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.randn(b, P_RAGGED, t, generator=gen)
    if g_kind == "mined":
        k = 10  # prototypes per class, as at the flagship
        labels = torch.randint(0, P_RAGGED // k, (b,), generator=gen)
        own = (torch.arange(P_RAGGED)[None, :] // k) == labels[:, None]
        g = g * (own[:, :, None] | (torch.arange(t) == 0)[None, None, :])
    elif g_kind == "zero":
        g = torch.zeros_like(g)
    return g.cuda(), idx.int().contiguous(), feat, msc, ivar


@pytest.mark.cuda
@pytest.mark.parametrize("g_kind", ["dense", "mined"])
@pytest.mark.parametrize("t", [1, 20])
@pytest.mark.parametrize("hw", [49, 196, 784])
def test_score_pool_bwd_kernel_at_flagship_widths(hw, t, g_kind):
    _need_cuda()
    g, idx, feat, msc, ivar = _bwd_case(8, hw, t, g_kind, hub=False, seed=20 + hw + t)
    before = score_pool_bwd.launches
    out = launch_score_pool_bwd(g, idx, feat, msc, ivar)
    again = launch_score_pool_bwd(g, idx, feat, msc, ivar)
    assert score_pool_bwd.launches == before + 2
    assert torch.equal(out, again)
    _close_to_plain(out, score_pool_bwd_plain(g, idx, feat, msc, ivar))


@pytest.mark.cuda
@pytest.mark.parametrize("g_kind", ["dense", "mined"])
@pytest.mark.parametrize("hw", [196, 784])
def test_score_pool_bwd_kernel_on_hub_patches(hw, g_kind):
    """Every prototype's top-T on the same T patches: each of those patches
    gathers P entries (split over many warps), the rest none."""
    _need_cuda()
    g, idx, feat, msc, ivar = _bwd_case(8, hw, 20, g_kind, hub=True, seed=30 + hw)
    assert bool((idx < 20).all()), "the hub input did not concentrate the top-T lists"
    out = launch_score_pool_bwd(g, idx, feat, msc, ivar)
    again = launch_score_pool_bwd(g, idx, feat, msc, ivar)
    assert torch.equal(out, again)
    _close_to_plain(out, score_pool_bwd_plain(g, idx, feat, msc, ivar))
    assert torch.equal(out[:, 20:], torch.zeros_like(out[:, 20:]))


@pytest.mark.cuda
@pytest.mark.parametrize("hub", [False, True])
def test_score_pool_bwd_kernel_zero_gradient_is_exactly_zero(hub):
    _need_cuda()
    g, idx, feat, msc, ivar = _bwd_case(8, 196, 20, "zero", hub=hub, seed=40)
    out = launch_score_pool_bwd(g, idx, feat, msc, ivar)
    assert torch.equal(out, torch.zeros_like(out))


def _estep_inputs(a, n, k, d, seed):
    """A bank slab of unit rows and components with sigmas in 0.3-0.5, so
    responsibilities are sharp."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.nn.functional.normalize(torch.randn(a, n, d, generator=g, device="cuda"), dim=-1)
    means = torch.nn.functional.normalize(torch.randn(a, k, d, generator=g, device="cuda"), dim=-1)
    sigmas = 0.3 + 0.2 * torch.rand(a, k, d, generator=g, device="cuda")
    priors = torch.softmax(torch.randn(a, k, generator=g, device="cuda"), -1)
    return x, means, sigmas, priors


# N around the kernel's 64-row blocks (1, 63, 64, 65), the flagship's 800
# (a ragged last block of 32) and 1000
@pytest.mark.cuda
@pytest.mark.parametrize("a", [1, 80, 200])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 800, 1000])
@pytest.mark.parametrize("k", [1, 3, 10, 32])
def test_em_estep_kernel_matches_plain(a, n, k):
    """Kernel vs plain (ll atol 1e-4; s/sx/sxx 1e-5 x max), one launch
    counted per E-step, and bitwise-equal repeats."""
    _need_cuda()
    x, means, sigmas, priors = _estep_inputs(a, n, k, 64, seed=7 + n + k)
    before = em_estep_stats.launches
    got = em_estep_stats(x, means, sigmas, priors)
    assert em_estep_stats.launches == before + 1
    again = em_estep_stats(x, means, sigmas, priors)
    want = em_estep_stats_plain(x, means, sigmas, priors)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    for o, r in zip(got[1:], want[1:]):
        _close_to_plain(o, r)
    for o, r in zip(got, again):
        assert torch.equal(o, r), "two launches differ"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 10])
def test_em_estep_kernel_is_slab_independent(k):
    """Classes run in a compact slab of 80 give the same bits as the same
    classes inside the A=200 call (the dense fallback)."""
    _need_cuda()
    x, means, sigmas, priors = _estep_inputs(200, 800, k, 64, seed=11)
    idx = torch.randperm(200, generator=torch.Generator().manual_seed(12))[:80].cuda()
    full = em_estep_stats(x, means, sigmas, priors)
    slab = em_estep_stats(*(t[idx].contiguous() for t in (x, means, sigmas, priors)))
    for f, s_ in zip(full, slab):
        assert torch.equal(f[idx], s_)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 8, 16, 60])
def test_em_estep_kernel_narrow_features(d):
    """Features narrower than 64 (a multiple of 4) against plain."""
    _need_cuda()
    x, means, sigmas, priors = _estep_inputs(3, 100, 10, d, seed=13)
    got = em_estep_stats(x, means, sigmas, priors)
    want = em_estep_stats_plain(x, means, sigmas, priors)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    for o, r in zip(got[1:], want[1:]):
        _close_to_plain(o, r)


@pytest.mark.parametrize("k,d", [(33, 64), (10, 6), (10, 68), (10, 0)])
def test_em_estep_kernel_refuses_shapes_it_does_not_take(k, d):
    """The kernel takes K <= 32 and d a multiple of 4 up to 64; other
    shapes are refused before anything is built or launched."""
    x = torch.zeros(2, 8, d)
    consts = torch.zeros(2, k, d), torch.ones(2, k, d), torch.zeros(2, k)
    with pytest.raises(ValueError, match="em_estep kernel takes"):
        launch_em_estep(x, *consts)


@pytest.mark.cuda
def test_epilogue_autograd_matches_plain():
    """Train mode: the kernel forward with the recomputed backward against
    autograd of the plain arithmetic, gradients for all six inputs."""
    _need_cuda()
    gen = torch.Generator().manual_seed(8)
    c = 64
    shape = (2, 7, 7, c)

    def leaves():
        g2 = torch.Generator().manual_seed(9)
        x = torch.randn(shape, generator=g2).cuda().permute(0, 3, 1, 2)
        r = torch.randn(shape, generator=g2).cuda().permute(0, 3, 1, 2)
        stats = [(0.1 * torch.randn(c, generator=g2)).cuda(), (0.5 + torch.rand(c, generator=g2)).cuda(),
                 (0.5 + torch.rand(c, generator=g2)).cuda(), (0.1 * torch.randn(c, generator=g2)).cuda()]
        return [t.requires_grad_() for t in (x, *stats, r)]

    g = torch.randn(shape, generator=gen).cuda().permute(0, 3, 1, 2)
    kin = leaves()
    before = fe.fused_bn_epilogue.launches
    out = fe.fused_bn_epilogue(*kin)
    assert fe.fused_bn_epilogue.launches == before + 1
    out.backward(g)
    pin = leaves()
    ref = fe.epilogue_reference(*pin, 1e-5, torch.float32)
    ref.backward(g)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    for a, b in zip(kin, pin):
        _close_to_plain(a.grad, b.grad)


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


@pytest.mark.parametrize("t,d", [(KERNEL_MAX_T + 1, 8), (4, KERNEL_MAX_D + 1)])
def test_score_pool_kernels_refuse_widths_they_do_not_take(t, d):
    """The forward keeps at most KERNEL_MAX_T levels in registers and both
    kernels take d <= KERNEL_MAX_D; wider inputs are refused before anything
    is built or launched."""
    feat = torch.zeros(1, 2 * KERNEL_MAX_T, d)
    consts = torch.zeros(3, d), torch.ones(3, d), torch.zeros(3)
    with pytest.raises(ValueError, match="at most"):
        launch_score_pool(feat, *consts, t)
    g = torch.zeros(1, 3, t)
    idx = torch.zeros(1, 3, t, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        launch_score_pool_bwd(g, idx, feat, *consts[:2])


def test_a_failed_kernel_build_raises(monkeypatch, tmp_path):
    """No fallback: a build that nvcc refuses raises, naming the kernel."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(_build.KernelBuildError, match="em_estep"):
        _build.build_all(["em_estep", "score_pool_bwd"])


@pytest.mark.cuda
def test_augment_tail_on_the_card_matches_the_cpu():
    """The device augmentation tail (plain PyTorch, ops/augment.py) on the
    card against the same function on the CPU: f32 elementwise ops in one
    order, so within 1e-5 absolute in normalized units."""
    _need_cuda()
    import numpy as np

    from mgproto_tpu_torch.data.loader import augment_seeds
    from mgproto_tpu_torch.ops.augment import augment_draws, augment_tail

    images = torch.randint(0, 256, (8, 224, 224, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    draws = torch.from_numpy(augment_draws(augment_seeds(0, 0, np.arange(8))))
    want = augment_tail(images, draws)
    got = augment_tail(images.cuda(), draws.cuda())
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert (got.cpu() - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_put_batch_copies_on_the_copy_stream():
    """Trainer.put_batch on CUDA: pinned staging, copies on the copy stream
    behind an event, uint8 kept, the draws made from the seeds; the step's
    stream waits for the event before reading the tensors."""
    _need_cuda()
    import numpy as np

    from mgproto_tpu_torch.config import DataConfig, tiny_test_config
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.ops.augment import augment_draws

    cfg = tiny_test_config().replace(data=DataConfig(device_augment=True))
    trainer = Trainer(cfg, steps_per_epoch=1, device="cuda")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(4, 32, 32, 3), dtype=np.uint8)
    labels = np.array([0, 1, 2, 3], np.int32)
    seeds = np.array([1, 2, 3, 4], np.uint32)
    batch = trainer._claim(trainer.put_batch((images, labels, np.arange(4), seeds)))
    assert batch.ready is not None and batch.images.dtype == torch.uint8
    assert batch.images.device.type == batch.draws.device.type == "cuda"
    assert np.array_equal(batch.images.cpu().numpy(), images)
    assert np.array_equal(batch.labels.cpu().numpy(), labels)
    assert np.array_equal(batch.draws.cpu().numpy(), augment_draws(seeds))
    assert batch.copy_ms() > 0.0
    state = trainer.init_state(0)
    state, met = trainer.train_step(state, images, labels, use_mine=True, update_gmm=False,
                                    seeds=seeds)
    assert np.isfinite(met.loss.item())


def _tiny_cuda_trainer(device_augment=False):
    from mgproto_tpu_torch.config import DataConfig, tiny_test_config
    from mgproto_tpu_torch.engine.train import Trainer

    cfg = tiny_test_config().replace(data=DataConfig(device_augment=device_augment))
    return cfg, Trainer(cfg, steps_per_epoch=4, device="cuda")


def _full_bank(state, seed=1):
    g = torch.Generator().manual_seed(seed)
    mem = state.memory
    feats = torch.nn.functional.normalize(torch.randn(mem.feats.shape, generator=g), dim=-1)
    return mem._replace(feats=feats.to(mem.feats.device),
                        length=torch.full_like(mem.length, mem.capacity))


@pytest.mark.cuda
def test_a_sentinel_row_trains_on_the_card():
    """A batch holding the loader's sentinel row (zero image, label -1) runs
    through the kernels on the card: a finite loss within 1e-4 of the same
    step on the CPU, and the bank untouched by that row (its class -1 is
    dropped: the lengths and written slots match the CPU's)."""
    _need_cuda()
    import numpy as np

    cfg, trainer = _tiny_cuda_trainer()
    assert trainer.fused
    rng = np.random.default_rng(0)
    images = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 1, -1, 1, 0, 2], np.int32)
    images[2] = 0.0
    out = {}
    for dev, tr in (("cuda", trainer), ("cpu", type(trainer)(cfg, 4, device="cpu"))):
        state = tr.init_state(0)
        state.memory = _full_bank(state)
        before = state.memory.feats.clone()
        state, met = tr.train_step(state, images, labels, use_mine=True, update_gmm=True)
        written = (state.memory.feats != before).any(-1).cpu()
        out[dev] = (met.loss.item(), state.memory.length.cpu(), written)
    assert np.isfinite(out["cuda"][0]) and abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert torch.equal(out["cuda"][2], out["cpu"][2]) and not out["cuda"][2][3].any()


@pytest.mark.cuda
def test_a_checkpoint_crosses_between_the_card_and_the_cpu(tmp_path):
    """A trained state on the card saved, restored into a CPU state, saved
    again and restored onto the card: every tensor, Adam state and counter
    bit for bit."""
    _need_cuda()
    import numpy as np

    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils import checkpoint as ck

    cfg, trainer = _tiny_cuda_trainer()
    state = trainer.init_state(0)
    state.memory = _full_bank(state)
    rng = np.random.default_rng(1)
    for _ in range(2):
        images = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
        trainer.train_step(state, images, np.array([0, 1, 2, 3, 0, 1], np.int32),
                           use_mine=True, update_gmm=True)
    path = ck.save_checkpoint(str(tmp_path), state, "0nopush0.5000")
    cpu = ck.restore_checkpoint(path, Trainer(cfg, 4, device="cpu").init_state(3))
    back_path = ck.save_checkpoint(str(tmp_path), cpu, "1nopush0.5000")
    back = ck.restore_checkpoint(back_path, trainer.init_state(4))
    want = dict(ck._tensors(ck.state_payload(state)))
    for restored, dev in ((cpu, "cpu"), (back, "cuda")):
        got = dict(ck._tensors(ck.state_payload(restored)))
        assert got.keys() == want.keys()
        for k in want:
            if not k.endswith("/step"):  # Adam's step lives on the host
                assert got[k].device.type == dev, k
            assert torch.equal(got[k].cpu(), want[k].cpu()), k
        assert (restored.step, restored.joint_updates) == (state.step, state.joint_updates)


@pytest.mark.cuda
def test_evaluate_on_the_card_matches_the_cpu():
    """The test pass (engine/evaluate.py) of one state on the card, through
    the score_pool kernel, against the CPU's plain route: per-sample log
    p(x) and CE within 1e-4, the same accuracy; the model is back in train
    mode after it."""
    _need_cuda()
    import numpy as np

    from mgproto_tpu_torch.engine import evaluate as ev
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils import checkpoint as ck

    cfg, trainer = _tiny_cuda_trainer()
    state = trainer.init_state(0)
    cpu_trainer = Trainer(cfg, 4, device="cpu")
    cpu = cpu_trainer.init_state(0)
    payload = ck.state_payload(state)
    cpu.model.load_state_dict(payload["model"])
    with torch.no_grad():
        cpu.gmm.means.copy_(state.gmm.means.cpu())
    rng = np.random.default_rng(2)
    batches = [(rng.normal(size=(6, 32, 32, 3)).astype(np.float32),
                np.array([0, 1, 2, 3, 0, -1], np.int32)) for _ in range(3)]
    got = ev._run_eval(trainer, state, batches)
    want = ev._run_eval(cpu_trainer, cpu, batches)
    assert state.model.training and got[0].shape == (15,)
    assert np.abs(got[0] - want[0]).max() <= 1e-4
    assert abs(got[2] - want[2]) <= 1e-4 * got[3]
    assert np.array_equal(got[1], want[1])


@pytest.mark.cuda
def test_batched_peaks_on_the_card_match_the_host_path():
    """`peak_positions` upsamples a class's maps on the card in chunks and
    brings back only the argmaxes: against the scalar `peak_box`, which
    upsamples one map on the host, equal, or one pixel off in each axis on
    at most 1 % of maps (the card's and the CPU's bicubic round
    differently, which moves near-tie argmaxes)."""
    _need_cuda()
    import numpy as np

    from mgproto_tpu_torch.engine.interpretability import peak_box, peak_positions

    maps = np.random.default_rng(0).lognormal(size=(300, 10, 14, 14)).astype(np.float32)
    got = peak_positions(torch.from_numpy(maps).cuda(), 224)
    assert got.shape == (300, 10, 2)
    want = np.array([[peak_box(m, 224, 0)[::2] for m in row] for row in maps])
    diff = np.abs(got - want)
    assert diff.max() <= 1 and diff.any(-1).sum() <= 0.01 * 3000, diff.any(-1).sum()


@pytest.mark.cuda
def test_a_render_on_the_card_matches_the_cpu(tmp_path):
    """A push with `save_dir` on the card and the same state's push on the
    CPU: the same pushes and file names; where a prototype's crop has the
    same size on both sides, its crop and its boxed original decode to the
    same pixels and its overlay within 1 level on average (the maps differ
    by ~1e-6, which can move one jet level); at most one prototype's box
    may move by one pixel (a near-tie at the 95th percentile)."""
    _need_cuda()
    import os

    import numpy as np
    from PIL import Image

    from mgproto_tpu_torch.engine.push import push_prototypes
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils import checkpoint as ck

    cfg, trainer = _tiny_cuda_trainer()
    state = trainer.init_state(0)
    cpu_trainer = Trainer(cfg, 4, device="cpu")
    cpu = cpu_trainer.init_state(0)
    cpu.model.load_state_dict(ck.state_payload(state)["model"])
    with torch.no_grad():
        cpu.gmm.means.copy_(state.gmm.means.cpu())
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(12, 32, 32, 3)).astype(np.float32)
    batches = [(images[i:i + 6], np.array([0, 1, 2, 3, 0, 1]), np.arange(i, i + 6))
               for i in (0, 6)]
    out = {}
    for dev, tr, st in (("cuda", trainer, state), ("cpu", cpu_trainer, cpu)):
        _, res = push_prototypes(tr, st, batches, save_dir=str(tmp_path / dev), epoch=0,
                                 load_image=lambda i: images[i])
        d = tmp_path / dev / "epoch-0"
        files = {}
        for name in os.listdir(d):
            with Image.open(d / name) as im:
                files[name] = np.asarray(im).astype(np.int16)
        out[dev] = (res, files)
    (rc, fc), (rp, fp) = out["cuda"], out["cpu"]
    assert np.array_equal(rc.image_id, rp.image_id) and set(fc) == set(fp)
    assert len(fc) == 3 * int(rc.pushed.sum()) > 0
    moved = []
    for c, k in np.argwhere(rc.pushed):
        j = c * rc.pushed.shape[1] + k
        crop, orig, over = (f"{j}prototype-img.jpg", f"{j}prototype-img-original.jpg",
                            f"{j}prototype-img-original_with_self_act.jpg")
        if fc[crop].shape != fp[crop].shape:
            assert np.abs(np.subtract(fc[crop].shape, fp[crop].shape)).max() <= 2, j
            moved.append(j)
            continue
        assert np.array_equal(fc[crop], fp[crop]) and np.array_equal(fc[orig], fp[orig]), j
        assert np.abs(fc[over] - fp[over]).mean() <= 1.0, j
    assert len(moved) <= 1, moved


# ResNet-34 without the stem pool at 224 px, batch 80: the block tails' shapes
# in a training step (H = W, C)
R34_TRAIN_TAILS = ((112, 64), (56, 128), (28, 256), (14, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c", R34_TRAIN_TAILS)
def test_bf16_epilogue_at_the_training_shapes_on_batch_statistics(hw, c):
    """The bf16 kernel at B = 80 on the batch's own f32 statistics (as the
    bf16 train step computes them) against the plain version in f32 rounded
    once to bf16: atol 1e-5 plus one bf16 step (rtol 2^-7); its backward
    equals autograd through the bf16 plain version (the same recomputed
    VJP)."""
    _need_cuda()
    from mgproto_tpu_torch.models.common import BatchNorm

    g = torch.Generator(device="cuda").manual_seed(hw)
    x = torch.randn(80, hw, hw, c, generator=g, device="cuda").bfloat16().permute(0, 3, 1, 2)
    r = torch.randn(80, hw, hw, c, generator=g, device="cuda").bfloat16().permute(0, 3, 1, 2)
    bn = BatchNorm(c).cuda()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.1, generator=g)
    x.requires_grad_(True)
    before = fe.fused_bn_epilogue.launches
    mean, var = bn.batch_statistics(x)
    assert mean.dtype == var.dtype == torch.float32
    out = fe.fused_bn_epilogue(x, mean, var, bn.weight, bn.bias, r)
    assert fe.fused_bn_epilogue.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ref = fe.epilogue_reference(x, mean, var, bn.weight, bn.bias, r, 1e-5,
                                    torch.float32).bfloat16()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7, atol=1e-5)
    if hw == 14:
        gout = torch.randn(out.shape, generator=g, device="cuda").bfloat16()
        (gx,) = torch.autograd.grad(out, x, gout, retain_graph=True)
        plain = fe.epilogue_reference(x, mean, var, bn.weight, bn.bias, r, 1e-5, torch.bfloat16)
        (px,) = torch.autograd.grad(plain, x, gout)
        assert gx.dtype == torch.bfloat16 and torch.equal(gx, px)


@pytest.mark.cuda
def test_a_bf16_train_step_on_the_card_keeps_its_statistics_f32():
    """resnet18 at 32 px in bf16 on the card: the kernels launch (8 block
    tails in bf16, score_pool forward and backward), the loss is finite and
    within 2 % of the same step on the CPU (bf16 rounding on two devices),
    and the bank, the GMM, the BatchNorm statistics, the master parameters
    and the Adam moments stay f32. Eval-mode BatchNorm in bf16 on the card
    equals the CPU's within one bf16 step."""
    _need_cuda()
    import dataclasses

    import numpy as np

    from mgproto_tpu_torch.config import DataConfig, tiny_test_config
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.models.common import BatchNorm

    base = tiny_test_config(arch="resnet18")
    cfg = base.replace(model=dataclasses.replace(base.model, compute_dtype="bfloat16"),
                       data=DataConfig(device_augment=False))
    rng = np.random.default_rng(0)
    images = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 1, 0], np.int32)
    losses = {}
    for dev in ("cuda", "cpu"):
        trainer = Trainer(cfg, 4, device=dev)
        state = trainer.init_state(0)
        state.memory = _full_bank(state)
        before = fe.fused_bn_epilogue.launches
        state, met = trainer.train_step(state, images, labels, use_mine=True, update_gmm=True)
        losses[dev] = met.loss.item()
        assert fe.fused_bn_epilogue.launches - before == (8 if dev == "cuda" else 0)
        for name, t in state.model.state_dict().items():
            assert not t.is_floating_point() or t.dtype == torch.float32, name
        for s in state.opt.state.values():
            assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
        assert state.memory.feats.dtype == torch.float32
        assert all(t.dtype == torch.float32 for t in state.gmm[:3])
    assert np.isfinite(losses["cuda"])
    assert abs(losses["cuda"] - losses["cpu"]) <= 0.02 * abs(losses["cpu"])

    bn = BatchNorm(64).eval()
    with torch.no_grad():
        bn.running_var.uniform_(0.5, 1.5)
        bn.running_mean.normal_(0.0, 0.1)
    x = torch.randn(4, 64, 7, 7).bfloat16().contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        cpu = bn(x)
        card = bn.cuda()(x.cuda()).cpu()
    assert card.dtype == torch.bfloat16
    torch.testing.assert_close(card.float(), cpu.float(), rtol=2.0 ** -7, atol=1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["vgg19", "densenet121"])
def test_vgg_and_densenet_steps_on_the_card_match_the_plain_route(arch):
    """One train step of vgg19 / densenet121 at batch 4, 64 px, from one
    state and a full bank: the kernel route (score_pool forward and
    backward, the E-step) against the plain route on the card (every
    kernel off), cuDNN deterministic: the loss relative 1e-5, the priors
    atol 1e-5; the kernels launched once each (the E-step num_em_loop
    times), the BN epilogue never (a resnet-only kernel)."""
    _need_cuda()
    import dataclasses

    import numpy as np

    from mgproto_tpu_torch.config import DataConfig, EMConfig, tiny_test_config
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.ops.fused_scoring import score_pool as sp

    # f32 batches of seeded noise: no augmentation tail
    base = tiny_test_config(arch=arch, img_size=64).replace(data=DataConfig(device_augment=False))
    rng = np.random.default_rng(0)
    images = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 1], np.int32)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for route, flag in (("kernel", None), ("plain", False)):
            cfg = base.replace(model=dataclasses.replace(base.model, fused_scoring=flag),
                               em=EMConfig(fused_estep=flag))
            trainer = Trainer(cfg, 4, device="cuda")
            state = trainer.init_state(0)
            state.memory = _full_bank(state)
            counters = (sp, score_pool_bwd, em_estep_stats, fe.fused_bn_epilogue)
            before = [f.launches for f in counters]
            state, met = trainer.train_step(state, images, labels, use_mine=True,
                                            update_gmm=True)
            torch.cuda.synchronize()
            out[route] = (met.loss.item(), state.gmm.priors.cpu(),
                          [f.launches - b for f, b in zip(counters, before)])
    finally:
        torch.backends.cudnn.deterministic = det
    loss, priors, launched = out["kernel"]
    assert launched == [1, 1, cfg.em.num_em_loop, 0]
    assert out["plain"][2] == [0, 0, 0, 0]
    assert np.isfinite(loss) and abs(loss - out["plain"][0]) <= 1e-5 * abs(out["plain"][0])
    torch.testing.assert_close(priors, out["plain"][1], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_a_pretrained_trunk_loads_on_the_card(tmp_path, monkeypatch):
    """A seeded torchvision-layout densenet121 .pth (legacy `norm.1` keys)
    read through MGPROTO_PRETRAINED_DIR into a state on the card: every
    trunk tensor equals the file's bit for bit."""
    _need_cuda()
    import dataclasses

    from mgproto_tpu_torch.config import tiny_test_config
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.models.registry import build_backbone

    g = torch.Generator().manual_seed(3)
    sd = {"features." + k: (torch.randn(v.shape, generator=g) if v.is_floating_point() else v)
          for k, v in build_backbone("densenet121").state_dict().items()}
    legacy = {k.replace(".norm1.", ".norm.1."): v for k, v in sd.items()}
    torch.save(legacy, tmp_path / "densenet121-a639ec97.pth")
    monkeypatch.setenv("MGPROTO_PRETRAINED_DIR", str(tmp_path))
    base = tiny_test_config(arch="densenet121")
    cfg = base.replace(model=dataclasses.replace(base.model, pretrained=True))
    state = Trainer(cfg, 4, device="cuda").init_state(0)
    for k, v in state.model.features.state_dict().items():
        assert v.device.type == "cuda"
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v.cpu(), sd["features." + k]), k


@pytest.mark.cuda
def test_an_artifact_served_on_the_card_matches_the_cpu(tmp_path):
    """A resnet18-width artifact (engine/export.py) loaded on the card and
    on the CPU and served with explanations through `ServingEngine`: on
    the card one score_pool launch and 8 epilogue launches (resnet18's
    blocks) a dispatch; logits and log p(x) within 1e-4 of the CPU's plain
    path; the explanations' prototypes equal where the CPU's peaks are
    1e-4 apart, their log-densities within 1e-4."""
    _need_cuda()
    import dataclasses

    import numpy as np

    from mgproto_tpu_torch.config import tiny_test_config
    from mgproto_tpu_torch.core.mgproto import build_mgproto
    from mgproto_tpu_torch.engine import export
    from mgproto_tpu_torch.serving.calibration import gmm_fingerprint
    from mgproto_tpu_torch.serving.engine import ServingEngine

    cfg = tiny_test_config(arch="resnet18")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, fused_scoring=None,
                                                fused_epilogue=None))
    model, gmm = build_mgproto(cfg.model, device="cpu", seed=3)
    path = str(tmp_path / "r18.mgproto")
    export.save_artifact(path, model, gmm,
                         export.artifact_meta(cfg, None, gmm_fingerprint(gmm)),
                         explain=export.explain_table(gmm, top_e=4))
    x = list(np.random.default_rng(4).normal(size=(6, 32, 32, 3)).astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine.from_artifact(path, allow_uncalibrated=True, explain=True,
                                          device=dev, buckets=(8,))
        eng.warmup()
        score_pool.launches = fe.fused_bn_epilogue.launches = 0
        logits, log_px, (idx, logd) = eng._dispatch(np.stack(x))
        out[dev] = (logits, log_px, idx, logd,
                    (score_pool.launches, fe.fused_bn_epilogue.launches))
    assert out["cuda"][4] == (1, 8) and out["cpu"][4] == (0, 0)
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() <= ATOL
    assert np.abs(out["cuda"][1] - out["cpu"][1]).max() <= ATOL
    assert np.abs(out["cuda"][3] - out["cpu"][3]).max() <= ATOL
    gaps = np.diff(out["cpu"][3], axis=1)
    clear = (np.abs(gaps) > ATOL).all(axis=1)
    assert clear.any() and (out["cuda"][2][clear] == out["cpu"][2][clear]).all()


@pytest.mark.cuda
def test_the_explanation_peak_from_the_kernel_matches_the_dense_plain_peak():
    """The served explanation's peak is level 0 of the score_pool kernel's
    values: against the dense plain density's maximum over patches (the
    JAX package's `patch_log_densities` peak) at the flagship's widths
    (B = 8, HW = 196, C·K = 2000, d = 64, T = 20), within 1e-4; the top 5
    over C·K (`ops/pooling.top_t`) picks the same prototypes where the
    plain peaks are 1e-4 apart."""
    _need_cuda()
    from mgproto_tpu_torch.ops.pooling import top_t

    feat, means, sigmas = _score_inputs(8, 196, 200, 10, 64, seed=9)
    vals, _ = score_pool(feat, means, sigmas, 20)
    peak = vals[..., 0]
    dense = _densities(feat, means.reshape(-1, 64), sigmas.reshape(-1, 64)).amax(-1)
    assert (peak - dense).abs().max().item() <= ATOL
    kv, ki = top_t(peak, 5)
    pv, pi = top_t(dense, 5)
    assert (kv - pv).abs().max().item() <= ATOL
    clear = (pv[:, :-1] - pv[:, 1:]).abs().gt(ATOL).all(-1)
    assert clear.any() and torch.equal(ki[clear], pi[clear])


@pytest.mark.cuda
def test_the_async_bank_on_the_card_is_bit_equal_to_the_one_step_stale_oracle():
    """The tiny trunk on the card with a full bank, cuDNN deterministic: four
    async steps (the bank phase on its own stream) and the flush are bit-equal
    to the one-step-stale schedule run from the synchronous trainer's own
    functions on one stream, and the kernels of both launch alike."""
    _need_cuda()
    import dataclasses

    import numpy as np

    from _torch_async_oracle import one_step_stale_oracle
    from mgproto_tpu_torch.config import DataConfig, tiny_test_config
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils.checkpoint import _tensors, state_payload

    base = tiny_test_config().replace(data=DataConfig(device_augment=False))
    rng = np.random.default_rng(4)
    batches = [(rng.normal(size=(6, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 4, size=6).astype(np.int32)) for _ in range(4)]
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        states, launches = {}, {}
        for mode in ("async", "oracle"):
            cfg = base.replace(em=dataclasses.replace(base.em, async_bank=mode == "async"))
            trainer = Trainer(cfg, 4, device="cuda")
            state = trainer.init_state(0)
            state.memory = _full_bank(state)
            before = (score_pool.launches, em_estep_stats.launches)
            if mode == "async":
                assert trainer.async_bank and trainer._bank_stream is not None
                losses = []
                for images, labels in batches:
                    state, met = trainer.train_step(state, images, labels, use_mine=True,
                                                    update_gmm=True)
                    losses.append(met.loss)
                state, flushed = trainer.flush_bank(state)
                assert flushed is not None
            else:
                state, losses = one_step_stale_oracle(trainer, state, batches)
            torch.cuda.synchronize()
            launches[mode] = (score_pool.launches - before[0],
                              em_estep_stats.launches - before[1])
            states[mode] = (dict(_tensors(state_payload(state))), losses, state.step)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    (ta, la, sa), (to, lo, so) = states["async"], states["oracle"]
    assert sa == so == 4 and ta.keys() == to.keys()
    assert [k for k in ta if not torch.equal(ta[k].cpu(), to[k].cpu())] == []
    assert all(torch.equal(a, b) for a, b in zip(la, lo))
    assert launches["async"] == launches["oracle"] and launches["async"][1] > 0



@pytest.mark.cuda
def test_the_online_drill_on_the_card_matches_the_cpu():
    """The drift drill (the tiny model padded to 8 classes, short phases) on
    the card and on the CPU from the same seeded state: the same gate
    verdicts and served-accuracy windows; a consolidation batch launches the
    score_pool kernel once and the E-step num_em_loop times, and after the
    first batch nothing takes a new shape or builds a kernel."""
    _need_cuda()
    import numpy as np

    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.online.capture import CapturedSample
    from mgproto_tpu_torch.online.consolidate import Consolidator, ConsolidatorConfig
    from mgproto_tpu_torch.online.drill import drill_config, run_drill

    kw = dict(phases="0.5x40,1x40", drift_at=30, accuracy_window=20, poison_rate=0.05)
    card, cpu = run_drill(device="cuda", **kw), run_drill(device="cpu", **kw)
    assert [(r["key"], r["ok"]) for r in card["gates"]["rows"]] == \
        [(r["key"], r["ok"]) for r in cpu["gates"]["rows"]]
    assert card["online"]["accuracy_windows"] == cpu["online"]["accuracy_windows"]
    assert card["online"]["consolidation"]["steady_recompiles"] == 0
    cfg = drill_config(8)
    trainer = Trainer(cfg, steps_per_epoch=1, device="cuda")
    cons = Consolidator(trainer, trainer.init_state(0), config=ConsolidatorConfig(batch_width=8))
    x = np.random.default_rng(0).normal(size=(8, 32, 32, 3)).astype(np.float32)
    samples = [CapturedSample(img, i % 4, None, f"s{i}", True) for i, img in enumerate(x)]
    cons.ingest(samples)
    sp0, em0 = score_pool.launches, em_estep_stats.launches
    cons.ingest(samples)
    assert (score_pool.launches - sp0, em_estep_stats.launches - em0) == (1, cfg.em.num_em_loop)
    assert cons.steady_recompiles() == 0


# the corruption ladder on the card against its CPU plain run (the same
# torch ops on both; the tolerance the CPU tests hold the port to against
# JAX, tests/test_torch_corrupt.py)
CORRUPT_ATOL = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["noise", "blur", "contrast", "pixelate"])
def test_each_corruption_family_on_the_card_matches_the_cpu(kind):
    _need_cuda()
    import numpy as np

    from mgproto_tpu_torch.ops.corrupt import SEVERITIES, corrupt_numpy

    x = np.random.default_rng(1).normal(size=(8, 224, 224, 3)).astype(np.float32)
    for severity in SEVERITIES:
        card = corrupt_numpy(x, kind, severity, seed=4, device="cuda")
        cpu = corrupt_numpy(x, kind, severity, seed=4, device="cpu")
        assert np.abs(card - cpu).max() <= CORRUPT_ATOL, (kind, severity)


@pytest.mark.cuda
def test_the_noise_bits_on_the_card_equal_the_host_threefry():
    _need_cuda()
    import numpy as np

    from mgproto_tpu_torch.ops import prng
    from mgproto_tpu_torch.ops.corrupt import _KEY_TAG, per_sample_seeds

    seeds = per_sample_seeds(9, 4, offset=2**32 - 2)  # wraps past 2^32
    keys = np.stack([np.full_like(seeds, _KEY_TAG), seeds], axis=-1)
    bits = prng.normal_bits_torch(torch.from_numpy(keys.astype(np.int64)).cuda(), (224, 224, 3))
    n = 224 * 224 * 3
    for row, key in zip(bits.cpu().numpy(), keys):
        hi, lo = prng.threefry2x32(key, np.uint32(0), np.arange(n, dtype=np.uint32))
        np.testing.assert_array_equal(row.astype(np.uint32), hi ^ lo)
    normals = prng.normal_torch(torch.from_numpy(keys.astype(np.int64)).cuda(), (224, 224, 3))
    want = np.stack([prng.normal(k, (224, 224, 3)) for k in keys])
    assert np.abs(normals.cpu().numpy() - want).max() <= prng.NORMAL_ATOL


@pytest.mark.cuda
def test_the_trust_drill_on_the_card_matches_the_cpu():
    """The hermetic trust drill at the reduced size on the card and on the
    CPU from the same seeded state: the same gate verdicts, outcome counts
    equal but where the CPU's score is a near tie with the threshold, and
    scores within 1e-4; no cold dispatch."""
    _need_cuda()
    from mgproto_tpu_torch.cli.trust import run_synthetic_matrix

    kw = dict(seed=0, per_class=8, bootstrap_epochs=12, config_overrides={"monotone_tol": 0.30})
    cpu = run_synthetic_matrix(device="cpu", **kw)
    card = run_synthetic_matrix(device="cuda", **kw)
    assert [(r["key"], r["ok"]) for r in card["gates"]["rows"]] == \
        [(r["key"], r["ok"]) for r in cpu["gates"]["rows"]]
    assert card["steady_state_recompiles"] == 0
    thr = cpu["config"]["threshold_log_px"]
    cells = lambda r: [r["id"]] + r["pairs"] + [c for k in sorted(r["ladder"])  # noqa: E731
                                                for c in r["ladder"][k]]
    for a, b in zip(cells(card), cells(cpu)):
        if a["outcomes"] != b["outcomes"]:
            assert any(abs(s - thr) <= 2e-4 for s in b["scores"]), (a["outcomes"], b["outcomes"])
        elif len(a["scores"]) == len(b["scores"]):
            assert max((abs(x - y) for x, y in zip(a["scores"], b["scores"])), default=0) <= 1e-4


# ------------------------------------------------------- two ranks, one card
@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_two_ranks_on_one_card_step_bit_equal(tmp_path, mesh):
    """Two ranks (gloo, named explicitly: NCCL refuses one card twice) on
    the card at the tiny width, two steps with mining and EM from a full
    seeded bank, through tests/_torch_parallel_worker.py: every kernel of
    the path launches on each rank (the tiny trunk has no epilogue), and the
    ranks' parameters, BatchNorm statistics, losses and gathered means are
    bit-equal. Then the same two steps on the async bank pipeline (the
    bank phase's collectives from the bank stream; flushed after the
    last), the ranks bit-equal again, and its state saved sharded by the
    ranks and restored whole by this process on the card, bit-equal to
    the ranks' gathered state."""
    import dataclasses
    import json
    import os
    import socket
    import subprocess
    import sys
    import time

    import numpy as np

    from mgproto_tpu_torch.config import tiny_test_config
    from mgproto_tpu_torch.core.state import create_train_state
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils.checkpoint import (
        is_committed,
        restore_checkpoint,
        save_checkpoint,
    )

    _need_cuda()
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout
    if "Exclusive" in mode:
        pytest.skip(f"the card's compute mode ({mode.strip()}) refuses a second process")
    cfg = tiny_test_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, train_batch_size=4))
    state = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    m = cfg.model
    bank = torch.nn.functional.normalize(
        torch.randn(m.num_classes, m.mem_capacity, m.proto_dim,
                    generator=torch.Generator().manual_seed(1)), dim=-1)
    state.memory = state.memory._replace(
        feats=bank, length=torch.full((m.num_classes,), m.mem_capacity, dtype=torch.int32),
        updated=torch.ones(m.num_classes, dtype=torch.bool))
    ckpt = save_checkpoint(str(tmp_path), state, "0start0.0000")
    rng = np.random.RandomState(0)
    batches = {f"x{i}": rng.rand(8, 32, 32, 3).astype(np.float32) for i in range(2)}
    batches.update({f"y{i}": rng.randint(0, 4, size=8).astype(np.int64) for i in range(2)})
    np.savez(str(tmp_path / "b.npz"), **batches)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "out")
    spec = {"init": f"tcp://127.0.0.1:{port}", "world": 2, "mesh": list(mesh),
            "device": "cuda:0", "backend": "gloo", "batches": str(tmp_path / "b.npz"),
            "scenarios": [{"ckpt": ckpt, "steps": 2, "out": out},
                          {"ckpt": ckpt, "steps": 2, "out": out + "_async", "async_bank": True,
                           "save": str(tmp_path / "saved")}]}
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "_torch_parallel_worker.py"),
                               str(tmp_path / "spec.json"), str(r)], cwd=here,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    deadline = time.monotonic() + 120
    try:
        errs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    for run in (out, out + "_async"):
        r0, r1 = (dict(np.load(os.path.join(run, f"rank{r}.npz"))) for r in range(2))
        for k in ("params", "running_mean", "loss", "means", "priors", "length", "feats"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        for r in (r0, r1):
            # async: the fill step holds its E-steps, the flush runs the last
            score, bwd, _, estep = r["launches"]
            assert score == 2 and bwd == 2 and estep == 2 * 3, r["launches"]
        assert np.isfinite(r0["loss"]).all()
    saved = str(tmp_path / "saved" / "1nopush0.5000")
    assert is_committed(saved)
    st = restore_checkpoint(saved, Trainer(cfg, 1, device="cuda").init_state(0, for_restore=True))
    assert st.gmm.means.is_cuda
    np.testing.assert_array_equal(st.gmm.means.detach().cpu().numpy(), r0["means"])
    np.testing.assert_array_equal(st.memory.feats.cpu().numpy(), r0["feats"])
    np.testing.assert_array_equal(st.memory.cursor.cpu().numpy(), r0["cursor"])
    np.testing.assert_array_equal(
        torch.cat([p.detach().reshape(-1) for p in Trainer.params(st)]).cpu().numpy(),
        r0["params"])



@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_a_quantized_conv_on_the_card_equals_a_conv_on_its_dequantized_weights(dtype):
    """models/quantized.py's conv, its weight dequantized at the call, gives
    the bits of the same conv on the dequantized weight (channels_last, the
    served layout), in f32 and in bf16."""
    _need_cuda()
    from mgproto_tpu_torch.models.common import conv
    from mgproto_tpu_torch.models.quantized import (
        QuantConv2d,
        dequantize_weight,
        quantize_modules,
    )
    from mgproto_tpu_torch.perf.quant import quantize_array

    g = torch.Generator().manual_seed(5)
    layer = torch.nn.Sequential(conv(64, 128, 3, 2, 1))
    with torch.no_grad():
        layer[0].weight.copy_(torch.randn(layer[0].weight.shape, generator=g) * 0.05)
    q, scale = quantize_array(layer[0].weight)
    quantize_modules(layer, {"0": (q, scale)})
    qconv = layer[0].cuda().to(memory_format=torch.channels_last).eval()
    assert isinstance(qconv, QuantConv2d)
    w = dequantize_weight(qconv.qweight, qconv.scale).contiguous(
        memory_format=torch.channels_last)
    x = torch.randn(8, 64, 56, 56, generator=g).cuda().to(dtype).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        got = qconv(x)
        want = torch.nn.functional.conv2d(x, w.to(dtype), None, 2, 1)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_a_tiny_int8_engine_on_the_card_matches_the_cpu(tmp_path):
    """A resnet18-width int8 artifact served on the card and on the CPU: one
    score_pool and 8 epilogue launches a dispatch on the card, logits and
    log p(x) within 1e-4 of the CPU's plain path; the weights at rest on the
    card are the int8 ones (storage bytes = quant_config's
    total_weight_bytes), and the dequantize-on-load twin gives the same
    logits on the card within 1e-5."""
    _need_cuda()
    import dataclasses

    import numpy as np

    from mgproto_tpu_torch.config import tiny_test_config
    from mgproto_tpu_torch.core.mgproto import build_mgproto
    from mgproto_tpu_torch.engine import export
    from mgproto_tpu_torch.perf.quant import QUANT_TAG_INT8, quantize_model, resident_weight_bytes
    from mgproto_tpu_torch.serving.calibration import gmm_fingerprint
    from mgproto_tpu_torch.serving.engine import ServingEngine

    cfg = tiny_test_config(arch="resnet18")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, fused_scoring=None,
                                                fused_epilogue=None))
    model, gmm = build_mgproto(cfg.model, device="cpu", seed=3)
    qm = quantize_model(model)
    path = str(tmp_path / "r18q.mgproto")
    export.save_artifact(path, qm.model, gmm, export.artifact_meta(
        cfg, None, gmm_fingerprint(gmm), quant=qm.quant_config()))
    x = np.random.default_rng(4).normal(size=(6, 32, 32, 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine.from_artifact(path, allow_uncalibrated=True, device=dev,
                                          buckets=(8,))
        assert eng.quant_config == QUANT_TAG_INT8
        eng.warmup()
        score_pool.launches = fe.fused_bn_epilogue.launches = 0
        logits, log_px, _ = eng._dispatch(x)
        out[dev] = (logits, log_px, (score_pool.launches, fe.fused_bn_epilogue.launches))
    assert out["cuda"][2] == (1, 8) and out["cpu"][2] == (0, 0)
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() <= ATOL
    assert np.abs(out["cuda"][1] - out["cpu"][1]).max() <= ATOL
    art = export.load_artifact(path, device="cuda")
    model = art.evaluator.model
    assert resident_weight_bytes(model) == qm.quant_config()["total_weight_bytes"]
    twin = export.load_artifact(path, device="cuda", dequantize=True)
    a, b = art.infer(x), twin.infer(x)
    assert np.abs(a["logits"] - b["logits"]).max() <= 1e-5
    assert np.abs(a["log_px"] - b["log_px"]).max() <= 1e-5


def _planner_cfg():
    import dataclasses

    from mgproto_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config(arch="resnet18")
    return cfg.replace(model=dataclasses.replace(cfg.model, fused_scoring=None,
                                                 fused_epilogue=None))


def _launches():
    return (score_pool.launches, fe.fused_bn_epilogue.launches, score_pool_bwd.launches,
            em_estep_stats.launches)


@pytest.mark.cuda
def test_the_planner_measure_on_the_card_repeats_within_its_spread():
    """perf/planner.py `measure_candidate` at a resnet18-width tiny config:
    one step a candidate through the four kernels (1 / 8 / 1 / 3 launches),
    a positive peak, the same candidate measured twice within 5 % (the
    cache emptied and the peak reset between them), the async candidate
    two steps, and nothing left allocated but the shared state."""
    _need_cuda()
    from mgproto_tpu_torch.perf import planner

    cfg = _planner_cfg()
    shared = {}
    cand = planner.PlanCandidate(batch=8, prefetch_depth=0)
    peaks = []
    for _ in range(2):
        before = _launches()
        peak, detail = planner.measure_candidate(cfg, cand, device="cuda", shared=shared)
        assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 8, 1, 3)
        assert peak == detail["program_peak_bytes"] > 0 and detail["steps"] == 1
        peaks.append(peak)
        assert torch.cuda.memory_allocated() == detail["baseline_bytes"]
    assert abs(peaks[0] - peaks[1]) <= 0.05 * max(peaks), peaks
    apeak, adetail = planner.measure_candidate(
        cfg, planner.PlanCandidate(batch=8, prefetch_depth=0, async_bank=True), device="cuda",
        shared=shared)
    assert adetail["steps"] == 2 and apeak > 0
    assert adetail["bank_bytes_per_chip"] == planner.state_bytes_per_chip(cfg)[
        "bank_bytes_per_chip"]


@pytest.mark.cuda
def test_a_budget_under_the_measured_peak_rejects_and_an_oom_is_a_rejection():
    """The planner on the card: a budget above the measured peak fits, one
    below it rejects (no step runs out of memory); an out-of-memory error
    (the process allocator capped) is a rejection carrying its message,
    and the allocator is emptied after it."""
    _need_cuda()
    from mgproto_tpu_torch.perf import planner

    cfg = _planner_cfg()
    measure = planner.make_cached_measure(cfg, device="cuda")
    cand = planner.PlanCandidate(batch=8, prefetch_depth=0)
    peak, _ = measure(cand)
    fits = planner.HBMPlanner(budget_bytes=2 * peak, margin=0.0, measure=measure).plan(
        cfg, [cand])
    tight = planner.HBMPlanner(budget_bytes=peak // 2, margin=0.0, measure=measure).plan(
        cfg, [cand])
    assert fits.chosen is not None and tight.chosen is None and tight.rejected == 1
    total = torch.cuda.mem_get_info()[1]
    torch.cuda.set_per_process_memory_fraction(
        (torch.cuda.memory_allocated() + 64 * 1024 ** 2) / total)
    try:
        out = planner.HBMPlanner(budget_bytes=total, margin=0.0, device="cuda").plan(
            cfg, [planner.PlanCandidate(batch=512, prefetch_depth=0)])
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert out.chosen is None and "OutOfMemoryError" in out.reports[0].error
    assert torch.cuda.memory_reserved() - torch.cuda.memory_allocated() < 64 * 1024 ** 2


@pytest.mark.cuda
def test_a_serve_bucket_program_peak_excludes_the_loaded_model():
    """`serve_bucket_measure` on an engine over a model on the card: the
    loaded model is in the baseline, not in the program peak; a larger
    bucket peaks higher; with the weight term the ladder is
    `plan_serve_buckets`'."""
    _need_cuda()
    from mgproto_tpu_torch.core.mgproto import build_mgproto
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.perf import planner
    from mgproto_tpu_torch.perf.quant import resident_weight_bytes
    from mgproto_tpu_torch.serving.engine import ServingEngine

    cfg = _planner_cfg()
    model, gmm = build_mgproto(cfg.model, device="cpu", seed=0)
    ev = Evaluator(model, gmm, cfg, device="cuda")
    eng = ServingEngine.from_live(ev, buckets=(1, 8))
    measure = planner.serve_bucket_measure(eng)
    p1, d1 = measure(planner.PlanCandidate(batch=1, prefetch_depth=0))
    p8, d8 = measure(planner.PlanCandidate(batch=8, prefetch_depth=0))
    weights = resident_weight_bytes(ev.model)
    assert d1["baseline_bytes"] >= weights and d8["baseline_bytes"] >= weights
    assert 0 < p1 < p8
    fitting, out = planner.plan_serve_buckets(eng, budget_bytes=weights + (p1 + p8) // 2,
                                              margin=0.0, weight_bytes=weights)
    assert fitting == [1] and out.reports[1].detail["weight_resident_bytes"] == weights
