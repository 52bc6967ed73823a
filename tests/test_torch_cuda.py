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
