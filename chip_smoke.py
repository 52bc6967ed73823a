#!/usr/bin/env python3
"""Drive the PyTorch port (mgproto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs a CUDA GPU and nvcc

Phases, one JSON line each:
  1. env:    torch/CUDA versions and the card (name, power limit);
  2. build:  the four CUDA kernels compiled from mgproto_tpu_torch/csrc/,
             one nvcc per source, in parallel;
  3. kernel: each kernel held against its plain PyTorch version on the card
             at the shapes the flagship's serve path (B = 8) and train step
             (B = 80) give it: score_pool at B = 8, HW = 196 and 784, at
             B = 80 and 1, HW = 196, at a ragged P = 2037 and on exact ties;
             the BN epilogue at the four ResNet-34 stage shapes, at B = 8 in
             f32 and bf16 and at B = 80 in f32 on the batch's own
             statistics; the score_pool backward at B = 80, P = 2000, T = 20
             on the train step's mined gradient (HW = 196), on a dense one
             (HW = 196 and 784) and on a hub input (equal feature rows,
             mined g), bitwise across two launches; the EM E-step over
             A = 200 classes of N = 800 rows, K = 10, d = 64 and over a
             compact slab of 80 of them (bitwise across two launches, and
             equal to the same classes in the A = 200 call), and on that
             slab with sigmas in 0.3-0.5. Each is timed
             beside its bound, the plain version and (score_pool) the
             unfused torch.matmul + torch.topk, as device time (CUDA events
             around calls queued behind a spin kernel); inputs larger than a
             MB rotate through copies larger than the L2, so they come from
             HBM as on the main paths;
  4. serve:  the flagship ResNet-34 MGProto (C=200, K=10, d=64, T=20, 224 px,
             seeded random weights) calibrated on 16 ID images and served
             through ServingEngine; every id answered once, bad payloads
             rejected typed, the kernel launch counts per dispatch checked
             (score_pool 1, epilogue 16), and served scores held against the
             same weights run through the plain path on the CPU; the same
             comparison with TF32 switched on must exceed the tolerance;
  5. train:  the flagship Trainer at batch 80 from a full seeded bank: six
             steps with mining and EM, then a warm step, with the launches,
             the EM fallback and the pinning of untouched classes checked
             per step; the first step is repeated from the same state on
             three other routes (every kernel off; the epilogue off on both
             sides, so only the scoring kernels and the E-step differ; and
             the plain route on images scaled by 1 + 1e-7, the floor), and
             activations and their gradients are compared along the trunk,
             and the scoring route reports the score_pool kernel's index
             agreement with the plain pool on its own first-step features;
             then a profile of three steps by kernel family;
  6. input:  the training input path: a seeded folder of 800 JPEGs (200
             classes x 4, 500x375, quality 90) under build/input_phase/,
             read by build_pipelines' train loader (ImageFolder, the
             geometry-only TrainTransform, 8 spawn workers, the shared-memory
             ring) on the uint8 wire with per-sample seeds; the host native
             library built and held to its numpy plain version; two passes
             over epoch 0's first two batches, and the thread backend, give
             the same bytes (sha256); the augmentation tail on the card held
             to the same function on the CPU and timed; the first step on
             the uint8 route held to the same batch augmented on the CPU and
             shipped as f32; one batch on each wire copied alone, timed by
             put_batch's CUDA events on its copy stream; then the flagship
             trained for one epoch (10 steps at batch 80, mining and EM on)
             through Trainer.train_epoch with the launches counted and each
             step's copy timed the same way (beside PCIe Gen5 x16's peak),
             and a profile of the next epoch.
Then the kernel summary line (times at the train step's shapes, the serve
path's beside them; `launches` counted on the input phase's epoch), the card
line as nvidia-smi prints it, and last `{"ok": true, "device": {...}}`. Any
failed check exits non-zero before that line is printed.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

F32_TFLOPS = 67e12  # H100 SXM data sheet: non-tensor float32
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet: HBM3
# H100 SXM data sheet: PCIe Gen5 x16, 128 GB/s both ways; one direction's
# 64 GB/s less the 128b/130b line code
PCIE_BYTES_S = 64e9 * 128 / 130
# a timing loop cycles through copies of its inputs that together hold 4x the
# H100's 50 MB L2, so each launch reads them from HBM as the served path does
ROTATE_BYTES = 4 * 50e6
# device_ms's first spin ahead of the timed calls: ~8.5 ms at 1.98 GHz
SPIN_CYCLES = 1 << 24
# ResNet-34 without the stem pool at 224 px: (blocks, H=W, C) per stage
R34_STAGES = ((3, 112, 64), (4, 56, 128), (6, 28, 256), (3, 14, 512))
# served log p(x) / logits vs the CPU plain path. cuDNN and oneDNN sum the 36
# f32 convolutions in different orders: measured 9.1e-6 (logits) and 6.7e-6
# (log p(x)) on an H100. The limit sits 10x above that and below what TF32
# convolutions give (the serve phase measures that too and requires it to
# fail this limit), so the precision the numerics policy forbids is caught.
SERVE_ATOL = 1e-4
SCORE_ATOL = 1e-4  # score_pool vs plain: FMA chain vs cuBLAS order, |v| <= ~15
# score_pool backward and E-step statistics vs plain: summation order only,
# so 1e-5 of the plain output's largest magnitude; the E-step's mean
# log-likelihood (|ll| ~ 50) within 1e-4
BWD_RTOL = 1e-5
ESTEP_RTOL = 1e-5
ESTEP_LL_ATOL = 1e-4
TRAIN_BATCH = 80
TRAIN_STEPS = 6  # then one warm step
# Routes of the first train step from one state, on the card, against the
# plain route (every kernel off). All share the cuDNN convolutions.
#  * Loss relative 1e-5; EM log-likelihood atol 1e-3 (|ll| ~ 50); priors
#    atol 1e-5, on every route.
#  * Scoring route (score_pool forward and backward and the E-step on, the
#    epilogue off on both sides): the trunk gradient within 1e-4 relative
#    norm. The two differ only in the head's summation order (1.5e-5
#    measured on an H100), so a wrong term in either kernel, even on the
#    ~5.5 % of the pooled values the mining mask leaves live, shows.
#  * Kernel route (every kernel on): the epilogue computes x*a + b with
#    folded constants against (x - mean)*a + bias, a one-ulp difference in
#    most activations. The trunk gradient moves under such a difference by
#    a floor measured here, `grad_rel_floor`: the plain route against itself
#    on the images scaled by 1 + 1e-7. The kernel route must stay within
#    TRAIN_GRAD_FLOOR_MULT times that floor; a wrong term in a backward
#    gives O(1).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_SCORING_GRAD_RTOL = 1e-4
TRAIN_GRAD_FLOOR_MULT = 2.0
TRAIN_LL_ATOL = 1e-3
TRAIN_PRIOR_ATOL = 1e-5
# the input phase: the augmentation tail on the card against the same
# function on the CPU (f32 elementwise ops in one order; the card's and the
# CPU's division and rounding of the mean luma may differ in the last ulp);
# the first step on the uint8 route against the same batch augmented on the
# CPU and shipped as f32: the train phase's loss tolerance
TAIL_ATOL = 1e-5
INPUT_CLASSES, INPUT_PER_CLASS, INPUT_HW = 200, 4, (375, 500)
INPUT_WORKERS = 8
# where activations and their gradients are compared between routes
PROBES = ("features.bn1", "features.layer1", "features.layer2", "features.layer3",
          "features.layer4", "add_on")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def event_ms(fn, iters=50, warmup=3):
    """Mean time per call of `fn` over `iters` back-to-back calls between two
    CUDA events. Where a call's host work (Python, ctypes, launch) outlasts
    its kernels, this is the host's issue interval, not device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Mean device time per call of `fn` over `iters` warmed calls. The calls
    are queued behind a spin kernel (torch.cuda._sleep) that outlasts the
    host's issue of all of them, so the two CUDA events around them time the
    device's work back to back, without the host's launch gaps. The spin
    grows until the first event is still pending when the host has issued
    the last call; a `fn` that synchronizes never gets there and fails."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 8
    raise SmokeFailure("device_ms: the host did not queue the calls before the spin ended")


def rel_error(got, want):
    """max |got - want| / |want| over entries with |want| > 1e-6 (ReLU zeros
    and exact zeros carry no relative error)."""
    got, want = got.float(), want.float()
    keep = want.abs() > 1e-6
    return ((got - want).abs()[keep] / want.abs()[keep]).max().item() if keep.any() else 0.0


def bound_ms(flops, nbytes):
    """The larger of f32 operations over the non-tensor f32 peak and bytes
    over the HBM rate, in ms, and which of the two it is."""
    t_ops, t_bytes = flops / F32_TFLOPS, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# ------------------------------------------------------------------ kernels
def score_pool_case(name, feat, means, sigmas, t_levels):
    """Kernel vs plain on one input; returns the case's record."""
    import torch

    from mgproto_tpu_torch.ops.fused_scoring import launch_score_pool, score_pool, score_pool_plain
    from mgproto_tpu_torch.ops.gaussian import precompute_diag_gaussian

    b, hw, d = feat.shape
    msc, ivar, const = (t.contiguous() for t in precompute_diag_gaussian(means, sigmas, 1e-10))
    p = msc.shape[0]
    vals, idx = score_pool(feat, means, sigmas, t_levels)
    pvals, pidx = score_pool_plain(feat, means, sigmas, t_levels)
    torch.cuda.synchronize()
    dens = const[None, :, None] + msc @ feat.transpose(1, 2) - 0.5 * ivar @ (feat * feat).transpose(1, 2)
    err = (vals - pvals).abs().max().item()
    rel_err = rel_error(vals, pvals)
    picked_err = (torch.gather(dens, 2, idx) - vals).abs().max().item()
    agree = (idx == pidx).float().mean().item()
    s_idx, _ = idx.sort(-1)
    distinct = bool((s_idx[..., 1:] != s_idx[..., :-1]).all())
    check(vals.shape == (b, p, t_levels) and torch.isfinite(vals).all(), f"{name}: bad values")
    check(err <= SCORE_ATOL, f"{name}: max |vals - plain| {err} > {SCORE_ATOL}")
    check(picked_err <= SCORE_ATOL, f"{name}: a picked index's density is off by {picked_err}")
    check(distinct, f"{name}: an index repeats within a top-T list")

    ring, copies = ring_of((feat,), 4.0 * feat.numel())

    def kernel():
        return launch_score_pool(next(ring)[0], msc, ivar, const, t_levels)

    def library():
        f = next(ring)[0]
        dd = const[None, :, None] + torch.matmul(msc, f.transpose(1, 2)) \
            - 0.5 * torch.matmul(ivar, (f * f).transpose(1, 2))
        return torch.topk(dd, t_levels, dim=-1)

    flops = 4.0 * b * hw * p * d
    nbytes = 4.0 * (b * hw * d + 2 * p * d + p) + 8.0 * b * p * t_levels
    bms, by = bound_ms(flops, nbytes)
    rec = {
        "case": name, "B": b, "HW": hw, "P": p, "d": d, "T": t_levels,
        "max_abs_err": err, "max_rel_err": rel_err, "picked_density_err": picked_err,
        "index_agreement": agree, "input_copies": copies,
        "ms": device_ms(kernel), "event_ms": event_ms(kernel),
        "wrapper_ms": device_ms(lambda: score_pool(next(ring)[0], means, sigmas, t_levels)),
        "plain_ms": device_ms(lambda: score_pool_plain(next(ring)[0], means, sigmas, t_levels)),
        "library_ms": device_ms(library),
        "bound_ms": bms, "bound_by": by,
    }
    return rec, (vals, idx, pvals, pidx)


def kernel_phase():
    import torch

    g = torch.Generator().manual_seed(0)
    c, k, d, t = 200, 10, 64, 20
    means = torch.nn.functional.normalize(torch.rand(c, k, d, generator=g), dim=-1).cuda()
    sigmas = torch.full((c, k, d), 1.0 / (2 * torch.pi) ** 0.5).cuda()
    cases = []
    for b, hw, path in ((8, 196, "serve"), (8, 784, "serve"), (TRAIN_BATCH, 196, "train"),
                        (1, 196, "serve")):
        feat = torch.nn.functional.normalize(torch.randn(b, hw, d, generator=g), dim=-1).cuda()
        rec, _ = score_pool_case(f"{path}_b{b}_hw{hw}", feat, means, sigmas, t)
        cases.append(rec)
        emit("kernel", kernel="score_pool", path=path, **rec)
    # a ragged prototype count: the last 128-prototype tile holds 117 (2037 = 15 * 128 + 117)
    rmeans = torch.nn.functional.normalize(torch.rand(2037, 1, d, generator=g), dim=-1).cuda()
    rsig = torch.full((2037, 1, d), 1.0 / (2 * torch.pi) ** 0.5).cuda()
    feat = torch.nn.functional.normalize(torch.randn(8, 196, d, generator=g), dim=-1).cuda()
    rec, _ = score_pool_case("ragged_p2037_b8_hw196", feat, rmeans, rsig, t)
    cases.append(rec)
    emit("kernel", kernel="score_pool", path="serve", **rec)
    # exact ties: dyadic values repeated at 4 positions each (row n = base[n % 49])
    base = torch.randint(-4, 5, (8, 49, d), generator=g).float() / 16
    tfeat = base.repeat(1, 4, 1).cuda()
    tmeans = (torch.randint(-4, 5, (c, k, d), generator=g).float() / 16).cuda()
    tsig = torch.full((c, k, d), 0.5).cuda()
    rec, (vals, idx, pvals, pidx) = score_pool_case("ties_hw196", tfeat, tmeans, tsig, t)
    check(torch.equal(idx, pidx), "ties: kernel indices differ from the stable plain order")
    check(torch.equal(vals, pvals), "ties: kernel values differ on exact inputs")
    check(bool((idx[..., 0] < 49).all()), "ties: top-1 is not the first occurrence")
    cases.append(rec)
    emit("kernel", kernel="score_pool", path="serve", **rec)
    serve_sp, train_sp = cases[0], cases[2]

    # the 16 launches of a forward: serve (B = 8, running statistics, f32 and
    # bf16) and train step (B = 80, the batch's statistics, f32)
    epi = {path: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
           for path in ("serve", "train")}
    gc = torch.Generator(device="cuda").manual_seed(0)
    for path, b, dtype in (("serve", 8, torch.float32), ("serve", 8, torch.bfloat16),
                           ("train", TRAIN_BATCH, torch.float32)):
        for blocks, hw, ch in R34_STAGES:
            rec = epilogue_case(path, b, hw, ch, dtype, gc)
            rec["launches_per_forward"] = blocks
            emit("kernel", kernel="bn_epilogue", path=path, **rec)
            if dtype == torch.float32:
                e = epi[path]
                e["max_abs_err"] = max(e["max_abs_err"], rec["max_abs_err"])
                for key in ("ms", "plain_ms", "bound_ms"):
                    e[key] += blocks * rec[key]
    bwd = [score_pool_bwd_case(hw, mined, means, sigmas, g, hub)
           for hw, mined, hub in ((196, True, False), (196, False, False), (784, False, False),
                                  (196, True, True))]
    est = em_estep_cases(g)

    def serve(rec, library=True):
        keys = ("ms", "plain_ms", "bound_ms") + (("library_ms",) if library else ())
        return {key: rec[key] for key in keys}

    # ms, plain_ms and bound_ms at the train step's shapes (where the
    # launches are counted); the serve path's (B = 8) under "serve"
    return [
        {
            "name": "score_pool", "route": "cuda",
            "source": "mgproto_tpu_torch/csrc/score_pool.cu",
            "replaces": "mgproto_tpu/ops/fused_scoring.py:50",
            "launches": None, "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": train_sp["ms"], "plain_ms": train_sp["plain_ms"],
            "bound_ms": train_sp["bound_ms"], "bound_by": train_sp["bound_by"],
            "library_ms": train_sp["library_ms"], "at": "B=80, HW=196, P=2000, T=20",
            "serve": dict(serve(serve_sp), at="B=8, HW=196"),
        },
        {
            "name": "bn_epilogue", "route": "cuda",
            "source": "mgproto_tpu_torch/csrc/bn_epilogue.cu",
            "replaces": "mgproto_tpu/ops/fused_epilogue.py:69",
            "launches": None,
            "max_abs_err": max(e["max_abs_err"] for e in epi.values()),
            "ms": epi["train"]["ms"], "plain_ms": epi["train"]["plain_ms"],
            "bound_ms": epi["train"]["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "at": "the 16 launches of a forward, B=80, f32, batch statistics",
            "serve": dict(serve(epi["serve"], False), at="16 launches, B=8, f32"),
        },
        {
            "name": "score_pool_bwd", "route": "cuda",
            "source": "mgproto_tpu_torch/csrc/score_pool_bwd.cu",
            "replaces": "mgproto_tpu/ops/fused_scoring.py:91",
            "launches": None, "max_abs_err": max(r["max_abs_err"] for r in bwd),
            "ms": bwd[0]["ms"], "plain_ms": bwd[0]["plain_ms"],
            "bound_ms": bwd[0]["bound_ms"], "bound_by": bwd[0]["bound_by"],
            "library_ms": None, "at": "B=80, HW=196, mined gradient",
        },
        {
            "name": "em_estep", "route": "cuda",
            "source": "mgproto_tpu_torch/csrc/em_estep.cu",
            "replaces": "mgproto_tpu/ops/em_kernels.py:59",
            "launches": None, "max_abs_err": max(r["max_abs_err"] for r in est),
            "ms": est[0]["ms"], "plain_ms": est[0]["plain_ms"],
            "bound_ms": est[0]["bound_ms"], "bound_by": est[0]["bound_by"],
            "library_ms": None, "at": "A=80 (the compact width), N=800, K=10",
            "dense": dict(serve(est[1], False), at="A=200 (the dense fallback)"),
        },
    ]


def epilogue_case(path, b, hw, ch, dtype, gen):
    """The epilogue at one ResNet-34 stage shape: kernel vs plain, timed on
    rotating inputs. The serve path normalizes with running statistics (any
    positive variance); the train step with the batch's own, computed as
    models/common.py's BatchNorm computes them."""
    import torch

    from mgproto_tpu_torch.models.common import BatchNorm
    from mgproto_tpu_torch.ops.fused_epilogue import epilogue_reference, fold_constants, launch_bn_epilogue

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = draw(b, hw, hw, ch).to(dtype).permute(0, 3, 1, 2)
    r = draw(b, hw, hw, ch).to(dtype).permute(0, 3, 1, 2)
    if path == "train":
        mean, var = BatchNorm(ch).cuda().batch_statistics(x)
    else:
        mean = 0.1 * draw(ch)
        var = 0.5 + torch.rand(ch, generator=gen, device="cuda")
    scale = 0.5 + torch.rand(ch, generator=gen, device="cuda")
    bias = 0.1 * draw(ch)
    a, bb = fold_constants(mean, var, scale, bias, 1e-5)
    ring, copies = ring_of((x, r), 2 * x.numel() * x.element_size())

    def kernel():
        xi, ri = next(ring)
        return launch_bn_epilogue(xi, ri, a, bb)

    def plain():
        xi, ri = next(ring)
        return epilogue_reference(xi, mean, var, scale, bias, ri, 1e-5, torch.float32).to(dtype)

    # the kernel does f32 math and rounds once, so its plain version here is
    # epilogue_reference in f32, rounded to the activation dtype: equal up to
    # FMA contraction and the folding, i.e. 1e-5 absolute in f32 and one bf16
    # ulp (2^-7 relative) in bf16
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    out = launch_bn_epilogue(x, r, a, bb)
    ref = epilogue_reference(x, mean, var, scale, bias, r, 1e-5, torch.float32).to(dtype)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    what = f"epilogue {path} {dtype} B={b} {hw}x{hw}x{ch}"
    check(out.is_contiguous(memory_format=torch.channels_last), f"{what}: lost channels_last")
    check(bool((diff <= 1e-5 + rtol * ref.float().abs()).all()),
          f"{what}: max err {err} beyond 1e-5 + {rtol}|ref|")
    nbytes = 3.0 * x.numel() * x.element_size() + 2 * 4 * ch
    bms, by = bound_ms(2.0 * x.numel(), nbytes)
    return {
        "dtype": str(dtype).split(".")[-1], "B": b, "H": hw, "C": ch,
        "max_abs_err": err, "max_rel_err": rel_error(out, ref), "input_copies": copies,
        "ms": device_ms(kernel), "event_ms": event_ms(kernel), "plain_ms": device_ms(plain),
        "bound_ms": bms, "bound_by": by,
    }


def ring_of(tensors, nbytes):
    """An endless cycle over copies of `tensors` (`nbytes` a copy; memory
    format kept) holding ROTATE_BYTES in all, at least two, so each call
    reads its inputs from HBM. Inputs under a MB are not copied: they stay
    in the L2 on the main paths too. Returns (cycle, number of copies)."""
    if nbytes < 2 ** 20:
        return itertools.repeat(tuple(tensors)), 1
    copies = max(2, -(-int(ROTATE_BYTES) // int(nbytes)))
    return itertools.cycle([tuple(t.clone() for t in tensors) for _ in range(copies)]), copies


def score_pool_bwd_case(hw, mined, means, sigmas, g, hub=False):
    """The feature gradient at the flagship train shapes: kernel vs plain,
    bitwise across two launches, timed on rotating inputs. `mined` gives g
    the train step's pattern: the mining mask (ops/pooling.py) leaves a
    sample's own class all T levels and every other prototype its top-1
    only, so the rest of g is exactly zero; otherwise g is dense. `hub`
    makes a sample's feature rows equal, so every prototype's top-T is the
    same T patches (ties to the lowest index): each of them gathers P
    entries, the other patches none."""
    import torch

    from mgproto_tpu_torch.ops.fused_scoring import (
        launch_score_pool, launch_score_pool_bwd, score_pool_bwd_plain,
    )
    from mgproto_tpu_torch.ops.gaussian import precompute_diag_gaussian

    b, t, d = TRAIN_BATCH, 20, 64
    c, k = means.shape[:2]
    msc, ivar, const = (x.contiguous() for x in precompute_diag_gaussian(means, sigmas, 1e-10))
    p = msc.shape[0]
    feat = torch.nn.functional.normalize(torch.randn(b, hw, d, generator=g), dim=-1).cuda()
    if hub:
        feat = feat[:, :1].expand(b, hw, d).contiguous()
    _, idx = launch_score_pool(feat, msc, ivar, const, t)
    if hub:
        check(bool((idx < t).all()), "score_pool_bwd hub: the top-T lists did not concentrate")
    cot = torch.randn(b, p, t, generator=g)
    if mined:
        labels = torch.randint(0, c, (b,), generator=g)
        own = (torch.arange(p)[None, :] // k) == labels[:, None]  # [B, P]
        live = own[:, :, None] | (torch.arange(t) == 0)[None, None, :]
        cot = cot * live
    cot = cot.cuda()
    out = launch_score_pool_bwd(cot, idx, feat, msc, ivar)
    again = launch_score_pool_bwd(cot, idx, feat, msc, ivar)
    ref = score_pool_bwd_plain(cot, idx, feat, msc, ivar)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    what = f"score_pool_bwd hw{hw} {'mined' if mined else 'dense'}{' hub' if hub else ''}"
    check(torch.isfinite(out).all() and out.shape == (b, hw, d), f"{what}: bad output")
    check(err <= BWD_RTOL * scale, f"{what}: max err {err} > {BWD_RTOL} x {scale}")
    check(torch.equal(out, again), f"{what}: two launches differ")
    nbytes = 4.0 * (2 * b * p * t + 2 * b * hw * d + 2 * p * d)
    ring, copies = ring_of((cot, idx, feat), 4.0 * (2 * b * p * t + b * hw * d))

    def kernel():
        c_, i_, f_ = next(ring)
        return launch_score_pool_bwd(c_, i_, f_, msc, ivar)

    def plain():
        c_, i_, f_ = next(ring)
        return score_pool_bwd_plain(c_, i_, f_, msc, ivar)

    live = int((cot != 0).sum())  # entries the kernel works on (zero g is skipped)
    bms, by = bound_ms(4.0 * live * d, nbytes)
    rec = {"g": "mined" if mined else "dense", "hub": hub, "B": b, "HW": hw, "P": p, "T": t, "d": d,
           "live_entries": live, "live_share": live / (b * p * t),
           "max_abs_err": err, "max_abs_plain": scale,
           "bitwise_repeat": True, "input_copies": copies,
           "ms": device_ms(kernel), "event_ms": event_ms(kernel), "plain_ms": device_ms(plain),
           "bound_ms": bms, "bound_by": by}
    emit("kernel", kernel="score_pool_bwd", **rec)
    return rec


def em_estep_case(name, x, means, sigmas, priors, timed=True):
    """The E-step over one slab of classes: kernel vs plain, bitwise across
    two launches, timed on rotating bank slabs. Returns the record and the
    kernel's outputs."""
    import torch

    from mgproto_tpu_torch.ops.em_kernels import _prepare, em_estep_stats_plain, launch_em_estep

    a, n, d = x.shape
    k = means.shape[1]
    msc, ivar, const = (t.contiguous() for t in _prepare(means, sigmas, priors, 1e-10))
    got = launch_em_estep(x, msc, ivar, const)
    again = launch_em_estep(x, msc, ivar, const)
    want = em_estep_stats_plain(x, means, sigmas, priors)
    torch.cuda.synchronize()
    ll_err = (got[0] - want[0]).abs().max().item()
    errs = [(o - r).abs().max().item() for o, r in zip(got[1:], want[1:])]
    scales = [r.abs().max().item() for r in want[1:]]
    what = f"em_estep {name}"
    check(all(torch.isfinite(o).all() for o in got), f"{what}: non-finite output")
    check(ll_err <= ESTEP_LL_ATOL, f"{what}: ll err {ll_err} > {ESTEP_LL_ATOL}")
    for stat, e, sc in zip(("s", "sx", "sxx"), errs, scales):
        check(e <= ESTEP_RTOL * sc, f"{what}: {stat} err {e} > {ESTEP_RTOL} x {sc}")
    check(all(torch.equal(p, q) for p, q in zip(got, again)), f"{what}: two launches differ")
    rec = {"case": name, "A": a, "N": n, "K": k, "d": d, "max_abs_err": max(errs),
           "ll_err": ll_err, "errs_s_sx_sxx": errs, "max_abs_plain_s_sx_sxx": scales,
           "bitwise_repeat": True}
    if timed:
        ring, copies = ring_of((x,), 4.0 * a * n * d)

        def kernel():
            return launch_em_estep(next(ring)[0], msc, ivar, const)

        def plain():
            return em_estep_stats_plain(next(ring)[0], means, sigmas, priors)

        # the work itself: the partial-statistics scratch is not counted
        flops = 8.0 * a * n * k * d  # two products for w, two for sx / sxx
        nbytes = 4.0 * (a * n * d + 2 * a * k * d + a * k) + 4.0 * (a + a * k + 2 * a * k * d)
        bms, by = bound_ms(flops, nbytes)
        rec.update(input_copies=copies, ms=device_ms(kernel), event_ms=event_ms(kernel),
                   plain_ms=device_ms(plain), bound_ms=bms, bound_by=by)
    emit("kernel", kernel="em_estep", **rec)
    return rec, got


def em_estep_cases(g):
    """The E-step at the train step's two widths: every class of a flagship
    bank (A = 200, the dense call the first EM round falls back to) and a
    compact slab of 80 of them gathered as core/em.py gathers it, which
    must give the same bits as those classes inside the A = 200 call; then
    the slab again with sigmas drawn in 0.3-0.5 (sharp responsibilities)."""
    import torch

    c, n, k, d = 200, 800, 10, 64
    x = torch.nn.functional.normalize(torch.randn(c, n, d, generator=g), dim=-1).cuda()
    means = torch.nn.functional.normalize(torch.rand(c, k, d, generator=g), dim=-1).cuda()
    sigmas = torch.full((c, k, d), 1.0 / (2 * torch.pi) ** 0.5).cuda()
    priors = torch.softmax(torch.randn(c, k, generator=g), -1).cuda()
    idx = torch.randperm(c, generator=g)[:TRAIN_BATCH].sort().values.cuda()
    dense, dense_out = em_estep_case("A=200", x, means, sigmas, priors)
    slab = [t[idx].contiguous() for t in (x, means, sigmas, priors)]
    compact, compact_out = em_estep_case("A=80", *slab)
    check(all(torch.equal(f[idx], s) for f, s in zip(dense_out, compact_out)),
          "em_estep: classes of the A=80 slab differ from the same classes in the A=200 call")
    compact["slab_independent"] = True
    sharp_sig = (0.3 + 0.2 * torch.rand(TRAIN_BATCH, k, d, generator=g)).cuda()
    sharp, _ = em_estep_case("A=80, sigma 0.3-0.5", slab[0], slab[1], sharp_sig, slab[3], timed=False)
    return compact, dense, sharp


# -------------------------------------------------------------------- serve
def serve_phase():
    import numpy as np
    import torch

    from mgproto_tpu_torch.config import Config
    from mgproto_tpu_torch.core.mgproto import build_mgproto
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.numerics import apply_numerics_policy
    from mgproto_tpu_torch.ops.fused_epilogue import fused_bn_epilogue
    from mgproto_tpu_torch.ops.fused_scoring import score_pool
    from mgproto_tpu_torch.serving.calibration import calibrate
    from mgproto_tpu_torch.serving.engine import ServingEngine

    cfg = Config()
    m = cfg.model
    model, gmm = build_mgproto(m, device="cuda", seed=0)
    ev = Evaluator(model, gmm, cfg, device="cuda")
    rng = np.random.default_rng(0)
    img = (m.img_size, m.img_size, 3)
    id_images = rng.normal(size=(16, *img)).astype(np.float32)
    cal = calibrate(ev, [id_images[:8], id_images[8:]], source="chip_smoke seeded ID images")
    engine = ServingEngine.from_live(ev, calibration=cal, buckets=(1, 2, 4, 8))
    warm = engine.warmup()
    check(not engine.gate.degraded, "engine degraded with a fresh calibration")

    valid = list(rng.normal(size=(19, *img)).astype(np.float32))
    payloads = valid[:10] + [np.zeros((m.img_size, m.img_size), np.float32)] + valid[10:]
    payloads.append(np.full(img, np.nan, np.float32))
    ids = [f"r{i:02d}" for i in range(len(payloads))]

    score_pool.launches = 0
    fused_bn_epilogue.launches = 0
    engine.dispatch_count = 0
    t0 = time.perf_counter()
    resps = engine.serve_all(payloads, request_ids=ids)
    serve_s = time.perf_counter() - t0
    launches = {"score_pool": score_pool.launches, "bn_epilogue": fused_bn_epilogue.launches}
    dispatches = engine.dispatch_count

    check([r.request_id for r in resps] == ids, "not every id answered exactly once")
    bad = {r.request_id: (r.outcome, r.reason) for r in resps if r.request_id in ("r10", ids[-1])}
    check(bad == {"r10": ("reject", "bad_shape"), ids[-1]: ("reject", "nonfinite")},
          f"bad payloads not rejected typed: {bad}")
    served = [r for r in resps if r.request_id not in bad]
    check(all(r.outcome in ("predict", "abstain") for r in served),
          f"valid payloads not served: {[(r.request_id, r.outcome, r.reason) for r in served]}; "
          f"last dispatch error: {engine.last_dispatch_error}")
    check(dispatches == 3, f"expected 3 dispatches (8 + 8 + 3), got {dispatches}")
    check(launches["score_pool"] == dispatches, f"score_pool launches {launches} per {dispatches}")
    check(launches["bn_epilogue"] == 16 * dispatches, f"epilogue launches {launches} per {dispatches}")

    # the same weights through the plain path on the CPU
    cpu_model, _ = build_mgproto(m, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_ev = Evaluator(cpu_model, gmm.to("cpu"), cfg, device="cpu")
    x = np.stack(valid)
    ref_logits = torch.cat([cpu_ev(x[i:i + 8]).logits for i in range(0, len(x), 8)]).numpy()
    ref_px = np.logaddexp.reduce(ref_logits.astype(np.float64), axis=-1)
    gpu_logits = torch.cat([ev(x[i:i + 8]).logits.cpu() for i in range(0, len(x), 8)]).numpy()
    check(np.isfinite(gpu_logits).all() and gpu_logits.shape == (19, m.num_classes), "bad served logits")
    logit_err = float(np.abs(gpu_logits - ref_logits).max())
    px_err = float(np.abs(np.array([r.log_px for r in served]) - ref_px).max())
    srt = np.sort(ref_logits, axis=-1)
    clear = (srt[:, -1] - srt[:, -2]) > 2 * SERVE_ATOL
    pred_ok = bool((np.array([r.prediction for r in served]) == ref_logits.argmax(-1))[clear].all())
    check(logit_err <= SERVE_ATOL, f"served logits vs CPU plain path: {logit_err} > {SERVE_ATOL}")
    check(px_err <= SERVE_ATOL, f"served log p(x) vs CPU plain path: {px_err} > {SERVE_ATOL}")
    check(pred_ok, "served predictions differ from the CPU plain path")

    # the tolerance must tell the policy's f32 from TF32: the same forward with
    # TF32 switched on (what PyTorch gives cuDNN convolutions by default)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = [ev(x[i:i + 8]) for i in range(0, len(x), 8)]
        torch.cuda.synchronize()
    finally:
        apply_numerics_policy()
    tf32_logit_err = float(np.abs(torch.cat([o.logits.cpu() for o in tf32]).numpy() - ref_logits).max())
    tf32_px_err = float(np.abs(torch.cat([o.log_px.cpu() for o in tf32]).numpy() - ref_px).max())
    check(min(tf32_logit_err, tf32_px_err) > SERVE_ATOL,
          f"TF32 scores pass the f32 tolerance {SERVE_ATOL}: logits {tf32_logit_err}, "
          f"log p(x) {tf32_px_err}")

    latency = {}
    for b in engine.buckets:
        batch = x[:b]
        engine._dispatch(batch)
        times = []
        for _ in range(10):
            t1 = time.perf_counter()
            engine._dispatch(batch)
            times.append((time.perf_counter() - t1) * 1e3)
        latency[str(b)] = {"median_ms": float(np.median(times)), "min_ms": float(min(times))}
    emit("serve", requests=len(payloads), dispatches=dispatches, launches=launches,
         outcomes={o: sum(r.outcome == o for r in resps) for o in ("predict", "abstain", "reject")},
         serve_all_s=serve_s, warmup=warm, logits_max_abs_err_vs_cpu=logit_err,
         log_px_max_abs_err_vs_cpu=px_err, tolerance=SERVE_ATOL,
         tf32_logits_max_abs_err_vs_cpu=tf32_logit_err,
         tf32_log_px_max_abs_err_vs_cpu=tf32_px_err,
         dispatch_latency_host_ms=latency)
    profile_phase(engine, x[:8])
    return launches, dispatches


KERNEL_FAMILIES = ("score_pool_bwd", "score_pool", "bn_epilogue", "em_estep")


def family(name):
    name = name.lower()
    for fam in KERNEL_FAMILIES:
        if fam in name:
            return fam
    # cuDNN/cuBLAS kernels: implicit-GEMM, FFT and weight/data-gradient engines
    if any(w in name for w in ("conv", "gemm", "xmma", "cudnn", "sm90", "wgrad", "dgrad",
                               "fft", "complex", "cutlass")):
        return "conv/gemm"
    return "memcpy" if "memcpy" in name else "other"


def device_breakdown(run, reps):
    """Device time by kernel family over `reps` calls of `run`, and the
    device's idle share of that window (torch.profiler GPU activity events,
    overlapping spans merged). None when the profiler saw no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_family, other = [], {}, {}
    for e in prof.events():
        # user annotations (e.g. the optimizer's step range) are drawn on the
        # GPU timeline too; they are not device work
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + (end - start) / 1e3
        if fam == "other":
            key = e.name[:80]
            ms, n = other.get(key, (0.0, 0))
            other[key] = (ms + (end - start) / 1e3, n + 1)
    if not spans:
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    top_other = sorted(other.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "device_ms_per_call": {k: v / reps for k, v in sorted(by_family.items())},
        "other_top_ms_per_call": [[name, ms / reps, n / reps] for name, (ms, n) in top_other],
        "device_busy_ms_per_call": busy / reps / 1e3, "wall_ms_per_call": wall_us / reps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
    }


def profile_phase(engine, images):
    """Device time by kernel family over 5 bucket-8 dispatches."""
    rec = device_breakdown(lambda: engine._dispatch(images), 5)
    if rec is None:
        emit("profile", path="serve", note="profiler recorded no device events: not measured")
        return
    emit("profile", path="serve", bucket=int(images.shape[0]), dispatches=5, **rec)


# -------------------------------------------------------------------- train
def clone_state(src, cfg):
    """A TrainState for `cfg` holding a copy of `src`'s weights, BatchNorm
    statistics, proxies, GMM, bank and step, with fresh optimizers."""
    import torch

    from mgproto_tpu_torch.core.memory import Memory
    from mgproto_tpu_torch.core.state import create_train_state

    dst = create_train_state(cfg, torch.Generator().manual_seed(0), src.gmm.means.device)
    dst.model.load_state_dict(src.model.state_dict())
    with torch.no_grad():
        dst.proxies.copy_(src.proxies)
        dst.gmm.means.copy_(src.gmm.means)
    dst.gmm = dst.gmm._replace(sigmas=src.gmm.sigmas.clone(), priors=src.gmm.priors.clone(),
                               keep=src.gmm.keep.clone())
    dst.memory = Memory(*(t.clone() for t in src.memory))
    dst.step = src.step
    return dst


def full_bank(m, seed):
    """A flagship memory bank on the card, every queue full of seeded unit
    vectors and marked updated (so the first EM call is dense)."""
    import torch

    from mgproto_tpu_torch.core.memory import Memory

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c, cap, d = m.num_classes, m.mem_capacity, m.proto_dim
    bank = torch.randn(c, cap, d, generator=gen, device="cuda")
    return Memory(
        feats=torch.nn.functional.normalize(bank, dim=-1),
        length=torch.full((c,), cap, dtype=torch.int32, device="cuda"),
        cursor=torch.zeros(c, dtype=torch.int32, device="cuda"),
        updated=torch.ones(c, dtype=torch.bool, device="cuda"),
    )


def launch_counts():
    from mgproto_tpu_torch.ops.em_kernels import em_estep_stats
    from mgproto_tpu_torch.ops.fused_epilogue import fused_bn_epilogue
    from mgproto_tpu_torch.ops.fused_scoring import score_pool, score_pool_bwd

    return {"score_pool": score_pool.launches, "bn_epilogue": fused_bn_epilogue.launches,
            "score_pool_bwd": score_pool_bwd.launches, "em_estep": em_estep_stats.launches}


def reset_launch_counts():
    from mgproto_tpu_torch.ops.em_kernels import em_estep_stats
    from mgproto_tpu_torch.ops.fused_epilogue import fused_bn_epilogue
    from mgproto_tpu_torch.ops.fused_scoring import score_pool, score_pool_bwd

    for fn in (score_pool, fused_bn_epilogue, score_pool_bwd, em_estep_stats):
        fn.launches = 0


class Probe:
    """The activations at PROBES of one model in its next forward, and their
    gradients in the backward after it."""

    def __init__(self, model):
        mods = dict(model.named_modules())
        self.act, self.grad = {}, {}
        self.handles = [mods[name].register_forward_hook(self._hook(name)) for name in PROBES]

    def _hook(self, name):
        def fwd(_mod, _inp, out):
            self.act[name] = out.detach().clone()
            out.register_hook(lambda g: self.grad.__setitem__(name, g.detach().clone()))
        return fwd

    def remove(self):
        for h in self.handles:
            h.remove()


def rel_norm(got, want):
    return ((got - want).norm() / want.norm()).item()


def route_features(probe):
    """The scored features [B, HW, d] of a route's first step: its add-on
    output, L2-normalized per patch as the head does."""
    from mgproto_tpu_torch.core.mgproto import l2_normalize

    x = probe.act["add_on"].permute(0, 2, 3, 1)
    return l2_normalize(x.reshape(x.shape[0], -1, x.shape[-1]).float()).contiguous()


def top_t_changed(probe, ref, gmm0, t_levels):
    """Pooled (sample, prototype) lists whose top-T indices differ between
    two routes' features, both scored by the plain pool (so only the
    features differ)."""
    from mgproto_tpu_torch.ops.fused_scoring import score_pool_plain

    a, b = (score_pool_plain(route_features(p), *gmm0, t_levels)[1] for p in (probe, ref))
    return int((a != b).any(-1).sum()), a.shape[0] * a.shape[1]


def forward_agreement(probe, gmm0, t_levels):
    """The score_pool kernel against its plain version on a route's own
    first-step features: the share of equal indices and the largest value
    difference."""
    from mgproto_tpu_torch.ops.fused_scoring import score_pool, score_pool_plain

    x = route_features(probe)
    vals, idx = score_pool(x, *gmm0, t_levels)
    pvals, pidx = score_pool_plain(x, *gmm0, t_levels)
    return (idx == pidx).float().mean().item(), (vals - pvals).abs().max().item()


def route_record(name, run, ref, gmm0, t_levels):
    """One route's first step (`run`: its metrics, probe, gradient, EM
    log-likelihood and priors) against the plain route's `ref`."""
    met, probe, grad = run["met"], run["probe"], run["grad"]
    changed, lists = top_t_changed(probe, ref["probe"], gmm0, t_levels)
    return {
        "route": name,
        "loss_abs_err": abs(met.loss.item() - ref["met"].loss.item()),
        "grad_rel_err": rel_norm(grad, ref["grad"]),
        "grad_rel_err_by_group": {
            group: rel_norm(grad[sl], ref["grad"][sl]) for group, sl in ref["groups"].items()
        },
        "em_ll_abs_err": abs(run["ll"] - ref["ll"]),
        "priors_max_abs_err": (run["priors"] - ref["priors"]).abs().max().item(),
        "em_compact_fallback": met.em_compact_fallback,
        "act_rel_err": {p: rel_norm(probe.act[p], ref["probe"].act[p]) for p in PROBES},
        "act_grad_rel_err": {p: rel_norm(probe.grad[p], ref["probe"].grad[p]) for p in PROBES},
        "top_t_lists_changed": changed, "top_t_lists": lists,
    }


def first_step_run(trainer, state, probe, met):
    """What route_record reads of a route's first step, taken right after it."""
    import torch

    return {"met": met, "probe": probe,
            "grad": torch.cat([p.grad.reshape(-1) for p in trainer.params(state)]),
            "ll": trainer.last_bank.em.log_likelihood.item(),
            "priors": state.gmm.priors.clone()}


def train_phase():
    """The flagship training step on the card; returns the launch counts of
    the driven run and its number of steps."""
    import dataclasses

    import numpy as np
    import torch

    from mgproto_tpu_torch.config import Config, DataConfig
    from mgproto_tpu_torch.engine.train import Trainer

    # f32 batches of seeded noise, no augmentation: the input phase drives
    # the uint8 wire and the augmentation tail
    cfg = Config(data=DataConfig(device_augment=False))
    m = cfg.model
    trainer = Trainer(cfg, steps_per_epoch=100, device="cuda")
    check(trainer.fused and trainer.em_cfg.max_active_classes == TRAIN_BATCH,
          "the flagship trainer did not resolve to the kernels and a compact width of 80")
    state = trainer.init_state(seed=0)
    c = m.num_classes
    state.memory = full_bank(m, seed=1)
    gmm0 = (state.gmm.means.detach().clone(), state.gmm.sigmas.clone())

    def route(plain):
        """A trainer with the epilogue kernel off, and a copy of the initial
        state; `plain` turns the scoring kernels and the E-step off too."""
        rcfg = cfg.replace(
            model=dataclasses.replace(m, fused_scoring=False if plain else None,
                                      fused_epilogue=False),
            em=dataclasses.replace(cfg.em, fused_estep=False if plain else None),
        )
        tr = Trainer(rcfg, steps_per_epoch=100, device="cuda")
        return tr, clone_state(state, rcfg)

    plain_trainer, plain_state = route(plain=True)
    floor_state = clone_state(state, plain_trainer.cfg)
    score_trainer, score_state = route(plain=False)
    check(score_trainer.fused and not plain_trainer.fused, "the routes did not resolve as asked")

    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(TRAIN_BATCH, m.img_size, m.img_size, 3)).astype(np.float32),
                rng.integers(0, c, size=TRAIN_BATCH)) for _ in range(TRAIN_STEPS + 1)]
    per_step = {"score_pool": 1, "bn_epilogue": 16, "score_pool_bwd": 1}
    step_s, losses, first = [], [], None
    torch.cuda.synchronize()
    reset_launch_counts()
    for i, (images, labels) in enumerate(batches[:TRAIN_STEPS]):
        means0 = state.gmm.means.detach().clone()
        probe = Probe(state.model) if i == 0 else None
        before = launch_counts()
        t0 = time.perf_counter()
        state, met = trainer.train_step(state, images, labels, use_mine=True, update_gmm=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        loss = met.loss.item()
        losses.append(loss)
        check(np.isfinite(loss) and not met.nonfinite, f"train step {i}: loss {loss}")
        want = dict(per_step, em_estep=cfg.em.num_em_loop)
        check(delta == want, f"train step {i}: launches {delta}, expected {want}")
        check(met.em_compact_fallback == (1 if i == 0 else 0),
              f"train step {i}: em_compact_fallback {met.em_compact_fallback}")
        if i == 0:
            probe.remove()
            check(met.em_active == c, f"first EM call touched {met.em_active} classes, not {c}")
            first = first_step_run(trainer, state, probe, met)
        else:
            untouched = torch.ones(c, dtype=torch.bool, device="cuda")
            untouched[torch.as_tensor(labels, device="cuda")] = False
            check(met.em_active == c - int(untouched.sum()), f"train step {i}: em_active {met.em_active}")
            check(torch.equal(state.gmm.means.detach()[untouched], means0[untouched]),
                  f"train step {i}: an untouched class's means moved")
    trunk0 = [p.detach().clone() for p in state.model.features.parameters()]
    before = launch_counts()
    state, met = trainer.train_step(state, *batches[TRAIN_STEPS], use_mine=True,
                                    update_gmm=True, warm=True)
    torch.cuda.synchronize()
    launches = launch_counts()
    delta = {k: v - before[k] for k, v in launches.items()}
    check(delta == dict(per_step, em_estep=cfg.em.num_em_loop), f"warm step: launches {delta}")
    check(np.isfinite(met.loss.item()), "warm step: non-finite loss")
    check(all(torch.equal(p.detach(), q) for p, q in zip(state.model.features.parameters(), trunk0)),
          "the warm step moved the trunk")

    # the first step again from the same state on the other routes
    images0, labels0 = batches[0]
    runs = {"kernel": first}
    for name, tr, st, imgs in (("plain", plain_trainer, plain_state, images0),
                               ("floor", plain_trainer, floor_state, images0 * np.float32(1 + 1e-7)),
                               ("scoring", score_trainer, score_state, images0)):
        probe = Probe(st.model)
        st, rmet = tr.train_step(st, imgs, labels0, use_mine=True, update_gmm=True)
        probe.remove()
        runs[name] = first_step_run(tr, st, probe, rmet)
    ref = runs.pop("plain")
    at, groups = 0, {}
    for group, ps in (("features", plain_state.model.features.parameters()),
                      ("add_on", plain_state.model.add_on.parameters()),
                      ("embedding", plain_state.model.embedding.parameters()),
                      ("proxies", [plain_state.proxies])):
        n = sum(p.numel() for p in ps)
        groups[group] = slice(at, at + n)
        at += n
    ref["groups"] = groups
    records = {name: route_record(name, run, ref, gmm0, m.mine_T) for name, run in runs.items()}
    agree, fwd_err = forward_agreement(runs["scoring"]["probe"], gmm0, m.mine_T)
    records["scoring"].update(index_agreement=agree, fwd_max_abs_err=fwd_err)
    check(fwd_err <= SCORE_ATOL, f"score_pool at the train step's features: max err {fwd_err}")
    pmet = ref["met"]
    check(pmet.em_compact_fallback == 1, "plain route: first EM call did not fall back")
    grad_floor = records["floor"]["grad_rel_err"]
    for name in ("kernel", "scoring"):
        rec = records[name]
        check(rec["em_compact_fallback"] == 1, f"{name} route: first EM call did not fall back")
        check(rec["loss_abs_err"] <= TRAIN_LOSS_RTOL * abs(pmet.loss.item()),
              f"{name} vs plain route: loss differs by {rec['loss_abs_err']}")
        check(rec["em_ll_abs_err"] <= TRAIN_LL_ATOL,
              f"{name} vs plain route: EM log-likelihood differs by {rec['em_ll_abs_err']}")
        check(rec["priors_max_abs_err"] <= TRAIN_PRIOR_ATOL,
              f"{name} vs plain route: priors differ by {rec['priors_max_abs_err']}")
    check(records["scoring"]["grad_rel_err"] <= TRAIN_SCORING_GRAD_RTOL,
          f"scoring vs plain route: trunk gradient rel err {records['scoring']['grad_rel_err']}")
    check(records["kernel"]["grad_rel_err"] <= TRAIN_GRAD_FLOOR_MULT * grad_floor,
          f"kernel vs plain route: trunk gradient rel err {records['kernel']['grad_rel_err']} "
          f"> {TRAIN_GRAD_FLOOR_MULT} x the floor {grad_floor}")

    timed = step_s[1:]
    med = float(np.median(timed))
    emit("train", batch=TRAIN_BATCH, steps=TRAIN_STEPS, warm_steps=1, losses=losses,
         launches=launches, step_s=step_s, step_s_median=med, step_s_min=float(min(timed)),
         img_per_s=TRAIN_BATCH / med, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         first_step_loss=pmet.loss.item(), first_step_em_ll=ref["ll"],
         tolerances={"loss_rtol": TRAIN_LOSS_RTOL, "scoring_grad_rtol": TRAIN_SCORING_GRAD_RTOL,
                     "grad_floor_mult": TRAIN_GRAD_FLOOR_MULT, "grad_floor": grad_floor,
                     "ll_atol": TRAIN_LL_ATOL, "prior_atol": TRAIN_PRIOR_ATOL})
    for name in ("kernel", "scoring", "floor"):
        emit("train_route", vs="plain", **records[name])
    del plain_state, plain_trainer, floor_state, score_state, score_trainer, first, runs, ref

    it = itertools.cycle(batches[1:TRAIN_STEPS])
    holder = [state]

    def one_step():
        holder[0], _ = trainer.train_step(holder[0], *next(it), use_mine=True, update_gmm=True)

    rec = device_breakdown(one_step, 3)
    if rec is None:
        emit("profile", path="train", note="profiler recorded no device events: not measured")
    else:
        emit("profile", path="train", batch=TRAIN_BATCH, steps=3, **rec)
    return launches, TRAIN_STEPS + 1


# -------------------------------------------------------------------- input
def write_jpeg_tree(root, classes, per_class, hw, seed=0):
    """`classes` folders of `per_class` JPEGs (quality 90) at hw = (H, W):
    smooth seeded content, a bilinear upsample of a 6 x 8 grid of random
    colours, as CUB's photographs are smooth at 8 x 8 JPEG blocks."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    for c in range(classes):
        cdir = os.path.join(root, f"{c:03d}.class")
        os.makedirs(cdir, exist_ok=True)
        for i in range(per_class):
            coarse = Image.fromarray(rng.integers(0, 256, size=(6, 8, 3), dtype=np.uint8))
            coarse.resize((w, h), Image.BILINEAR).save(os.path.join(cdir, f"{i}.jpg"), quality=90)


def input_config(root, batch, workers, model=None):
    """The input phase's Config: the folder as the train, push and test
    directories, the process backend, the uint8 wire, mining and EM on from
    epoch 0."""
    from mgproto_tpu_torch.config import Config, DataConfig, ModelConfig, ScheduleConfig

    return Config(
        model=model if model is not None else ModelConfig(),
        data=DataConfig(train_dir=root, test_dir=root, train_push_dir=root,
                        train_batch_size=batch, test_batch_size=batch,
                        train_push_batch_size=batch, num_workers=workers,
                        worker_backend="process", device_augment=True),
        schedule=ScheduleConfig(num_warm_epochs=0, mine_start=0, update_gmm_start=0),
    )


def batch_digest(batches):
    """sha256 of the uint8 bytes, labels, ids and seeds of host batches."""
    import hashlib

    h = hashlib.sha256()
    for batch in batches:
        for a in batch:
            h.update(a.dtype.str.encode())
            h.update(a.tobytes())
    return h.hexdigest()


def first_batches(loader, n, epoch=0):
    """The first `n` batches of `epoch` (the loader's epoch counter is set
    back, so the same batches come again on a second call)."""
    loader.epoch = epoch
    out = []
    for batch in loader:
        out.append(batch)
        if len(out) == n:
            break
    return out


def loader_determinism(cfg, device):
    """Two passes over epoch 0's first two batches of build_pipelines'
    train loader (process backend, shared memory), and the thread backend's,
    by sha256. Returns the loaders and the record."""
    import dataclasses

    from mgproto_tpu_torch.data import build_pipelines

    loaders = build_pipelines(cfg, device=device)
    thread_cfg = cfg.replace(data=dataclasses.replace(cfg.data, worker_backend="thread"))
    thread = build_pipelines(thread_cfg, device=device)
    train = loaders[0]
    t0 = time.perf_counter()
    first = first_batches(train, 2)
    first_s = time.perf_counter() - t0
    digests = [batch_digest(first), batch_digest(first_batches(train, 2)),
               batch_digest(first_batches(thread[0], 2))]
    for dl in (*thread[:3], *thread[3]):
        dl.close()
    check(train.with_seeds and train.worker_backend == "process",
          "the train loader is not the process backend on the uint8 wire with seeds")
    check(first[0][0].dtype.name == "uint8" and first[0][3].dtype.name == "uint32",
          f"train batches are {first[0][0].dtype} with {first[0][3].dtype} seeds")
    check(digests[0] == digests[1], "two passes over epoch 0's first batches differ")
    check(digests[0] == digests[2], "the thread and process backends' batches differ")
    return loaders, first, {"sha256": digests[0], "passes_equal": True,
                            "thread_equals_process": True, "first_two_batches_s": first_s}


def uint8_route_check(cfg, state, batch, cpu_images, device):
    """The first step from `state` on the uint8 route (the seeds' draws, the
    tail on `device`) against the same batch augmented on the CPU
    (`cpu_images`, f32) on a trainer with augmentation off."""
    import dataclasses

    import numpy as np

    from mgproto_tpu_torch.engine.train import Trainer

    images, labels, _, seeds = batch
    f32_cfg = cfg.replace(data=dataclasses.replace(cfg.data, device_augment=False))
    runs = {}
    for name, rcfg, args in (("uint8", cfg, (images, labels)), ("f32", f32_cfg, (cpu_images, labels))):
        tr = Trainer(rcfg, steps_per_epoch=10, device=device)
        st = clone_state(state, rcfg)
        _, met = tr.train_step(st, *args, use_mine=True, update_gmm=True,
                               seeds=seeds if name == "uint8" else None)
        runs[name] = met.loss.item()
        del st, tr
    err = abs(runs["uint8"] - runs["f32"])
    check(all(np.isfinite(v) for v in runs.values()), f"uint8 route: non-finite loss {runs}")
    check(err <= TRAIN_LOSS_RTOL * abs(runs["f32"]),
          f"uint8 route vs CPU-augmented f32 route: loss differs by {err} ({runs})")
    return {"loss_uint8": runs["uint8"], "loss_f32_cpu_augmented": runs["f32"], "loss_abs_err": err,
            "loss_rtol": TRAIN_LOSS_RTOL}


def h2d_copies(trainers, batches, reps=5):
    """Host-to-device copy time of one batch per wire, alone on the card:
    `put_batch`'s events around its copies on the copy stream, median of
    `reps` puts after one that warms the pinned and device caches. Each put
    is read and freed before the next, so its blocks are reused and no
    allocation falls between the events (pinning is host work before the
    first)."""
    import numpy as np

    out = {}
    for name, trainer in trainers.items():
        ms = []
        for i in range(reps + 1):
            put = trainer.put_batch(batches[name])
            ms.append(put.copy_ms())
            nbytes = put.h2d_bytes
            del put
        med = float(np.median(ms[1:]))
        out[name] = {"bytes": nbytes, "ms": med, "gb_s": nbytes / med / 1e6,
                     "share_of_pcie": nbytes / med / 1e-3 / PCIE_BYTES_S, "ms_all": ms}
    return out


def input_phase():
    """The training input path on the card; returns the launch counts of the
    loader-fed epoch and its number of steps."""
    import dataclasses

    import numpy as np
    import torch

    from mgproto_tpu_torch import native
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.ops.augment import augment_draws, augment_tail
    from mgproto_tpu_torch.utils.images import IMAGENET_MEAN, IMAGENET_STD

    root = os.path.join(HERE, "build", "input_phase", "train")
    t0 = time.perf_counter()
    write_jpeg_tree(root, INPUT_CLASSES, INPUT_PER_CLASS, INPUT_HW)
    write_s = time.perf_counter() - t0

    # the host native library: built here (g++), held to its plain version
    t0 = time.perf_counter()
    native.load()
    native_s = time.perf_counter() - t0
    img = np.random.default_rng(2).integers(0, 256, size=(224, 224, 3), dtype=np.uint8)
    check(np.array_equal(native.u8_to_f32_norm(img, IMAGENET_MEAN, IMAGENET_STD),
                         native.u8_to_f32_norm_plain(img, IMAGENET_MEAN, IMAGENET_STD)),
          "host native u8_to_f32_norm differs from its numpy plain version")

    cfg = input_config(root, TRAIN_BATCH, INPUT_WORKERS)
    loaders, first, determinism = loader_determinism(cfg, "cuda")
    train_loader = loaders[0]
    try:
        steps = len(train_loader)
        check(steps == INPUT_CLASSES * INPUT_PER_CLASS // TRAIN_BATCH, f"{steps} batches an epoch")

        # the tail on the card against the same function on the CPU
        images, labels, _, seeds = first[0]
        draws = augment_draws(seeds)
        cpu = augment_tail(torch.from_numpy(images), torch.from_numpy(draws))
        gpu_in = (torch.from_numpy(images).cuda(), torch.from_numpy(draws).cuda())
        gpu = augment_tail(*gpu_in)
        tail_err = (gpu.cpu() - cpu).abs().max().item()
        check(torch.isfinite(gpu).all() and gpu.shape == images.shape,
              "augment_tail on the card: bad output")
        check(tail_err <= TAIL_ATOL, f"augment_tail card vs CPU: {tail_err} > {TAIL_ATOL}")
        ring, copies = ring_of(gpu_in, images.nbytes)
        # ~80 launches a call: 5 calls stay inside the card's queue of
        # pending launches, which would otherwise fill behind the spin
        tail_ms = device_ms(lambda: augment_tail(*next(ring)), iters=5)
        # one read of the u8 batch and the draws, one write of the f32 batch
        tail_bound, tail_by = bound_ms(0.0, images.nbytes * 5.0 + draws.nbytes)
        del ring, gpu, gpu_in

        trainer = Trainer(cfg, steps_per_epoch=steps, device="cuda")
        check(trainer.fused and trainer.device_augment, "the input trainer did not resolve to "
              "the kernels and the device augmentation tail")
        state = trainer.init_state(seed=0)
        state.memory = full_bank(cfg.model, seed=1)
        route = uint8_route_check(cfg, state, first[0], cpu.numpy(), "cuda")
        f32_cfg = cfg.replace(data=dataclasses.replace(cfg.data, device_augment=False))
        alone = h2d_copies(
            {"uint8": trainer, "f32": Trainer(f32_cfg, steps_per_epoch=steps, device="cuda")},
            {"uint8": first[0], "f32": (cpu.numpy(), labels)})
        del cpu

        # the main path: one epoch from the loader, kernel launches counted
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, met = trainer.train_epoch(state, train_loader, 0)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = launch_counts()
        log = trainer.step_log
        want = {"score_pool": steps, "bn_epilogue": 16 * steps, "score_pool_bwd": steps,
                "em_estep": cfg.em.num_em_loop * steps}
        check(len(log) == steps, f"train_epoch took {len(log)} steps, not {steps}")
        check(launches == want, f"input epoch: launches {launches}, expected {want}")
        check(np.isfinite(met.loss.item()) and not met.nonfinite, f"input epoch: loss {met.loss}")
        check(met.em_active > 0, "input epoch: EM touched no class")

        step_s = [r.step_s for r in log]
        wait_s = [r.wait_s for r in log]
        copy_ms = [r.copy_ms for r in log]
        copy_gb_s = log[0].h2d_bytes / float(np.median(copy_ms)) / 1e6
        steady = slice(1, None)
        med = float(np.median(step_s[steady]))
        emit("input", batch=TRAIN_BATCH, steps=steps, classes=INPUT_CLASSES,
             images=INPUT_CLASSES * INPUT_PER_CLASS, source_hw=list(INPUT_HW),
             workers=INPUT_WORKERS, backend="process", wire="uint8",
             jpeg_write_s=write_s, native_build_s=native_s, determinism=determinism,
             tail={"max_abs_err_vs_cpu": tail_err, "atol": TAIL_ATOL, "ms": tail_ms,
                   "bound_ms": tail_bound, "bound_by": tail_by, "input_copies": copies,
                   "at": f"B={TRAIN_BATCH}, 224x224x3 uint8"},
             uint8_route=route, launches=launches, loss=met.loss.item(),
             em_active=met.em_active, epoch_s=epoch_s, step_s=step_s, wait_s=wait_s,
             step_s_median=med, img_per_s=TRAIN_BATCH / med,
             loader_wait_share=sum(wait_s[steady]) / sum(step_s[steady]),
             loader_wait_share_all_steps=sum(wait_s) / sum(step_s),
             h2d_image_bytes_per_step=log[0].image_bytes, h2d_bytes_per_step=log[0].h2d_bytes,
             h2d={"in_epoch_ms": copy_ms, "in_epoch_ms_median": float(np.median(copy_ms)),
                  "in_epoch_gb_s_median": copy_gb_s,
                  "in_epoch_share_of_pcie": copy_gb_s * 1e9 / PCIE_BYTES_S,
                  "alone": alone, "pcie_gb_s": PCIE_BYTES_S / 1e9},
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

        holder = [state]

        def one_epoch():
            holder[0], _ = trainer.train_epoch(holder[0], train_loader, 1)

        rec = device_breakdown(one_epoch, 1)
        if rec is None:
            emit("profile", path="input", note="profiler recorded no device events: not measured")
        else:
            per_step = {k: v / steps for k, v in rec["device_ms_per_call"].items()}
            # the profiled epoch's first step waits for the loader's first
            # two batches with the card idle; the share without that wait
            first_wait_ms = trainer.step_log[0].wait_s * 1e3
            busy, wall = rec["device_busy_ms_per_call"], rec["wall_ms_per_call"]
            emit("profile", path="input", batch=TRAIN_BATCH, steps=steps,
                 device_ms_per_step=per_step, device_busy_ms_per_step=busy / steps,
                 wall_ms_per_step=wall / steps, device_idle_share=rec["device_idle_share"],
                 first_step_wait_ms=first_wait_ms,
                 device_idle_share_after_first_wait=1.0 - busy / (wall - first_wait_ms),
                 other_top_ms_per_epoch=rec["other_top_ms_per_call"])
    finally:
        for dl in (*loaders[:3], *loaders[3]):
            dl.close()
    return launches, steps


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "mgproto_tpu_torch")):
        print("chip_smoke: mgproto_tpu_torch/ not found beside this script", file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mgproto_tpu_torch.numerics import apply_numerics_policy
    from mgproto_tpu_torch.ops import _build

    apply_numerics_policy()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         card=smi, device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln] for name in libs}
    emit("build", seconds=time.perf_counter() - t0, libraries=libs, ptxas=ptxas)

    kernels = kernel_phase()
    serve_launches, dispatches = serve_phase()
    train_launches, train_steps = train_phase()
    input_launches, input_steps = input_phase()
    for k in kernels:
        # `launches`: the loader-fed epoch of the input phase (this path's
        # main run); the train phase's and the serve phase's beside them
        k["launches"] = input_launches[k["name"]]
        k["launches_per_input_step"] = k["launches"] / input_steps
        k["train_launches"] = train_launches[k["name"]]
        k["launches_per_train_step"] = k["train_launches"] / train_steps
        k["serve_launches"] = serve_launches.get(k["name"], 0)
        check(k["launches"] > 0, f"{k['name']} was not launched on the input path")
        check(k["train_launches"] > 0, f"{k['name']} was not launched on the train path")
    print(json.dumps({"kernels": kernels, "input_steps": input_steps, "train_steps": train_steps,
                      "serve_dispatches": dispatches}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
