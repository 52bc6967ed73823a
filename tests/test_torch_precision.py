"""The port's mixed-precision trunk (`compute_dtype="bfloat16"`) against the
JAX package's, on the CPU.

Which route each side takes on the CPU: the JAX package resolves
`fused_epilogue` off there, so its block tails are flax BatchNorm (f32
arithmetic, rounded once to bf16) then the shortcut add and ReLU in bf16;
the port's CPU route is its plain one, `models/common.py::BatchNorm` (the
same f32 arithmetic, rounded once) then the add and ReLU in bf16. Both
round at the same places. The convs differ in summation order (oneDNN's
and XLA's), and in bf16 a different f32 sum rounds to a neighbour one
bf16 ulp away (2^-8 of |y| at the worst) on a few in 10^5 outputs.

Tolerances, in bf16 ulps (u = 2^-8 relative; a bf16 value's neighbour lies
at most 2^-7 |y| away):
  * BatchNorm (train and eval mode) and a ResNet BasicBlock on the same
    bf16 inputs: every output within one bf16 step (2^-7 |y|, + 1e-30),
    and at most 1 % of the outputs differ at all (the f32 statistics and
    convs sum in another order); running statistics atol 1e-6.
  * The tiny trunk (3 convs): the proto map within 1e-3 relative norm of
    JAX's op-by-op bf16 forward (measured 0.0), logits and log p(x) atol
    1e-2 (|logit| ~ 30: a few bf16 steps of the scored features); the
    first step's loss relative 1e-3, its gradient within 1e-2 relative
    norm of JAX's op-by-op step (measured 2.2e-3). Under `jit`, XLA:CPU
    drops some bf16 roundings inside its fusions, so the jitted JAX step is
    2.8e-2 away from its own op-by-op step; the port is held to the jitted
    step within 2x that spread.
  * resnet18 at 32 px (the flagship's block structure): eight blocks
    carry a one-ulp difference into 35 % of layer4's outputs (rel 4e-3),
    and the gradient at a random init amplifies it (JAX's jitted step vs
    its own op-by-op step: 0.32 relative). So the first step is held to a
    gate of JAX's form, each bound tighter than JAX's own f32-vs-bf16 gate
    (tests/test_precision.py: loss 2 %, norm ratio 15 %, cosine 0.85):
    loss within 1.5 %, gradient norm ratio within 5 %, cosine >= 0.9
    (measured 0.9 %, 0.95). The port's bf16 step against its own f32 step
    passes JAX's documented gate itself.
  * The bank after the step: features atol 2e-2 (unit vectors scored from
    a bf16 proto map: a few bf16 steps), lengths/cursors exact; priors atol
    1e-4. At resnet18 an enqueued row may be another patch where two
    patches nearly tie for a prototype's top-1: at most 3 of the 18 rows a
    step writes (measured 2).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_states import full_bank
from mgproto_tpu.config import EMConfig as JaxEMConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.models.common import BatchNorm as FlaxBatchNorm
from mgproto_tpu.models.resnet import BasicBlock as FlaxBasicBlock
from mgproto_tpu.perf.precision import policy_meta as jax_policy_meta
from mgproto_tpu_torch.config import ModelConfig, tiny_test_config
from mgproto_tpu_torch.core import em as tem
from mgproto_tpu_torch.core import memory as tmem
from mgproto_tpu_torch.core.mgproto import build_mgproto
from mgproto_tpu_torch.engine.eval import Evaluator
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models.common import BatchNorm
from mgproto_tpu_torch.models.convert import from_jax_train_state, from_jax_variables
from mgproto_tpu_torch.models.resnet import BasicBlock
from mgproto_tpu_torch.perf.precision import (
    PrecisionError,
    PrecisionPolicy,
    assert_f32_stats,
    policy_meta,
    resolve_policy,
)
from mgproto_tpu_torch.serving.calibration import Calibration, calibrate, gmm_fingerprint
from mgproto_tpu_torch.serving.engine import ServingEngine

STEP = 2.0 ** -7  # one bf16 step, relative to |y|
B = 6
LABELS = np.array([0, 1, 2, 3, 1, 0], np.int32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _within_one_step(got, want, max_share):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= STEP * np.abs(want) + 1e-30)
    assert float((got != want).mean()) <= max_share


def _bf16(rng, *shape):
    """Seeded values exactly representable in bf16: (jax array, torch NCHW
    channels_last view of the same values)."""
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    return x, t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).detach().numpy()


# -------------------------------------------------------------- the policy
def test_policy_validates_and_matches_jax_meta():
    for dtype in ("float32", "bfloat16"):
        p = resolve_policy(tiny_test_config().replace(
            model=dataclasses.replace(tiny_test_config().model, compute_dtype=dtype)))
        assert p.torch_dtype == getattr(torch, dtype)
        from mgproto_tpu.perf.precision import PrecisionPolicy as JaxPolicy

        assert policy_meta(p) == jax_policy_meta(JaxPolicy(compute_dtype=dtype))
    with pytest.raises(ValueError, match="compute_dtype must be one of"):
        ModelConfig(compute_dtype="float16")
    with pytest.raises(ValueError, match="not a knob"):
        PrecisionPolicy(compute_dtype="bfloat16", stats_dtype="bfloat16")


def test_assert_f32_stats_refuses_a_half_bank():
    cfg = tiny_test_config()
    mem = tmem.init_memory(4, 16, 8)
    half = mem._replace(feats=mem.feats.to(torch.bfloat16))
    feats = torch.zeros(6, 8)
    classes, valid = torch.zeros(6, dtype=torch.long), torch.ones(6, dtype=torch.bool)
    assert assert_f32_stats(mem.feats, "bank") is mem.feats
    with pytest.raises(PrecisionError, match="memory bank feats"):
        tmem.memory_push(half, feats, classes, valid)
    state = Trainer(cfg, 1, device="cpu").init_state(0)
    for gmm, memory, cand, what in (
        (state.gmm, half, feats, "memory bank feats"),
        (state.gmm, mem, feats.to(torch.bfloat16), "enqueue candidates"),
        (state.gmm._replace(priors=state.gmm.priors.half()), mem, feats, "gmm.priors"),
        (state.gmm._replace(means=state.gmm.means.detach().to(torch.bfloat16)), mem, feats,
         "gmm.means"),
    ):
        with pytest.raises(PrecisionError, match=what):
            tem.bank_update(gmm, memory, state.mean_opt, cfg.em, cand, classes, valid,
                            0, True, torch.tensor(True))


# ------------------------------------------------------------- the blocks
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_bf16_matches_flax(train):
    rng = np.random.default_rng(1)
    c = 16
    x, xt = _bf16(rng, 4, 6, 6, c)
    scale = (0.5 + rng.random(c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    mean = (0.1 * rng.normal(size=c)).astype(np.float32)
    var = (0.5 + rng.random(c)).astype(np.float32)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    bn = FlaxBatchNorm(dtype=jnp.bfloat16)
    port = BatchNorm(c)
    with torch.no_grad():
        for t, a in ((port.weight, scale), (port.bias, bias), (port.running_mean, mean),
                     (port.running_var, var)):
            t.copy_(torch.from_numpy(a))
    port.train(train)
    if train:
        y, upd = bn.apply(v, x, use_running_average=False, mutable=["batch_stats"])
    else:
        y = bn.apply(v, x, use_running_average=True)
    with torch.no_grad():
        yt = port(xt)
    assert y.dtype == jnp.bfloat16 and yt.dtype == torch.bfloat16
    _within_one_step(_nhwc(yt), np.asarray(y.astype(jnp.float32)), 0.01)
    if train:
        for key, buf in (("mean", port.running_mean), ("var", port.running_var)):
            assert buf.dtype == torch.float32
            np.testing.assert_allclose(buf.numpy(), np.asarray(upd["batch_stats"][key]),
                                       rtol=0, atol=1e-6)


def test_basic_block_bf16_matches_flax():
    """A downsampling BasicBlock in train mode: convs on f32 masters cast to
    bf16, BatchNorm in f32 rounded once, the add and the ReLU in bf16."""
    rng = np.random.default_rng(2)
    x, xt = _bf16(rng, 4, 8, 8, 16)
    block = FlaxBasicBlock(planes=32, stride=2, has_downsample=True, dtype=jnp.bfloat16)
    v = block.init(jax.random.PRNGKey(0), x, train=False)
    v = jax.tree_util.tree_map(lambda a: a + 0.05 * jnp.asarray(rng.normal(size=a.shape),
                                                                 a.dtype), v)
    y, _ = block.apply(v, x, train=True, mutable=["batch_stats"])
    sd, _ = from_jax_variables({"params": {"b": v["params"]},
                                "batch_stats": {"b": v["batch_stats"]}},
                               _gmm_stub())
    port = BasicBlock(16, 32, 2, downsample=True).train()
    port.load_state_dict({k.removeprefix("b."): t for k, t in sd.items()})
    for p in port.parameters():
        assert p.dtype == torch.float32
    with torch.no_grad():
        yt = port(xt.contiguous(memory_format=torch.channels_last))
    assert yt.dtype == torch.bfloat16
    _within_one_step(_nhwc(yt), np.asarray(y.astype(jnp.float32)), 0.01)


def _gmm_stub():
    z = np.zeros((1, 1, 1), np.float32)
    return type("G", (), {"means": z, "sigmas": z, "priors": z[0], "keep": z[0] > 0})()


# ---------------------------------------------------------- model and step
def _cfgs(arch, dtype):
    jcfg, tcfg = jax_tiny_config(arch=arch), tiny_test_config(arch=arch)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, compute_dtype=dtype),
                        em=JaxEMConfig(async_bank=False))
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, compute_dtype=dtype))
    return jcfg, tcfg


def _images(seed=0):
    return np.random.default_rng(seed).normal(size=(B, 32, 32, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_state(arch, dtype):
    jcfg, _ = _cfgs(arch, dtype)
    trainer = JaxTrainer(jcfg, steps_per_epoch=4)
    state = jax.jit(trainer.init_state)(jax.random.PRNGKey(0))
    return trainer, state.replace(memory=full_bank(jcfg.model, 1))


def _port(arch, dtype, jstate):
    _, tcfg = _cfgs(arch, dtype)
    return (Trainer(tcfg, steps_per_epoch=4, device="cpu"),
            from_jax_train_state(jax.device_get(jstate), tcfg, device="cpu"))


def _flat_grads(model, jgrads, jstate):
    """(port gradient, JAX gradient) of the net, flattened in one order."""
    sd, _ = from_jax_variables({"params": jgrads["net"]}, jax.device_get(jstate.gmm))
    names = [n for n, _ in model.named_parameters()]
    port = np.concatenate([p.grad.numpy().ravel() for _, p in model.named_parameters()])
    return port, np.concatenate([np.asarray(sd[n]).ravel() for n in names])


@functools.lru_cache(maxsize=None)
def _first_step(arch, dtype):
    """One first step on both sides from one state: the port's metrics,
    gradient and state after it; JAX's jitted gradient, metrics and state,
    and (tiny only) its op-by-op gradient."""
    jtrainer, jstate = _jax_state(arch, dtype)
    ptrainer, pstate = _port(arch, dtype, jstate)
    images = _images()
    grad = jax.grad(jtrainer._loss_fn, has_aux=True)
    args = (jstate.params, jstate.batch_stats, jstate.gmm, images, LABELS, jnp.float32(1.0))
    jgrads, _ = jax.jit(grad)(*args)
    eager = None
    if arch == "tiny":
        with jax.disable_jit():
            eager, _ = grad(*args)
    jnew, jm = jtrainer.train_step(jstate, images, LABELS, use_mine=True, update_gmm=True)
    pstate, pm = ptrainer.train_step(pstate, images, LABELS, use_mine=True, update_gmm=True)
    g_port, g_jit = _flat_grads(pstate.model, jgrads, jstate)
    g_eager = None if eager is None else _flat_grads(pstate.model, eager, jstate)[1]
    return dict(pstate=pstate, pm=pm, ptrainer=ptrainer, jnew=jnew, jm=jm,
                g_port=g_port, g_jit=g_jit, g_eager=g_eager)


def test_tiny_bf16_forward_matches_jax():
    jtrainer, jstate = _jax_state("tiny", "bfloat16")
    ptrainer, pstate = _port("tiny", "bfloat16", jstate)
    images = _images(3)
    (jpm, jemb), _ = jtrainer._apply(jstate.params, jstate.batch_stats, jnp.asarray(images),
                                     train=False)
    with torch.no_grad():
        pstate.model.eval()
        ppm, pemb = pstate.model(torch.from_numpy(images))
    assert ppm.dtype == pemb.dtype == torch.float32
    assert _rel(ppm.numpy(), np.asarray(jpm)) <= 1e-3
    np.testing.assert_allclose(pemb.numpy(), np.asarray(jemb), atol=1e-5)
    with jax.disable_jit():
        jo = jtrainer.eval_step(jstate, images)
    po = ptrainer.eval_step(pstate, images)
    assert po.logits.dtype == po.log_px.dtype == torch.float32
    np.testing.assert_allclose(po.logits.numpy(), np.asarray(jo.logits), atol=1e-2)
    np.testing.assert_allclose(po.log_px.numpy(), np.asarray(jo.log_px), atol=1e-2)


def test_tiny_bf16_first_step_matches_jax():
    r = _first_step("tiny", "bfloat16")
    pm, jm = r["pm"], r["jm"]
    assert abs(float(pm.loss) - float(jm.loss)) <= 1e-3 * abs(float(jm.loss))
    assert _rel(r["g_port"], r["g_eager"]) <= 1e-2
    spread = _rel(r["g_jit"], r["g_eager"])  # XLA's fusions against op by op
    assert _rel(r["g_port"], r["g_jit"]) <= 2 * spread
    _bank_and_priors_match(r)


def _bank_and_priors_match(r, moved_rows=0):
    """The bank's bookkeeping exact, its rows atol 2e-2 but for at most
    `moved_rows` rows (an enqueued row is a top-1 patch: a near tie can
    pick another patch on the two sides), the priors atol 1e-4."""
    pstate, jnew = r["pstate"], jax.device_get(r["jnew"])
    for name in ("length", "cursor", "updated"):
        np.testing.assert_array_equal(getattr(pstate.memory, name).numpy(),
                                      np.asarray(getattr(jnew.memory, name)))
    far = np.abs(pstate.memory.feats.numpy() - np.asarray(jnew.memory.feats)) > 2e-2
    assert int(far.any(-1).sum()) <= moved_rows
    np.testing.assert_allclose(pstate.gmm.priors.numpy(), np.asarray(jnew.gmm.priors), atol=1e-4)


def test_resnet18_bf16_first_step_within_a_tighter_gate_than_jax():
    r = _first_step("resnet18", "bfloat16")
    loss, jloss = float(r["pm"].loss), float(r["jm"].loss)
    assert abs(loss - jloss) <= 0.015 * abs(jloss)
    gp, gj = r["g_port"], r["g_jit"]
    ratio = np.linalg.norm(gp) / np.linalg.norm(gj)
    cos = float(gp @ gj / (np.linalg.norm(gp) * np.linalg.norm(gj)))
    assert 0.95 <= ratio <= 1.05, ratio
    assert cos >= 0.9, cos
    _bank_and_priors_match(r, moved_rows=3)


def test_port_bf16_step_against_port_f32_under_jax_gate():
    """JAX's documented gate (tests/test_precision.py): resnet18 at 32 px,
    one state, the bf16 step against the f32 step."""
    a, b = _first_step("resnet18", "bfloat16"), _first_step("resnet18", "float32")
    la, lb = float(a["pm"].loss), float(b["pm"].loss)
    assert abs(la - lb) / abs(lb) < 0.02
    ga, gb = a["g_port"], b["g_port"]
    assert 0.85 < np.linalg.norm(ga) / np.linalg.norm(gb) < 1.15
    assert float(ga @ gb / (np.linalg.norm(ga) * np.linalg.norm(gb))) > 0.85


def test_bf16_step_keeps_every_statistic_f32():
    r = _first_step("tiny", "bfloat16")
    state, trainer = r["pstate"], r["ptrainer"]
    assert trainer.precision.mixed and trainer.precision.compute_dtype == "bfloat16"
    assert state.model.compute_dtype == torch.bfloat16
    for name, t in state.model.state_dict().items():  # master params and BN buffers
        if t.is_floating_point():
            assert t.dtype == torch.float32, name
    for opt in (state.opt, state.mean_opt):
        for s in opt.state.values():
            assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
    assert state.opt.state  # the joint step ran
    assert state.memory.feats.dtype == torch.float32
    for t in state.gmm[:3]:
        assert t.dtype == torch.float32
    em = trainer.last_bank.em
    assert em is not None and em.log_likelihood.dtype == em.loss.dtype == torch.float32
    assert r["pm"].loss.dtype == torch.float32


# ----------------------------------------------------------------- serving
def test_bf16_serving_stamps_and_gates_its_calibration():
    cfg = tiny_test_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    model, gmm = build_mgproto(cfg.model, device="cpu", seed=0)
    ev = Evaluator(model, gmm, cfg, device="cpu")
    images = _images(7)[:4]
    cal = calibrate(ev, [images])
    assert cal.compute_dtype == "bfloat16"
    eng = ServingEngine.from_live(ev, calibration=cal, buckets=(4,))
    assert not eng.gate.degraded
    resps = eng.serve_all(list(images))
    assert all(np.isfinite(r.log_px) and not r.degraded for r in resps)
    f32 = Calibration.from_dict({**cal.to_dict(), "compute_dtype": "float32"})
    eng = ServingEngine.from_live(ev, calibration=f32, buckets=(4,))
    assert eng.gate.degraded and eng.gate.precision_mismatch
    assert gmm_fingerprint(ev.gmm) == cal.gmm_fingerprint
