"""Train steps of the VGG and DenseNet trunks against the JAX package's, on
the CPU: vgg11_bn and a small DenseNet (four blocks of two layers,
DenseNetFeatures' `growth_rate` / `block_config` / `num_init_features`,
registered in both registries for the file), one f32 step carried from a
JAX state with a full seeded bank.

Tolerances: the loss relative 1e-5, the other losses and metrics atol
1e-4, the bank and the EM outputs as in tests/test_torch_train.py
(features and priors atol 1e-5, means within 2 lr per EM round), the
running statistics atol 1e-5. The gradient of every parameter, as one
vector, within 1e-4 relative norm or 2x the floor, whichever is larger:
the floor is JAX's own gradient moved by images x (1 + 1e-7), as
chip_smoke.py's train phase measures it. At random init these trunks'
gradients are ill-conditioned (measured floors 1.3e-4 for vgg11_bn and
1e-5 for the small DenseNet at 32 px, the port 1.35e-4 and 1.03e-5 from
JAX), and single tensors more so (a conv bias before a train-mode
BatchNorm has a zero gradient up to rounding; a near tie in the top-T
pool moves the stem's), so no tensor is held alone.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_states import full_bank, small_densenets
from mgproto_tpu.config import EMConfig as JaxEMConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models.convert import from_jax_train_state, from_jax_variables

B = 6
LABELS = np.array([0, 1, 2, 3, 1, 0], np.int32)


@pytest.fixture(scope="module", autouse=True)
def registered():
    with small_densenets():
        yield


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gmm_stub():
    z = np.zeros((1, 1, 1), np.float32)
    return type("G", (), {"means": z, "sigmas": z, "priors": z[0], "keep": z[0] > 0})()


def _cfgs(arch, dtype="float32"):
    jcfg, tcfg = jax_tiny_config(arch=arch), tiny_test_config(arch=arch)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, compute_dtype=dtype),
                        em=JaxEMConfig(async_bank=False))
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, compute_dtype=dtype))
    return jcfg, tcfg


def _images(seed=0):
    return np.random.default_rng(seed).normal(size=(B, 32, 32, 3)).astype(np.float32)


def _flat(model, sd):
    return np.concatenate([np.asarray(sd[n]).ravel() for n, _ in model.named_parameters()])


def _carried(arch, dtype):
    """(JAX trainer, JAX state with a full seeded bank, port trainer, the
    same state carried into the port)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jtrainer = JaxTrainer(jcfg, steps_per_epoch=4)
    jstate = jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0))
    jstate = jstate.replace(memory=full_bank(jcfg.model, 1))
    return (jtrainer, jstate, Trainer(tcfg, steps_per_epoch=4, device="cpu"),
            from_jax_train_state(jax.device_get(jstate), tcfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _first_step(arch):
    """One f32 first step from one carried state on both sides: the port's
    state and metrics; JAX's new state and metrics, its gradient by the
    port's names and its gradient on the images x (1 + 1e-7)."""
    jtrainer, jstate, ptrainer, pstate = _carried(arch, "float32")
    images = _images()
    grad = jax.jit(jax.grad(jtrainer._loss_fn, has_aux=True))
    args = (jstate.params, jstate.batch_stats, jstate.gmm, images, LABELS, jnp.float32(1.0))
    jgrads, _ = grad(*args)
    nudged, _ = grad(*args[:3], images * np.float32(1 + 1e-7), *args[4:])
    jnew, jm = jtrainer.train_step(jstate, images, LABELS, use_mine=True, update_gmm=True)
    pstate, pm = ptrainer.train_step(pstate, images, LABELS, use_mine=True, update_gmm=True)
    gmm = jax.device_get(jstate.gmm)
    ref, _ = from_jax_variables({"params": jgrads["net"]}, gmm, arch)
    nudged, _ = from_jax_variables({"params": nudged["net"]}, gmm, arch)
    return dict(jnew=jax.device_get(jnew), jm=jm, ref=ref, nudged=nudged, pstate=pstate, pm=pm)


def _port_grad(model):
    return np.concatenate([p.grad.numpy().ravel() for _, p in model.named_parameters()])


@pytest.mark.parametrize("arch", ["vgg11_bn", "densenet_small"])
def test_train_step_matches_jax(arch):
    r = _first_step(arch)
    pm, jm, pstate, jnew = r["pm"], r["jm"], r["pstate"], r["jnew"]
    assert abs(float(pm.loss) - float(jm.loss)) <= 1e-5 * abs(float(jm.loss))
    for name in ("cross_entropy", "mine", "aux", "accuracy", "full_mem_ratio"):
        np.testing.assert_allclose(float(getattr(pm, name)), float(getattr(jm, name)),
                                   atol=1e-4, err_msg=name)
    assert pm.em_active == int(jm.em_active) and not pm.nonfinite
    model = pstate.model
    g_port = _port_grad(model)
    g_jax, g_nudged = _flat(model, r["ref"]), _flat(model, r["nudged"])
    assert _rel(g_port, g_jax) <= max(1e-4, 2 * _rel(g_nudged, g_jax))
    for name in ("length", "cursor", "updated"):
        np.testing.assert_array_equal(getattr(pstate.memory, name).numpy(),
                                      np.asarray(getattr(jnew.memory, name)), err_msg=name)
    np.testing.assert_allclose(pstate.memory.feats.numpy(), np.asarray(jnew.memory.feats),
                               atol=1e-5)
    np.testing.assert_allclose(pstate.gmm.priors.numpy(), np.asarray(jnew.gmm.priors), atol=1e-5)
    np.testing.assert_allclose(pstate.gmm.means.detach().numpy(), np.asarray(jnew.gmm.means),
                               atol=2 * 3 * 3e-3)
    stats, _ = from_jax_variables({"params": {}, "batch_stats": jnew.batch_stats},
                                  _gmm_stub(), arch)
    got = pstate.model.state_dict()
    assert stats
    for k, v in stats.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)


def test_a_trunk_without_batchnorm_trains_and_skips_a_nan_step():
    """vgg11 has no BatchNorm, so the step has no running statistic to
    snapshot: a finite step updates the trunk, a NaN batch leaves it as it
    was (the guard's skip)."""
    trainer = Trainer(tiny_test_config(arch="vgg11"), 4, device="cpu")
    state = trainer.init_state(0)
    w0 = state.model.features.get_submodule("0").weight.detach().clone()
    state, m = trainer.train_step(state, _images(), LABELS, use_mine=True, update_gmm=False)
    assert not m.nonfinite and np.isfinite(float(m.loss))
    w1 = state.model.features.get_submodule("0").weight.detach().clone()
    assert not torch.equal(w0, w1)
    nan = np.full_like(_images(), np.nan)
    state, m = trainer.train_step(state, nan, LABELS, use_mine=True, update_gmm=False)
    assert m.nonfinite and state.step == 2
    assert torch.equal(state.model.features.get_submodule("0").weight.detach(), w1)


@pytest.mark.parametrize("arch", ["vgg11_bn", "densenet_small"])
def test_adam_moments_carry_by_name(arch):
    """A JAX state after one step carried across: every trunk parameter's
    Adam moments are the JAX moments of the same flax name (many tensors
    share a shape, so moments mapped by position would differ)."""
    from mgproto_tpu_torch.models.convert import _adam_of

    jnew = _first_step(arch)["jnew"]
    state = from_jax_train_state(jnew, _cfgs(arch)[1], device="cpu")
    adam = _adam_of(jnew.opt_state.inner_states["features"])
    mu, _ = from_jax_variables({"params": adam.mu["net"]}, _gmm_stub(), arch)
    nu, _ = from_jax_variables({"params": adam.nu["net"]}, _gmm_stub(), arch)
    trunk = dict(state.model.features.named_parameters(prefix="features"))
    assert len(trunk) > 20 and set(trunk) <= set(mu)
    for name, p in trunk.items():
        st = state.opt.state[p]
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        assert float(st["step"]) == 1.0
