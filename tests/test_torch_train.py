"""The port's training step against the JAX package's, on the CPU.

A tiny JAX `Trainer` (fused_scoring and fused_estep forced on, so its Pallas
kernels run in interpret mode; compact EM width 2 of 4 classes, so both the
compact path and its dense fallback run) is built once per file, its memory
bank pre-filled with seeded unit vectors, and `from_jax_train_state` carries
the whole state into the port, which runs on the CPU with the plain versions
of its kernels. Inputs are made with numpy from seeds.

Tolerances:
  * losses, metrics: atol 1e-4 (XLA's and ATen's CPU convolutions sum in
    different orders; the loss is O(10)).
  * trunk gradients: relative norm ||g_port - g_jax|| / ||g_jax|| <= 1e-4
    per parameter tensor.
  * the bank after the push: lengths, cursors and flags exact; features
    atol 1e-5 (they come from the forward). `memory_push` alone is held
    bit-exact.
  * priors atol 1e-5; EM log-likelihood atol 1e-4; m-step loss rtol 1e-5;
    mean gradients atol 1e-5 x max |JAX gradient|.
  * Adam-updated parameters: the first Adam step turns any nonzero
    gradient into about +-lr, so an element whose gradient is near zero can
    land 2 lr apart on two routes that agree to 1e-6. Means after EM are
    compared within 2 lr per round (atol 2 * num_em_loop * mean_lr); where
    both sides are handed the SAME gradients, one optimizer step agrees to
    atol 1e-6.
  * the five-step loss trajectory: atol 1e-3 per step.
  * two loader-fed `train_epoch` steps (uint8 wire, device augmentation on
    both sides, the same JPEG tree): the last step's losses and metrics atol
    1e-4, the bank's features and the priors atol 1e-5, the means within
    2 lr per EM round as above. The JAX tail runs under jit, 6e-6 from the
    port's in normalized units (tests/test_torch_augment.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mgproto_tpu.config import DataConfig as JaxDataConfig
from mgproto_tpu.config import EMConfig as JaxEMConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.core import em as jem
from mgproto_tpu.core import losses as jl
from mgproto_tpu.core import memory as jmem
from mgproto_tpu.core.mgproto import GMMState as JaxGMMState
from mgproto_tpu.core.state import staircase_schedule
from mgproto_tpu.data import DataLoader as JaxDataLoader
from mgproto_tpu.data import ImageFolder as JaxImageFolder
from mgproto_tpu.data.transforms import TrainTransform as JaxTrainTransform
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.ops.gaussian import e_step as jax_e_step
from mgproto_tpu_torch.config import DataConfig, EMConfig, tiny_test_config
from mgproto_tpu_torch.core import em as tem
from mgproto_tpu_torch.core import losses as tl
from mgproto_tpu_torch.core import memory as tmem
from mgproto_tpu_torch.core.mgproto import GMMState
from mgproto_tpu_torch.core.state import set_joint_lrs, staircase_lr
from mgproto_tpu_torch.data import DataLoader, ImageFolder
from mgproto_tpu_torch.data.transforms import TrainTransform
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models.convert import from_jax_train_state, from_jax_variables
from mgproto_tpu_torch.ops.gaussian import e_step

B = 6
WIDTH = 2  # compact EM width, of C = 4 classes


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs():
    jcfg = jax_tiny_config()
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, fused_scoring=True),
        em=JaxEMConfig(fused_estep=True, async_bank=False, max_active_classes=WIDTH),
    )
    tcfg = tiny_test_config()
    tcfg = tcfg.replace(
        model=dataclasses.replace(tcfg.model, fused_scoring=True),
        em=EMConfig(fused_estep=True, max_active_classes=WIDTH),
    )
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_side():
    """The JAX trainer, its state (bank pre-filled: classes 0-2 full,
    class 3 two short, nothing marked updated) and a jitted loss gradient."""
    jcfg, _ = _configs()
    trainer = JaxTrainer(jcfg, steps_per_epoch=4)
    state = jax.jit(trainer.init_state)(jax.random.PRNGKey(0))
    m = jcfg.model
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(m.num_classes, m.mem_capacity, m.proto_dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    length = np.full(m.num_classes, m.mem_capacity, np.int32)
    length[3] -= 2
    memory = jmem.Memory(
        feats=jnp.asarray(feats), length=jnp.asarray(length),
        cursor=jnp.asarray(rng.integers(0, m.mem_capacity, m.num_classes).astype(np.int32)),
        updated=jnp.zeros(m.num_classes, bool),
    )
    state = state.replace(memory=memory)
    grad_fn = jax.jit(jax.grad(trainer._loss_fn, has_aux=True))
    return trainer, state, grad_fn


def _port_side(jstate):
    _, tcfg = _configs()
    return Trainer(tcfg, steps_per_epoch=4, device="cpu"), from_jax_train_state(
        jax.device_get(jstate), tcfg, device="cpu")


def _batch(seed, labels):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(len(labels), 32, 32, 3)).astype(np.float32)
    return images, np.asarray(labels, np.int32)


LABELS = {
    "compact": [0, 1, 0, 1, 1, 0],  # 2 dirty classes <= width
    "fallback": [0, 1, 2, 3, 3, 0],  # 4 dirty classes > width: dense
}


def _port_grads(jgrads, jstate):
    """JAX gradients of the net renamed and laid out as the port's params."""
    sd, _ = from_jax_variables({"params": jgrads["net"]}, jax.device_get(jstate.gmm))
    return sd


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", sorted(LABELS))
def test_train_step_matches_jax(case):
    jtrainer, jstate, grad_fn = _jax_side()
    ptrainer, pstate = _port_side(jstate)
    images, labels = _batch(1, LABELS[case])

    jgrads, _ = grad_fn(jstate.params, jstate.batch_stats, jstate.gmm, images, labels,
                        jnp.float32(1.0))
    jnew, jm = jtrainer.train_step(jstate, images, labels, use_mine=True, update_gmm=True)
    pstate, pm = ptrainer.train_step(pstate, images, labels, use_mine=True, update_gmm=True)

    for name in ("loss", "cross_entropy", "mine", "aux", "accuracy", "full_mem_ratio"):
        np.testing.assert_allclose(float(getattr(pm, name)), float(getattr(jm, name)),
                                   atol=1e-4, err_msg=name)
    assert pm.em_active == int(jm.em_active) == (2 if case == "compact" else 4)
    assert pm.em_compact_fallback == int(jm.em_compact_fallback) == (case == "fallback")
    assert pm.nonfinite is False and not bool(jm.nonfinite)
    assert pstate.step == int(jnew.step) == 1

    # trunk (and embedding, and proxy) gradients of the step
    ref = _port_grads(jgrads, jstate)
    for name, p in pstate.model.named_parameters():
        assert _rel(p.grad.numpy(), np.asarray(ref[name])) <= 1e-4, name
    assert _rel(pstate.proxies.grad.numpy(), np.asarray(jgrads["proxies"])) <= 1e-4

    # the bank after the push (EM then clears `updated`)
    jmem_new = jax.device_get(jnew.memory)
    for name in ("length", "cursor", "updated"):
        np.testing.assert_array_equal(getattr(pstate.memory, name).numpy(),
                                      np.asarray(getattr(jmem_new, name)), err_msg=name)
    np.testing.assert_allclose(pstate.memory.feats.numpy(), np.asarray(jmem_new.feats), atol=1e-5)

    # BatchNorm running statistics, and the GMM after EM
    sd = pstate.model.state_dict()
    for mod, stats in jax.device_get(jnew.batch_stats)["features"].items():
        for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(sd[f"features.{mod}.{key}"].numpy(),
                                       np.asarray(stats[leaf]), atol=1e-5)
    np.testing.assert_allclose(pstate.gmm.priors.numpy(), np.asarray(jnew.gmm.priors), atol=1e-5)
    lr_tol = 2 * 3 * 3e-3
    np.testing.assert_allclose(pstate.gmm.means.detach().numpy(), np.asarray(jnew.gmm.means),
                               atol=lr_tol)
    touched = np.unique(LABELS[case])
    untouched = np.setdiff1d(np.arange(4), touched)
    np.testing.assert_array_equal(pstate.gmm.means.detach().numpy()[untouched],
                                  np.asarray(jstate.gmm.means)[untouched])


def test_five_step_loss_trajectory_with_em():
    jtrainer, jstate, _ = _jax_side()
    ptrainer, pstate = _port_side(jstate)
    rng = np.random.default_rng(2)
    for i in range(5):
        labels = rng.integers(0, 4, size=B).astype(np.int32)
        images, _ = _batch(10 + i, labels)
        jstate, jm = jtrainer.train_step(jstate, images, labels, use_mine=True, update_gmm=True)
        pstate, pm = ptrainer.train_step(pstate, images, labels, use_mine=True, update_gmm=True)
        np.testing.assert_allclose(float(pm.loss), float(jm.loss), atol=1e-3, err_msg=f"step {i}")
        assert pm.em_active == int(jm.em_active), i
        assert pm.em_compact_fallback == int(jm.em_compact_fallback), i
    assert pstate.step == int(jstate.step) == 5
    np.testing.assert_array_equal(pstate.memory.length.numpy(), np.asarray(jstate.memory.length))


def test_divergence_guard_skips_a_nan_batch():
    jtrainer, jstate, _ = _jax_side()
    ptrainer, pstate = _port_side(jstate)
    images, labels = _batch(3, LABELS["compact"])
    images[0, 0, 0, 0] = np.nan
    params = {k: v.clone() for k, v in pstate.model.state_dict().items()}
    proxies = pstate.proxies.detach().clone()
    gmm = [t.detach().clone() for t in pstate.gmm]
    bank = [t.clone() for t in pstate.memory]
    opt = str(pstate.opt.state_dict())

    jnew, jm = jtrainer.train_step(jstate, images, labels, use_mine=True, update_gmm=True)
    pstate, pm = ptrainer.train_step(pstate, images, labels, use_mine=True, update_gmm=True)
    assert bool(jm.nonfinite) and pm.nonfinite is True
    assert pm.em_active == int(jm.em_active) == 0
    assert pstate.step == int(jnew.step) == 1 and pstate.joint_updates == 0
    for k, v in pstate.model.state_dict().items():  # params and BN buffers
        assert torch.equal(v, params[k]), k
    assert torch.equal(pstate.proxies.detach(), proxies)
    for a, b in zip(pstate.gmm, gmm):
        assert torch.equal(a.detach(), b)
    for a, b in zip(pstate.memory, bank):
        assert torch.equal(a, b)
    assert str(pstate.opt.state_dict()) == opt
    np.testing.assert_array_equal(np.asarray(jnew.memory.feats), np.asarray(jstate.memory.feats))


def test_optimizer_groups_match_jax():
    """Both sides get the SAME gradients: one joint step moves features,
    add_on and proxies alike and leaves the embedding frozen; one warm step
    also leaves the features untouched; the staircase rates agree."""
    jtrainer, jstate, grad_fn = _jax_side()
    images, labels = _batch(4, LABELS["fallback"])
    jgrads, _ = grad_fn(jstate.params, jstate.batch_stats, jstate.gmm, images, labels,
                        jnp.float32(1.0))
    ref = _port_grads(jgrads, jstate)
    for warm in (False, True):
        tx = jtrainer.warm_tx if warm else jtrainer.joint_tx
        updates, _ = tx.update(jgrads, tx.init(jstate.params), jstate.params)
        jnew = jax.device_get(jax.tree_util.tree_map(lambda p, u: p + u, jstate.params, updates))
        ptrainer, pstate = _port_side(jstate)
        before = {k: v.detach().clone() for k, v in pstate.model.named_parameters()}
        for name, p in pstate.model.named_parameters():
            p.grad = torch.from_numpy(np.ascontiguousarray(ref[name]))
        pstate.proxies.grad = _t(jgrads["proxies"])
        if warm:
            pstate.warm_opt.step()
        else:
            set_joint_lrs(ptrainer.cfg, pstate, ptrainer.steps_per_epoch)
            pstate.opt.step()
        want = _port_grads({"net": jnew["net"]}, jstate)
        for name, p in pstate.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]), atol=1e-6,
                                       err_msg=name)
            frozen = name.startswith("embedding") or (warm and name.startswith("features"))
            assert torch.equal(p.detach(), before[name]) is frozen, name
        np.testing.assert_allclose(pstate.proxies.detach().numpy(),
                                   np.asarray(jnew["proxies"]), atol=1e-6)
    sched = staircase_schedule(1e-4, 7, (30, 45), 0.4, epoch_offset=5)
    for count in (0, 7 * 25 - 1, 7 * 25, 7 * 40, 7 * 41):
        np.testing.assert_allclose(staircase_lr(1e-4, count, 7, (30, 45), 0.4, 5),
                                   float(sched(jnp.asarray(count))), rtol=1e-6)


def test_losses_and_gradients_match_jax():
    rng = np.random.default_rng(5)
    b, c, t, e = 5, 4, 4, 8
    logits = rng.normal(size=(b, c, t)).astype(np.float32) * 3
    labels = np.array([0, 3, 1, 1, 2], np.int32)
    emb = rng.normal(size=(b, e)).astype(np.float32)
    proxies = rng.normal(size=(c, e)).astype(np.float32)

    def jtotal(lg, em, px):
        return (jl.cross_entropy(lg[..., 0], labels), jl.mine_loss(lg, labels),
                jl.proxy_anchor(em, labels, px))

    jvals = jtotal(logits, emb, proxies)
    jgrads = jax.grad(lambda *a: sum(jtotal(*a)), argnums=(0, 1, 2))(logits, emb, proxies)
    tlg, tem_, tpx = (_t(a).requires_grad_() for a in (logits, emb, proxies))
    lb = _t(labels)
    tvals = (tl.cross_entropy(tlg[..., 0], lb), tl.mine_loss(tlg, lb),
             tl.proxy_anchor(tem_, lb, tpx))
    sum(tvals).backward()
    for got, want in zip(tvals, jvals):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    for got, want in zip((tlg, tem_, tpx), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tl.mine_loss(tlg[..., :1], lb).item() == 0.0


def test_memory_push_bit_exact():
    """Three pushes: overflow beyond cap in one push, invalid rows,
    out-of-range classes, cursor wrap-around, and a push that keeps
    nothing."""
    c, cap, d = 5, 4, 3
    rng = np.random.default_rng(6)
    jm_, tm_ = jmem.init_memory(c, cap, d), tmem.init_memory(c, cap, d)
    pushes = [
        (np.array([1, 1, 1, 1, 1, 1, 0, -1, 5, 7, 2, 2]), np.array([1] * 9 + [0, 1, 1])),
        (np.array([1, 0, 4, 4, 2, 3, 3, 0]), np.array([1, 1, 1, 0, 1, 1, 1, 1])),
        (np.array([2, -3, 9, 1]), np.array([0, 1, 1, 0])),
    ]
    for classes, valid in pushes:
        feats = rng.normal(size=(len(classes), d)).astype(np.float32)
        jm_ = jmem.memory_push(jm_, jnp.asarray(feats), jnp.asarray(classes, jnp.int32),
                               jnp.asarray(valid, bool))
        tm_ = tmem.memory_push(tm_, _t(feats), _t(classes), _t(valid.astype(bool)))
        for name in ("feats", "length", "cursor", "updated"):
            np.testing.assert_array_equal(getattr(tm_, name).numpy(),
                                          np.asarray(getattr(jm_, name)), err_msg=name)
    assert int(tm_.length[1]) == cap and tm_.updated.any()


def _em_fixture(seed=7, c=6, n=32, k=3, d=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c, n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    gmm = dict(
        means=(rng.normal(size=(c, k, d)) * 0.3).astype(np.float32),
        sigmas=np.full((c, k, d), 0.4, np.float32),
        priors=(rng.uniform(0.5, 1.5, size=(c, k)) / k).astype(np.float32),
        keep=np.ones((c, k), bool),
    )
    length = np.full(c, n, np.int32)
    length[4] = n - 1  # updated but not full: inactive
    updated = np.array([1, 0, 1, 1, 1, 0], bool)  # active: 0, 2, 3
    return x, gmm, length, updated


@pytest.mark.parametrize("width", [0, 3, 2], ids=["dense", "compact", "fallback"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_em_update_matches_jax(width, fused):
    x, gmm, length, updated = _em_fixture()
    c, n, _ = x.shape
    jcfg = JaxEMConfig(max_active_classes=width, fused_estep=fused)
    jgmm = JaxGMMState(**{k: jnp.asarray(v) for k, v in gmm.items()})
    jmemory = jmem.Memory(jnp.asarray(x), jnp.asarray(length), jnp.zeros(c, jnp.int32),
                          jnp.asarray(updated))
    tx = jem.make_mean_optimizer(jcfg)
    jg, jmm, _, jaux = jax.jit(lambda g, m: jem.em_update(g, m, tx.init(g.means), tx, jcfg))(
        jgmm, jmemory)

    cfg = EMConfig(max_active_classes=width, fused_estep=fused)
    tgmm = GMMState(**{k: _t(v) for k, v in gmm.items()})
    opt = tem.make_mean_optimizer(tgmm.means, cfg)
    tmemory = tmem.Memory(_t(x), _t(length), torch.zeros(c, dtype=torch.int32), _t(updated))
    tg, tmm, aux = tem.em_update(tgmm, tmemory, opt, cfg)

    assert aux.num_active == int(jaux.num_active) == 3
    assert aux.compact_fallback == int(jaux.compact_fallback) == (width == 2)
    np.testing.assert_allclose(tg.priors.numpy(), np.asarray(jg.priors), atol=1e-5)
    np.testing.assert_allclose(float(aux.log_likelihood), float(jaux.log_likelihood), atol=1e-4)
    np.testing.assert_allclose(float(aux.loss), float(jaux.loss), rtol=1e-5)
    means = tg.means.detach().numpy()
    np.testing.assert_allclose(means, np.asarray(jg.means), atol=2 * 3 * cfg.mean_lr)
    inactive = ~(updated & (length == n))
    np.testing.assert_array_equal(means[inactive], gmm["means"][inactive])
    np.testing.assert_array_equal(tg.priors.numpy()[inactive], gmm["priors"][inactive])
    assert not tmm.updated.any() and not np.asarray(jmm.updated).any()


@pytest.mark.parametrize("fused", [False, True], ids=["resp", "stats"])
def test_m_step_objective_and_mean_gradient_match_jax(fused):
    """The first round's m-step objective and its gradient in the means,
    from the responsibilities or from the smoothed statistics."""
    x, gmm, length, updated = _em_fixture(seed=8)
    c, n, _ = x.shape
    k = gmm["means"].shape[1]
    alpha, lam = 0.1, 1.0
    active = (updated & (length == n)).astype(np.float32)
    _, log_resp = jax.vmap(jax_e_step)(x, gmm["means"], gmm["sigmas"], gmm["priors"])
    resp = jnp.exp(log_resp)
    resp = (resp + alpha) / jnp.sum(resp + alpha, axis=-1, keepdims=True)
    if fused:
        s, sx, sxx = (jnp.sum(resp, 1), jnp.einsum("cnk,cnd->ckd", resp, x),
                      jnp.einsum("cnk,cnd->ckd", resp, x * x))

        def jobj(m):
            return jem._m_step_objective_stats(m, s, sx, sxx, gmm["priors"], gmm["sigmas"],
                                               active, lam, n)
    else:
        def jobj(m):
            return jem._m_step_objective(m, x, resp, gmm["priors"], gmm["sigmas"], active, lam)
    jloss, jgrad = jax.value_and_grad(jobj)(jnp.asarray(gmm["means"]))

    tx, tmeans = _t(x), _t(gmm["means"]).requires_grad_()
    _, tlog_resp = e_step(tx, tmeans.detach(), _t(gmm["sigmas"]), _t(gmm["priors"]))
    tresp = torch.exp(tlog_resp)
    tresp = (tresp + alpha) / (tresp + alpha).sum(-1, keepdim=True)
    if fused:
        rt = tresp.transpose(1, 2)
        tloss = tem._m_step_objective_stats(
            tmeans, tresp.sum(1), rt @ tx, rt @ (tx * tx), _t(gmm["priors"]),
            _t(gmm["sigmas"]), _t(active), lam, n)
    else:
        tloss = tem._m_step_objective(tmeans, tx, tresp, _t(gmm["priors"]), _t(gmm["sigmas"]),
                                      _t(active), lam)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tmeans.grad.numpy(), jgrad, rtol=0,
                               atol=1e-5 * np.abs(jgrad).max())
    assert k == 3


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    """4 classes x 5 JPEGs of seeded smooth content at varying sizes."""
    root = tmp_path_factory.mktemp("train_imgs")
    rng = np.random.default_rng(0)
    for c in range(4):
        (root / f"c{c}").mkdir()
        for i in range(5):
            coarse = Image.fromarray(rng.integers(0, 256, size=(4, 5, 3), dtype=np.uint8))
            h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
            coarse.resize((w, h), Image.BILINEAR).save(root / f"c{c}" / f"{i}.jpg", quality=90)
    return str(root)


def test_loader_fed_epoch_with_device_augmentation_matches_jax(jpeg_tree):
    """Two steps of `train_epoch` from each package's loader over the same
    tree, the uint8 wire and the augmentation tail on, from one state (a
    full bank, so EM runs on both steps)."""
    batch = 8
    jcfg, tcfg = _configs()
    jcfg = jcfg.replace(data=JaxDataConfig(train_batch_size=batch, device_augment=True))
    tcfg = tcfg.replace(data=DataConfig(train_batch_size=batch, device_augment=True))
    jtrainer = JaxTrainer(jcfg, steps_per_epoch=2)
    jstate = jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0))
    m = jcfg.model
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(m.num_classes, m.mem_capacity, m.proto_dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    jstate = jstate.replace(memory=jmem.Memory(
        feats=jnp.asarray(feats), length=jnp.full(m.num_classes, m.mem_capacity, jnp.int32),
        cursor=jnp.zeros(m.num_classes, jnp.int32), updated=jnp.zeros(m.num_classes, bool)))
    ptrainer = Trainer(tcfg, steps_per_epoch=2, device="cpu")
    pstate = from_jax_train_state(jax.device_get(jstate), tcfg, device="cpu")
    assert ptrainer.device_augment

    kw = dict(shuffle=True, drop_last=True, seed=5, with_seeds=True, num_workers=0)
    jloader = JaxDataLoader(JaxImageFolder(jpeg_tree, JaxTrainTransform(32, True)), batch, **kw)
    ploader = DataLoader(ImageFolder(jpeg_tree, TrainTransform(32, True)), batch, **kw)
    # the JAX epoch takes (images, labels, seeds); the port's takes the
    # loader's (images, labels, ids, seeds) as they come
    jnew, jm = jtrainer.train_epoch(jstate, ((b[0], b[1], b[3]) for b in jloader), 0)
    pstate, pm = ptrainer.train_epoch(pstate, ploader, 0)

    assert len(ptrainer.step_log) == int(jnew.step) == pstate.step == 2
    assert all(r.image_bytes == batch * 32 * 32 * 3 for r in ptrainer.step_log)
    for name in ("loss", "cross_entropy", "mine", "aux", "accuracy", "full_mem_ratio"):
        np.testing.assert_allclose(float(getattr(pm, name)), float(getattr(jm, name)),
                                   atol=1e-4, err_msg=name)
    assert pm.em_active == int(jm.em_active) > 0
    assert pm.em_compact_fallback == int(jm.em_compact_fallback)
    jmem_new = jax.device_get(jnew.memory)
    for name in ("length", "cursor", "updated"):
        np.testing.assert_array_equal(getattr(pstate.memory, name).numpy(),
                                      np.asarray(getattr(jmem_new, name)), err_msg=name)
    assert not np.array_equal(np.asarray(jmem_new.feats), feats)  # the epoch enqueued
    np.testing.assert_allclose(pstate.memory.feats.numpy(), np.asarray(jmem_new.feats), atol=1e-5)
    np.testing.assert_allclose(pstate.gmm.priors.numpy(), np.asarray(jnew.gmm.priors), atol=1e-5)
    np.testing.assert_allclose(pstate.gmm.means.detach().numpy(), np.asarray(jnew.gmm.means),
                               atol=2 * 3 * 3e-3)


def test_put_batch_and_split_batch():
    """Batch intake on the CPU: uint8 stays uint8, seeds become the [B, 5]
    draws (zero seeds when none came), ids are dropped (a 3-tuple's third
    array is ids, whatever its dtype), uint8 without device augmentation is
    refused, and so are f32 images with it on."""
    from mgproto_tpu_torch.engine.train import split_batch
    from mgproto_tpu_torch.ops.augment import augment_draws

    _, tcfg = _configs()
    images = np.zeros((3, 32, 32, 3), np.uint8)
    labels = np.array([0, 1, 2], np.int32)
    ids = np.arange(3, dtype=np.int64)
    seeds = np.array([5, 6, 7], np.uint32)
    assert split_batch((images, labels))[2] is None
    assert split_batch((images, labels, ids))[2] is None
    assert split_batch((images, labels, seeds))[2] is None
    assert split_batch((images, labels, ids, seeds))[2] is seeds
    with pytest.raises(ValueError):
        split_batch((images,))

    on = Trainer(tcfg.replace(data=DataConfig(device_augment=True)), 1, device="cpu")
    b = on.put_batch((images, labels, ids, seeds))
    assert b.images.dtype == torch.uint8 and b.labels.dtype == torch.int64
    np.testing.assert_array_equal(b.draws.numpy(), augment_draws(seeds))
    assert b.image_bytes == images.nbytes and b.ready is None and b.copy_ms() is None
    zero = on.put_batch((images, labels))
    np.testing.assert_array_equal(zero.draws.numpy(), augment_draws(np.zeros(3, np.uint32)))

    off = Trainer(tcfg, 1, device="cpu")
    assert not off.device_augment and off.put_batch((images, labels)).draws is None
    state = off.init_state(0)
    with pytest.raises(ValueError, match="uint8 images with device augmentation off"):
        off.train_step(state, images, labels, use_mine=True, update_gmm=False)
    normalized = np.zeros(images.shape, np.float32)
    with pytest.raises(ValueError, match="float32 images with device augmentation on"):
        on.train_step(on.init_state(0), normalized, labels, use_mine=True, update_gmm=False,
                      seeds=seeds)
