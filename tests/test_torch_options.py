"""The training options beside mixed precision, against the JAX package on
the CPU: the six aux losses, remat, reference-exact EM stepping, a JAX state without proxies, and the adoption of a checkpoint's
training settings (`adopt_checkpoint_train_config`, `run_interpret`).

Tolerances:
  * aux losses and their gradients (embeddings and proxies): rtol 1e-5
    (atol 1e-6 where the value is ~0): the same f32 ops in the same order
    on both sides.
  * remat against no remat, from one seeded state on the same batch: the
    BatchNorm running statistics bit-equal (one update a step) and every
    gradient bit-equal (the recomputed forward runs the same CPU kernels on
    the same inputs), in f32 and in bf16.
  * reference stepping against JAX's `_reference_em_update`: priors atol
    1e-6, the objective and log-likelihood rtol 1e-5, Adam counts exact,
    the means and Adam moments atol 1e-6: every class sees its own
    gradient computed from the same f32 bank, and the drifting classes
    see only moment decay (no near-zero gradient for Adam to amplify).
  * steps carried across from a JAX state (with and without proxies):
    the step's losses atol 1e-4 and gradients 1e-4 relative norm, as in
    tests/test_torch_train.py; the parameters after the step within 2 lr of
    JAX's (Adam's first steps turn a near-zero gradient into +-lr).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_states import full_bank, write_jpeg_tree
from mgproto_tpu.config import EMConfig as JaxEMConfig
from mgproto_tpu.config import LossConfig as JaxLossConfig
from mgproto_tpu.config import OptimConfig as JaxOptimConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.core import em as jem
from mgproto_tpu.core import losses as jl
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.utils.checkpoint import adopt_checkpoint_train_config as jax_adopt
from mgproto_tpu_torch.cli import train as ttrain
from mgproto_tpu_torch.config import (
    DataConfig,
    EMConfig,
    LossConfig,
    tiny_test_config,
)
from mgproto_tpu_torch.core import em as tem
from mgproto_tpu_torch.core import losses as tl
from mgproto_tpu_torch.core.memory import Memory
from mgproto_tpu_torch.core.mgproto import GMMState, MGProtoFeatures
from mgproto_tpu_torch.core.state import create_train_state
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models.common import BatchNorm
from mgproto_tpu_torch.models.convert import from_jax_train_state, from_jax_variables
from mgproto_tpu_torch.utils import checkpoint as tck

B = 6
AUX = ("proxy_anchor", "proxy_nca", "ms", "contrastive", "triplet", "npair")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------- aux losses
@pytest.mark.parametrize("name", AUX)
def test_aux_loss_and_gradients_match_jax(name):
    rng = np.random.default_rng(AUX.index(name))
    b, c, e = 8, 4, 8
    emb = rng.normal(size=(b, e)).astype(np.float32)
    if name in ("contrastive", "triplet"):
        emb *= 0.1  # distances around the margins, so both terms are live
    labels = np.array([0, 1, 0, 2, 1, 3, 0, 2], np.int32)
    proxies = rng.normal(size=(c, e)).astype(np.float32)
    proxy = name in tl.PROXY_BASED
    assert proxy == (name in jl.PROXY_BASED)

    def jfn(x, p):
        return jl.AUX_LOSSES[name](x, labels, p) if proxy else jl.AUX_LOSSES[name](x, labels)

    jval, (jgx, jgp) = jax.value_and_grad(jfn, argnums=(0, 1))(emb, proxies)
    x, p = _t(emb).requires_grad_(True), _t(proxies).requires_grad_(True)
    val = tl.aux_loss(name, x, _t(labels), p if proxy else None)
    val.backward()
    assert float(jval) != 0.0
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-6)
    if proxy:
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp), rtol=1e-5, atol=1e-6)
    else:
        assert p.grad is None


def test_unknown_aux_loss_refused():
    cfg = tiny_test_config().replace(loss=LossConfig(aux_loss="arcface"))
    with pytest.raises(ValueError, match="unknown aux_loss"):
        create_train_state(cfg, torch.Generator(), "cpu")


@pytest.mark.parametrize("name", AUX)
def test_proxies_exist_only_for_proxy_losses(name):
    cfg = tiny_test_config().replace(loss=LossConfig(aux_loss=name))
    trainer = Trainer(cfg, 4, device="cpu")
    state = trainer.init_state(0)
    proxy = name in tl.PROXY_BASED
    assert (state.proxies is not None) == proxy
    groups = len(state.opt.param_groups)
    assert groups == (3 if proxy else 2) and len(state.warm_opt.param_groups) == groups - 1
    rng = np.random.default_rng(1)
    images = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
    state, m = trainer.train_step(state, images, np.array([0, 1, 0, 2, 1, 3]),
                                  use_mine=True, update_gmm=True)
    assert np.isfinite(float(m.loss)) and np.isfinite(float(m.aux)) and not m.nonfinite


# ------------------------------------------------------- JAX states carried
def _jax_cfg(aux, reference_stepping=False):
    jcfg = jax_tiny_config()
    return jcfg.replace(
        em=JaxEMConfig(async_bank=False, reference_stepping=reference_stepping),
        loss=JaxLossConfig(aux_loss=aux),
    )


def _port_cfg(aux, reference_stepping=False):
    return tiny_test_config().replace(
        em=EMConfig(reference_stepping=reference_stepping),
        loss=LossConfig(aux_loss=aux),
    )


def _images(seed):
    return np.random.default_rng(seed).normal(size=(B, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("aux,reference_stepping", [
    ("ms", False), ("npair", False), ("proxy_nca", False), ("proxy_anchor", True),
])
def test_step_from_a_carried_jax_state_matches_jax(aux, reference_stepping):
    """A JAX state trained two steps (with its optimizer state: no proxies
    for a pair loss) carried across, then one more step on both sides. The
    embedding stays frozen on both."""
    jcfg = _jax_cfg(aux, reference_stepping)
    jtrainer = JaxTrainer(jcfg, steps_per_epoch=4)
    jstate = jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0))
    jstate = jstate.replace(memory=full_bank(jcfg.model, 1))
    labels = np.array([0, 1, 2, 3, 1, 0], np.int32)
    for i in range(2):
        jstate, _ = jtrainer.train_step(jstate, _images(10 + i), np.roll(labels, i),
                                        use_mine=True, update_gmm=True)
    assert ("proxies" in jstate.params) == (aux in jl.PROXY_BASED)
    tcfg = _port_cfg(aux, reference_stepping)
    ptrainer = Trainer(tcfg, steps_per_epoch=4, device="cpu")
    pstate = from_jax_train_state(jax.device_get(jstate), tcfg, device="cpu")
    assert (pstate.proxies is None) == (aux not in tl.PROXY_BASED)
    emb = pstate.model.embedding.weight
    assert emb not in pstate.opt.state

    images = _images(20)
    grad_fn = jax.jit(jax.grad(jtrainer._loss_fn, has_aux=True))
    jgrads, _ = grad_fn(jstate.params, jstate.batch_stats, jstate.gmm, images, labels,
                        jnp.float32(1.0))
    jnew, jm = jtrainer.train_step(jstate, images, labels, use_mine=True, update_gmm=True)
    emb0 = emb.detach().clone()
    pstate, pm = ptrainer.train_step(pstate, images, labels, use_mine=True, update_gmm=True)
    for name in ("loss", "cross_entropy", "mine", "aux", "accuracy"):
        np.testing.assert_allclose(float(getattr(pm, name)), float(getattr(jm, name)),
                                   atol=1e-4, err_msg=name)
    assert pm.em_active == int(jm.em_active)
    sd, _ = from_jax_variables({"params": jgrads["net"]}, jax.device_get(jstate.gmm))
    for name, p in pstate.model.named_parameters():
        assert _rel(p.grad.numpy(), np.asarray(sd[name])) <= 1e-4, name
    new_sd, _ = from_jax_variables({"params": jax.device_get(jnew.params)["net"]},
                                   jax.device_get(jnew.gmm))
    lr_tol = 2 * max(tcfg.optim.features_lr, tcfg.optim.add_on_lr)
    for name, p in pstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(new_sd[name]), atol=lr_tol,
                                   err_msg=name)
    assert torch.equal(emb.detach(), emb0)
    np.testing.assert_allclose(pstate.gmm.priors.numpy(), np.asarray(jnew.gmm.priors),
                               atol=1e-5)


def test_carrying_a_state_into_a_config_of_another_aux_loss_is_refused():
    jcfg = _jax_cfg("ms")
    jtrainer = JaxTrainer(jcfg, steps_per_epoch=4)
    jstate = jax.device_get(jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="has no proxies"):
        from_jax_train_state(jstate, _port_cfg("proxy_anchor"), device="cpu")


def test_carrying_a_state_that_trains_the_embedding_is_refused():
    """The port keeps the embedding frozen (the JAX default); a JAX state
    trained with `train_embedding` holds moments the port cannot place."""
    jcfg = _jax_cfg("proxy_anchor").replace(optim=JaxOptimConfig(train_embedding=True))
    jtrainer = JaxTrainer(jcfg, steps_per_epoch=4)
    jstate = jax.device_get(jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="embedding"):
        from_jax_train_state(jstate, _port_cfg("proxy_anchor"), device="cpu")


# -------------------------------------------------------------------- remat
REMAT = {"full": {"remat": True}, "layer3": {"remat_stages": ("layer3",)},
         "layer1_layer4": {"remat_stages": ("layer1", "layer4")},
         "full_bf16": {"remat": True, "compute_dtype": "bfloat16"}}


@pytest.mark.parametrize("case", sorted(REMAT))
def test_remat_matches_no_remat_bit_for_bit(case):
    kw = dict(REMAT[case])
    dtype = kw.pop("compute_dtype", "float32")
    base = tiny_test_config(arch="resnet18")
    cfgs = [base.replace(model=dataclasses.replace(base.model, compute_dtype=dtype, **extra))
            for extra in ({}, kw)]
    images, labels = _images(3), np.array([0, 1, 2, 3, 1, 0])
    runs = []
    for cfg in cfgs:
        trainer = Trainer(cfg, 4, device="cpu")
        state = trainer.init_state(0)
        remat_blocks = [m for m in state.model.modules() if getattr(m, "remat", False)]
        state, m = trainer.train_step(state, images, labels, use_mine=True, update_gmm=False)
        stats = {n: t.clone() for n, t in state.model.state_dict().items() if "running" in n}
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        runs.append((m, stats, grads, len(remat_blocks)))
    (m0, s0, g0, n0), (m1, s1, g1, n1) = runs
    assert n0 == 0 and n1 == {"full": 8, "layer3": 2, "layer1_layer4": 4, "full_bf16": 8}[case]
    assert m0.loss.item() == m1.loss.item()
    for n in s0:
        assert torch.equal(s0[n], s1[n]), n
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_remat_refuses_unknown_stages_and_non_resnet_trunks():
    base = tiny_test_config(arch="resnet18")
    bad = base.replace(model=dataclasses.replace(base.model, remat_stages=("layer5",)))
    with pytest.raises(ValueError, match="unknown remat_stages"):
        MGProtoFeatures(bad.model)
    # remat wins over the stage list, as in JAX (the list is not read)
    MGProtoFeatures(dataclasses.replace(bad.model, remat=True))
    tiny = tiny_test_config()
    with pytest.raises(ValueError, match="resnet/densenet blocks only"):
        MGProtoFeatures(dataclasses.replace(tiny.model, remat=True))
    # the JAX package refuses the same two configs
    from mgproto_tpu.core.mgproto import MGProtoFeatures as JaxFeatures

    jbase = jax_tiny_config(arch="resnet18")
    x = jnp.zeros((1, 32, 32, 3))
    for model_cfg, match in ((dataclasses.replace(jbase.model, remat_stages=("layer5",)),
                              "unknown remat_stages"),
                             (dataclasses.replace(jax_tiny_config().model, remat=True),
                              "resnet/densenet blocks only")):
        with pytest.raises(ValueError, match=match):
            JaxFeatures(cfg=model_cfg).init(jax.random.PRNGKey(0), x)


def test_remat_updates_running_statistics_once_per_forward():
    base = tiny_test_config(arch="resnet18")
    cfg = base.replace(model=dataclasses.replace(base.model, remat=True))
    state = Trainer(cfg, 4, device="cpu").init_state(0)
    bns = [m for m in state.model.modules() if isinstance(m, BatchNorm)]
    assert all(m.update_stats for m in bns)
    proto, embed = state.model(torch.from_numpy(_images(4)))
    after_fwd = [m.running_mean.clone() for m in bns]
    (proto.sum() + embed.sum()).backward()  # recomputes every block
    assert all(torch.equal(m.running_mean, a) for m, a in zip(bns, after_fwd))
    assert all(m.update_stats for m in bns)


# ------------------------------------------------------ reference stepping
def _em_inputs(seed=0):
    """A tiny GMM and a full bank with classes 0, 2 and 3 marked updated."""
    rng = np.random.default_rng(seed)
    c, k, d, n = 4, 3, 8, 16
    means = rng.normal(size=(c, k, d)).astype(np.float32)
    means /= np.linalg.norm(means, axis=-1, keepdims=True)
    sigmas = np.full((c, k, d), 0.4, np.float32)
    priors = rng.dirichlet(np.ones(k), size=c).astype(np.float32)
    feats = rng.normal(size=(c, n, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    updated = np.array([True, False, True, True])
    return means, sigmas, priors, feats, updated


def test_reference_em_update_matches_jax():
    from mgproto_tpu.core.memory import Memory as JaxMemory
    from mgproto_tpu.core.mgproto import GMMState as JaxGMMState

    means, sigmas, priors, feats, updated = _em_inputs()
    c, n = feats.shape[:2]
    length = np.full(c, n, np.int32)
    jcfg = JaxEMConfig(reference_stepping=True, async_bank=False)
    tx = jem.make_mean_optimizer(jcfg)
    jgmm = JaxGMMState(jnp.asarray(means), jnp.asarray(sigmas), jnp.asarray(priors),
                       jnp.ones(priors.shape, bool))
    jmemory = JaxMemory(jnp.asarray(feats), jnp.asarray(length), jnp.zeros(c, jnp.int32),
                        jnp.asarray(updated))
    opt_state = tx.init(jgmm.means)
    # two calls, so the second starts from moments the first left in every class
    for _ in range(2):
        jgmm, jmemory, opt_state, jaux = jem.em_update(jgmm, jmemory, opt_state, tx, jcfg)
        jmemory = jmemory._replace(updated=jnp.asarray(updated))

    cfg = EMConfig(reference_stepping=True)
    gmm = GMMState(_t(means), _t(sigmas), _t(priors), torch.ones(priors.shape, dtype=torch.bool))
    opt = tem.make_mean_optimizer(gmm.means, cfg)
    memory = Memory(_t(feats), _t(length), torch.zeros(c, dtype=torch.int32), _t(updated))
    for _ in range(2):
        gmm, memory, aux = tem.em_update(gmm, memory, opt, cfg)
        assert not memory.updated.any() and aux.num_active == 3 and aux.compact_fallback == 0
        memory = memory._replace(updated=_t(updated))
    np.testing.assert_allclose(gmm.priors.numpy(), np.asarray(jgmm.priors), atol=1e-6)
    np.testing.assert_allclose(gmm.means.detach().numpy(), np.asarray(jgmm.means), atol=1e-6)
    np.testing.assert_allclose(aux.loss.item(), float(jaux.loss), rtol=1e-5)
    np.testing.assert_allclose(aux.log_likelihood.item(), float(jaux.log_likelihood), rtol=1e-5)
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    st = opt.state[gmm.means]
    assert int(st["step"]) == int(adam.count) == 2 * 3 * cfg.num_em_loop
    np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam.mu), atol=1e-6)
    np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu), atol=1e-6)
    # class 1 never had a gradient, so its moments are zero and it stays put;
    # classes 0 and 2 drift under the later classes' steps (held above)
    np.testing.assert_array_equal(gmm.means.detach().numpy()[1], means[1])


# ----------------------------------------------------- adopting a config
@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_jpeg_tree(str(tmp_path_factory.mktemp("options") / "train"), 4, 3, seed=0)


def _schedule_cfg(folder, model_dir, **sections):
    cfg = tiny_test_config().replace(
        data=DataConfig(train_dir=folder, test_dir=folder, train_push_dir=folder,
                        train_batch_size=B, test_batch_size=B, train_push_batch_size=B,
                        num_workers=0),
        model_dir=str(model_dir))
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                          for k, v in sections.items()})


SETTINGS = {
    "compute_dtype": ("model", {"compute_dtype": "bfloat16"}),
    "aux_loss": ("loss", {"aux_loss": "ms"}),
    "em_reference_stepping": ("em", {"reference_stepping": True}),
}


@pytest.mark.parametrize("key", sorted(SETTINGS))
def test_adopt_checkpoint_train_config_from_run_training(folder, tmp_path, key):
    section, fields = SETTINGS[key]
    cfg = _schedule_cfg(folder, tmp_path, **{section: fields})
    state, _ = ttrain.run_training(cfg, device="cpu", render_push=False)
    path = tck.latest_checkpoint(cfg.model_dir)
    meta = tck.load_metadata(path)
    assert meta[key] == next(iter(fields.values()))
    assert meta["precision_policy"]["compute_dtype"] == cfg.model.compute_dtype
    plain = _schedule_cfg(folder, tmp_path)
    notes = []
    adopted = tck.adopt_checkpoint_train_config(plain, path, log=notes.append)
    assert getattr(getattr(adopted, section), next(iter(fields))) == meta[key]
    assert len(notes) == 1 and key.split("_")[-1] in notes[0]
    # the JAX package's function reads the same metadata the same way
    jadopted = jax_adopt(jax_tiny_config(), path)
    assert getattr(getattr(jadopted, section), next(iter(fields))) == meta[key]
    restored = tck.restore_checkpoint(path, Trainer(adopted, 1, device="cpu").init_state(0))
    assert restored.step == state.step
    if key == "aux_loss":  # built without adoption, the restore target has proxies
        with pytest.raises(tck.CheckpointIntegrityError):
            tck.restore_checkpoint(path, Trainer(plain, 1, device="cpu").init_state(0))


def test_adopt_keeps_the_callers_settings_for_a_checkpoint_without_them(tmp_path):
    cfg = tiny_test_config()
    bf = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
                     loss=LossConfig(aux_loss="npair"), em=EMConfig(reference_stepping=True))
    state = Trainer(bf, 1, device="cpu").init_state(0)
    path = tck.save_checkpoint(str(tmp_path), state, "0nopush0.5000",
                               metadata={"epoch": 0, "stage": "nopush"})
    notes = []
    assert tck.adopt_checkpoint_train_config(bf, path, log=notes.append) == bf
    assert notes == []
    assert tck.adopt_checkpoint_train_config(cfg, path) == cfg


def test_run_interpret_adopts_the_checkpoints_settings(folder, tmp_path):
    """A checkpoint of a pair-loss bf16 run restores under a default config:
    run_interpret adopts before building its restore target."""
    from test_torch_interpretability import _write_layout

    from mgproto_tpu_torch.cli.interpret import run_interpret

    cfg = _schedule_cfg(folder, tmp_path / "run", model={"compute_dtype": "bfloat16"},
                        loss={"aux_loss": "contrastive"})
    state = Trainer(cfg, 1, device="cpu").init_state(0)
    tck.save_checkpoint(cfg.model_dir, state, "1push0.5000",
                        metadata={"epoch": 1, "stage": "push", "compute_dtype": "bfloat16",
                                  "aux_loss": "contrastive", "em_reference_stepping": False})
    root = _write_layout(str(tmp_path / "cub"), 4, 2, ("beak", "tail", "crown"), 0, [(64, 48)])
    plain = tiny_test_config().replace(model_dir=cfg.model_dir,
                                       data=DataConfig(test_batch_size=B, num_workers=0))
    out = run_interpret(plain, root, metric="consistency", half_size=12, device="cpu")
    assert out["images"] == 8 and 0.0 <= out["consistency"] <= 100.0
