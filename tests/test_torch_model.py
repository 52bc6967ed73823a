"""The port's model against the JAX package's, weights carried across.

A JAX `Trainer` (fused_scoring and fused_epilogue forced on, so its Pallas
kernels run in interpret mode) is initialized, its BatchNorm statistics and
affine parameters are redrawn with numpy (so eval-mode BN is not the
identity), and `from_jax_variables` carries the variables and the GMM into
the port, which runs on the CPU.

Tolerances: proto map and embedding atol 1e-4; logits and log p(x)
atol 1e-3, rtol 1e-4 — XLA's and ATen's CPU convolutions sum in different
orders through the trunk, and the density amplifies a feature error by up
to |mu - x| / sigma^2. In train mode (batch statistics, the epilogue's
recomputed backward): losses atol 1e-4, new running statistics atol 1e-5,
trunk gradients relative norm 1e-4 per parameter tensor.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.engine.train import Trainer
from mgproto_tpu_torch.config import Config, ModelConfig
from mgproto_tpu_torch.core.mgproto import GMMState, MGProtoFeatures
from mgproto_tpu_torch.engine.eval import Evaluator
from mgproto_tpu_torch.engine.train import Trainer as PortTrainer
from mgproto_tpu_torch.models.convert import from_jax_train_state, from_jax_variables


def _perturbed_state(trainer, state, seed=0):
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = getattr(path[-1], "key", None)
        if name == "mean":
            return rng.normal(scale=0.1, size=leaf.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, size=leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    net = jax.tree_util.tree_map_with_path(redraw, jax.device_get(state.params["net"]))
    stats = jax.tree_util.tree_map_with_path(redraw, jax.device_get(state.batch_stats))
    priors = rng.uniform(0.05, 1.0, size=state.gmm.priors.shape).astype(np.float32)
    priors[0, 0] = 0.0  # a pruned slot: -inf log prior
    gmm = state.gmm._replace(priors=jax.numpy.asarray(priors))
    return state.replace(params={**state.params, "net": net}, batch_stats=stats, gmm=gmm)


@functools.lru_cache(maxsize=None)
def _both_sides(arch):
    jcfg = jax_tiny_config(arch=arch)
    jcfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, fused_scoring=True, fused_epilogue=arch != "tiny",
    ))
    trainer = Trainer(jcfg, steps_per_epoch=1)
    state = _perturbed_state(trainer, trainer.init_state(jax.random.PRNGKey(0)))
    m = jcfg.model
    tcfg = Config(model=ModelConfig(
        arch=arch, img_size=m.img_size, num_classes=m.num_classes,
        prototypes_per_class=m.prototypes_per_class, proto_dim=m.proto_dim,
        sz_embedding=m.sz_embedding, mine_T=m.mine_T,
        fused_scoring=True, fused_epilogue=arch != "tiny",
    ))
    sd, gmm = from_jax_variables(
        {"params": state.params["net"], "batch_stats": state.batch_stats},
        jax.device_get(state.gmm),
    )
    model = MGProtoFeatures(tcfg.model, fused_epilogue=tcfg.model.fused_epilogue)
    model.load_state_dict(sd, strict=True)
    return trainer, state, tcfg, model, gmm


@pytest.mark.parametrize("arch", ["tiny", "resnet18"])
def test_port_matches_jax_eval(arch):
    trainer, state, tcfg, model, gmm = _both_sides(arch)
    images = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)

    (pm_j, emb_j), _ = trainer._apply(state.params, state.batch_stats, images, train=False)
    ev = Evaluator(model, gmm, tcfg, device="cpu")
    with torch.inference_mode():
        pm_t, emb_t = ev.model(torch.from_numpy(images))
    np.testing.assert_allclose(pm_t.numpy(), np.asarray(pm_j), atol=1e-4)
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=1e-4)

    out_j = trainer._eval(state, images, None)
    out_t = ev(images)
    assert np.isneginf(np.asarray(out_j.logits)).sum() == 0
    np.testing.assert_allclose(out_t.logits.numpy(), np.asarray(out_j.logits),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out_t.log_px.numpy(), np.asarray(out_j.log_px),
                               rtol=1e-4, atol=1e-3)
    assert isinstance(ev.gmm, GMMState)


@pytest.mark.parametrize("arch", ["resnet18"])
def test_port_matches_jax_train_mode(arch):
    """One training step's losses, trunk gradients (through the BN epilogue's
    recomputed backward and the score_pool backward) and new BatchNorm
    running statistics, both sides in train mode."""
    trainer, state, tcfg, _, _ = _both_sides(arch)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    labels = np.array([1, 3, 1], np.int32)
    grad_fn = jax.jit(jax.grad(trainer._loss_fn, has_aux=True))
    grads, (new_stats, _, ce, mine, aux, _) = grad_fn(
        state.params, state.batch_stats, state.gmm, images, labels, jax.numpy.float32(1))

    pt = PortTrainer(tcfg, steps_per_epoch=1, device="cpu")
    ps = from_jax_train_state(jax.device_get(state), tcfg, device="cpu")
    ps, m = pt.train_step(ps, images, labels, use_mine=True, update_gmm=False)
    assert not m.nonfinite
    for got, want in ((m.cross_entropy, ce), (m.mine, mine), (m.aux, aux)):
        np.testing.assert_allclose(got.item(), float(want), atol=1e-4)
    ref, _ = from_jax_variables({"params": grads["net"], "batch_stats": new_stats},
                                jax.device_get(state.gmm))
    sd = ps.model.state_dict()
    for name, p in ps.model.named_parameters():
        want = np.asarray(ref[name])
        err = np.linalg.norm(p.grad.numpy() - want) / np.linalg.norm(want)
        assert err <= 1e-4, (name, err)
    for key in ref:
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), np.asarray(ref[key]), atol=1e-5,
                                       err_msg=key)


def test_converter_maps_torchvision_names():
    _, _, _, model, _ = _both_sides("resnet18")
    keys = set(model.state_dict())
    assert "features.layer1.0.conv1.weight" in keys
    assert "features.layer2.0.downsample.0.weight" in keys
    assert "features.layer2.0.downsample.1.running_var" in keys
    assert "features.layer4.1.bn2.running_mean" in keys
    assert model.features.layer1[0].conv1.weight.shape == (64, 64, 3, 3)
    assert model.embedding.weight.shape == (8, 512)


def test_unfused_head_matches_fused_head():
    """fused_scoring=False (density matrix + stable sort) and True (the
    score_pool wrapper) give the same logits on the CPU."""
    _, _, tcfg, model, gmm = _both_sides("tiny")
    images = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    fused = Evaluator(model, gmm, tcfg, device="cpu")(images)
    plain_cfg = Config(model=dataclasses.replace(tcfg.model, fused_scoring=False))
    plain = Evaluator(model, gmm, plain_cfg, device="cpu")(images)
    torch.testing.assert_close(fused.logits, plain.logits, rtol=0, atol=1e-5)


@pytest.mark.parametrize("stride,fused", [(1, False), (2, True)])
def test_bottleneck_block_matches_jax(stride, fused):
    """The Bottleneck block (ResNet-50 and up), with and without the fused
    tail and the downsample branch, carried across as one module."""
    from mgproto_tpu.models.resnet import Bottleneck as JaxBottleneck
    from mgproto_tpu_torch.models.resnet import Bottleneck

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    jblock = JaxBottleneck(planes=16, stride=stride, has_downsample=True, fused_epilogue=fused)
    variables = jblock.init(jax.random.PRNGKey(1), x, train=False)
    variables = {
        "params": jax.tree_util.tree_map(
            lambda v: rng.normal(scale=0.3, size=v.shape).astype(np.float32) + (v == 1),
            jax.device_get(variables["params"])),
        "batch_stats": jax.tree_util.tree_map(
            lambda v: rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32),
            jax.device_get(variables["batch_stats"])),
    }
    ref = np.asarray(jblock.apply(variables, x, train=False))
    sd, _ = from_jax_variables(variables, GMMState(*(np.zeros(1),) * 4))
    block = Bottleneck(32, 16, stride, downsample=True, fused_epilogue=fused)
    block.load_state_dict(sd, strict=True)
    block = block.eval().to(memory_format=torch.channels_last)
    with torch.inference_mode():
        out = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=1e-4)


def test_bottleneck_add_on_and_labelled_head_match_jax():
    """AddOnLayers('bottleneck') and head_forward with labels (mine mask,
    enqueue candidates with first-occurrence dedup) against the JAX head."""
    from mgproto_tpu.core import mgproto as jm
    from mgproto_tpu_torch.core import mgproto as tm

    rng = np.random.default_rng(4)
    feats = rng.normal(size=(2, 5, 5, 64)).astype(np.float32)
    jadd = jm.AddOnLayers(proto_dim=8, add_on_type="bottleneck", in_channels=64)
    variables = jax.device_get(jadd.init(jax.random.PRNGKey(2), feats))
    ref = np.asarray(jadd.apply(variables, feats))
    sd, _ = from_jax_variables(variables, GMMState(*(np.zeros(1),) * 4))
    tadd = tm.AddOnLayers(8, "bottleneck", 64)
    tadd.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        out = tadd(torch.from_numpy(feats).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)

    c, k, d, t = 4, 3, 8, 4
    means = rng.normal(size=(c, k, d)).astype(np.float32)
    means /= np.linalg.norm(means, axis=-1, keepdims=True)
    gmm_np = dict(means=means, sigmas=np.full((c, k, d), 0.4, np.float32),
                  priors=rng.uniform(0.1, 1, size=(c, k)).astype(np.float32),
                  keep=np.ones((c, k), bool))
    gmm_np["priors"][1, 2] = 0.0
    # twin prototypes peak at one patch: dedup has a duplicate to drop
    gmm_np["means"][1, 1] = gmm_np["means"][1, 0]
    labels = np.array([1, 3], np.int32)
    pm = np.array(ref)
    jl, jp, (jf, jc, jv) = jm.head_forward(pm, jm.GMMState(**gmm_np), labels, t)
    tgmm = tm.GMMState(**{n: torch.from_numpy(v) for n, v in gmm_np.items()})
    tl, tp, (tf, tc, tv) = tm.head_forward(torch.from_numpy(pm), tgmm, torch.from_numpy(labels), t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(tp.top1_idx.numpy(), np.asarray(jp.top1_idx))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tv.all()
