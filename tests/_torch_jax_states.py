"""Shared set-up of the tests that hold the port's evaluation, push,
checkpoint and schedule modules against the JAX package's: a tiny JAX
trainer (the score_pool and E-step Pallas kernels forced on, so they run in
interpret mode), a JAX state trained a few steps from a full seeded bank,
the same state carried into the port, seeded image batches, a seeded JPEG
tree, the near-tie allowance for decisions taken on scores, and two small
DenseNets registered in both packages' registries (`small_densenets`)."""

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from PIL import Image

from mgproto_tpu.config import EMConfig as JaxEMConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.core import memory as jmem
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.models import densenet as jdensenet
from mgproto_tpu.models import registry as jregistry
from mgproto_tpu_torch.config import EMConfig, tiny_test_config
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models import densenet as tdensenet
from mgproto_tpu_torch.models import registry as tregistry
from mgproto_tpu_torch.models.convert import from_jax_train_state

B = 6
IMG = 32
# two scores closer than this may order either way between the packages
# (XLA's and ATen's CPU convolutions sum in different orders)
NEAR = 1e-4


def configs():
    jcfg = jax_tiny_config()
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, fused_scoring=True),
        em=JaxEMConfig(fused_estep=True, async_bank=False),
    )
    tcfg = tiny_test_config()
    tcfg = tcfg.replace(
        model=dataclasses.replace(tcfg.model, fused_scoring=True),
        em=EMConfig(fused_estep=True),
    )
    return jcfg, tcfg


def images(seed, n=B):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3)).astype(np.float32)


def full_bank(m, seed):
    """Every class queue full of seeded unit vectors, nothing marked updated."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(m.num_classes, m.mem_capacity, m.proto_dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    return jmem.Memory(
        feats=jnp.asarray(feats), length=jnp.full(m.num_classes, m.mem_capacity, jnp.int32),
        cursor=jnp.asarray(rng.integers(0, m.mem_capacity, m.num_classes).astype(np.int32)),
        updated=jnp.zeros(m.num_classes, bool),
    )


def trained_jax_state(steps=3, steps_per_epoch=4, jcfg=None):
    """(JAX trainer, its state after `steps` joint steps with mining and EM
    from a full bank). Every step's batch is seeded."""
    jcfg = jcfg or configs()[0]
    trainer = JaxTrainer(jcfg, steps_per_epoch=steps_per_epoch)
    state = jax.jit(trainer.init_state)(jax.random.PRNGKey(0))
    state = state.replace(memory=full_bank(jcfg.model, 1))
    rng = np.random.default_rng(2)
    for i in range(steps):
        labels = rng.integers(0, jcfg.model.num_classes, size=B).astype(np.int32)
        state, _ = trainer.train_step(state, images(10 + i), labels, use_mine=True,
                                      update_gmm=True)
    return trainer, state


def port_state(jstate, tcfg=None, steps_per_epoch=4):
    tcfg = tcfg or configs()[1]
    return (Trainer(tcfg, steps_per_epoch=steps_per_epoch, device="cpu"),
            from_jax_train_state(jax.device_get(jstate), tcfg, device="cpu"))


def write_jpeg_tree(root, classes, per_class, seed, hw=(40, 48)):
    """`classes` folders of `per_class` JPEGs of seeded smooth content."""
    rng = np.random.default_rng(seed)
    for c in range(classes):
        os.makedirs(os.path.join(root, f"c{c}"), exist_ok=True)
        for i in range(per_class):
            coarse = Image.fromarray(rng.integers(0, 256, size=(4, 5, 3), dtype=np.uint8))
            coarse.resize((hw[1], hw[0]), Image.BILINEAR).save(
                os.path.join(root, f"c{c}", f"{i}.jpg"), quality=90)
    return root


def near_pairs(a, b):
    """How many (a_i, b_j) pairs lie within NEAR of each other."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return int((np.abs(a[:, None] - b[None, :]) <= NEAR).sum())


def auroc_allowance(id_scores, ood_scores):
    """An AUROC may differ by one pair's weight per near-tie (id, ood) pair."""
    return near_pairs(id_scores, ood_scores) / max(len(id_scores) * len(ood_scores), 1)


# DenseNetFeatures' own width and depth arguments, which both packages take:
# four blocks of two layers, and two blocks of one
SMALL_DENSENETS = {
    "densenet_small": dict(growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16),
    "densenet_mini": dict(growth_rate=8, block_config=(1, 1), num_init_features=8),
}


@contextlib.contextmanager
def small_densenets():
    """`SMALL_DENSENETS` registered as backbones of the densenet family in
    both packages' registries, for the duration of the block."""
    with contextlib.ExitStack() as stack:
        for registry, module in ((jregistry, jdensenet), (tregistry, tdensenet)):
            for name, kw in SMALL_DENSENETS.items():
                registry.BACKBONES[name] = registry.BackboneSpec(
                    functools.partial(module.DenseNetFeatures, **kw), "densenet")
                stack.callback(registry.BACKBONES.pop, name)
        yield
