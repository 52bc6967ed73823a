"""The port's VGG and DenseNet trunks (models/vgg.py, models/densenet.py,
models/registry.py) against the JAX package's, on the CPU. The train steps
of these trunks are in tests/test_torch_backbone_steps.py.

  * Every backbone name of the JAX registry builds in the port, with the
    JAX trunk's family, output channels and output grid at 64 px.
  * Trunk forwards on seeded variables (drawn with numpy into the JAX
    variable tree, carried by `from_jax_variables`): vgg11, vgg11_bn,
    vgg19 and densenet121. Eval mode within 1e-5 of the map's maximum;
    the running statistics after a train-mode forward atol 1e-5; train-mode
    features within 5e-5 of the map's maximum: batch statistics over few
    samples turn a summation-order difference in a conv into a larger one
    after var = E[x^2] - E[x]^2 and 1/sqrt(var); the JAX package's own
    jitted and op-by-op train forwards differ by up to 1.6e-5 of the
    maximum at these sizes, and the port lies 1.3e-5 to 2.5e-5 from JAX's.
  * DenseNet remat (every dense layer, or the named blocks) against no
    remat in the port, on a small DenseNet: loss, gradients and running
    statistics bit-equal.
  * The registry's refusals, raised as the JAX package raises them, and
    the configurations both accept.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_states import small_densenets
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.core.mgproto import MGProtoFeatures as JaxFeatures
from mgproto_tpu.models import registry as jregistry
from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.core.mgproto import make_features
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models import registry as tregistry
from mgproto_tpu_torch.models.convert import from_jax_variables

B = 6
LABELS = np.array([0, 1, 2, 3, 1, 0], np.int32)
JAX_NAMES = sorted(jregistry.BACKBONES)


@pytest.fixture(scope="module", autouse=True)
def registered():
    with small_densenets():
        yield


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# ----------------------------------------------------------------- registry
def _grid(conv_info, n):
    for k, st, p in zip(*conv_info):
        n = (n + 2 * p - k) // st + 1
    return n


@pytest.mark.parametrize("arch", JAX_NAMES)
def test_every_jax_backbone_builds_in_the_port(arch):
    """Output channels and family from the JAX registry; the output grid at
    64 px from the JAX trunk's `conv_info` (the ops its forward runs)."""
    trunk = tregistry.build_backbone(arch).eval()
    jtrunk = jregistry.build_backbone(arch)
    assert trunk.out_channels == jtrunk.out_channels
    assert tregistry.family(arch) == jregistry.BACKBONES[arch].family
    with torch.no_grad():
        y = trunk(torch.zeros(1, 3, 64, 64))
    g = _grid(jtrunk.conv_info(), 64)
    assert tuple(y.shape) == (1, jtrunk.out_channels, g, g)


def _refusals(arch, **model_kw):
    """(port error, JAX error) messages, or None where one builds."""
    out = []
    pcfg = tiny_test_config(arch=arch)
    try:
        make_features(dataclasses.replace(pcfg.model, **model_kw), torch.device("cpu"))
        out.append(None)
    except ValueError as e:
        out.append(str(e))
    jcfg = jax_tiny_config(arch=arch)
    try:
        model = JaxFeatures(cfg=dataclasses.replace(jcfg.model, **model_kw))
        jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
        out.append(None)
    except ValueError as e:
        out.append(str(e))
    return out


@pytest.mark.parametrize("arch,kw", [
    ("vgg11", {"remat": True}),
    ("vgg11_bn", {"remat_stages": ("layer1",)}),
    ("densenet_small", {"remat_stages": ("layer1",)}),
    ("densenet_small", {"remat_stages": ("denseblock5",)}),
    ("resnet18", {"remat_stages": ("denseblock1",)}),
    ("tiny", {"remat": True}),
    ("vgg11", {"fused_epilogue": True}),
    ("densenet_small", {"fused_epilogue": True}),
    ("nope", {}),
])
def test_registry_refusals_match_jax(arch, kw):
    port, want = _refusals(arch, **kw)
    assert want is not None and port == want


@pytest.mark.parametrize("arch,kw", [
    ("densenet_small", {"remat": True}),
    ("densenet_small", {"remat_stages": ("denseblock1", "denseblock4")}),
    ("densenet_small", {"fused_epilogue": False}),
    ("vgg11", {"fused_epilogue": None}),
])
def test_registry_accepts_what_jax_accepts(arch, kw):
    assert _refusals(arch, **kw) == [None, None]


# ------------------------------------------------------------------- trunks
def _seeded_variables(jtrunk, x, seed):
    """A JAX trunk's variable tree filled with seeded numpy draws: convs
    He-normal, biases 0.1 N(0, 1), BatchNorm scales 0.5 + U, shifts
    0.1 N(0, 1), running means 0.1 N(0, 1), running variances 0.5 + U."""
    shapes = jax.eval_shape(lambda: jtrunk.init(jax.random.PRNGKey(0), x, train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return (0.5 + rng.random(shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


TRUNKS = {"vgg11": (32, 4), "vgg11_bn": (48, 4), "vgg19": (64, 2), "densenet121": (32, 4)}


@pytest.mark.parametrize("arch", sorted(TRUNKS))
def test_trunk_matches_jax_in_eval_and_train_mode(arch):
    px, n = TRUNKS[arch]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, px, px, 3)).astype(np.float32)
    jtrunk = jregistry.build_backbone(arch)
    variables = _seeded_variables(jtrunk, x, seed=2)
    has_bn = "batch_stats" in variables

    def fwd(v, x):
        if not has_bn:
            return jtrunk.apply(v, x, train=False), jtrunk.apply(v, x, train=False), {}
        y_train, upd = jtrunk.apply(v, x, train=True, mutable=["batch_stats"])
        return jtrunk.apply(v, x, train=False), y_train, upd["batch_stats"]

    j_eval, j_train, j_stats = jax.device_get(jax.jit(fwd)(variables, x))
    sd, _ = from_jax_variables(
        {"params": {"features": variables["params"]},
         "batch_stats": {"features": variables.get("batch_stats", {})}}, _gmm_stub(), arch)
    trunk = tregistry.build_backbone(arch)
    trunk.load_state_dict({k.removeprefix("features."): v for k, v in sd.items()})
    with torch.no_grad():
        y_eval = _nhwc(trunk.eval()(_nchw(x)))
        y_train = _nhwc(trunk.train()(_nchw(x)))
    scale = np.abs(j_eval).max()
    assert np.abs(y_eval - j_eval).max() <= 1e-5 * scale
    assert np.abs(y_train - j_train).max() <= 5e-5 * np.abs(j_train).max()
    if has_bn:
        stats, _ = from_jax_variables(
            {"params": {}, "batch_stats": {"features": j_stats}}, _gmm_stub(), arch)
        got = trunk.state_dict()
        for k, v in stats.items():
            np.testing.assert_allclose(got[k.removeprefix("features.")].numpy(), v.numpy(),
                                       atol=1e-5, err_msg=k)


def _images(seed=0):
    return np.random.default_rng(seed).normal(size=(B, 32, 32, 3)).astype(np.float32)


def _gmm_stub():
    z = np.zeros((1, 1, 1), np.float32)
    return type("G", (), {"means": z, "sigmas": z, "priors": z[0], "keep": z[0] > 0})()


# -------------------------------------------------------------------- remat
REMAT = {"full": ({"remat": True}, 8),
         "denseblock2": ({"remat_stages": ("denseblock2",)}, 2),
         "denseblock1_4": ({"remat_stages": ("denseblock1", "denseblock4")}, 4),
         "full_bf16": ({"remat": True, "compute_dtype": "bfloat16"}, 8)}


@pytest.mark.parametrize("case", sorted(REMAT))
def test_densenet_remat_matches_no_remat_bit_for_bit(case):
    kw, n_remat = dict(REMAT[case][0]), REMAT[case][1]
    dtype = kw.pop("compute_dtype", "float32")
    base = tiny_test_config(arch="densenet_small")
    cfgs = [base.replace(model=dataclasses.replace(base.model, compute_dtype=dtype, **extra))
            for extra in ({}, kw)]
    runs = []
    for cfg in cfgs:
        trainer = Trainer(cfg, 4, device="cpu")
        state = trainer.init_state(0)
        remat_layers = [m for m in state.model.modules() if getattr(m, "remat", False)]
        state, m = trainer.train_step(state, _images(3), LABELS, use_mine=True,
                                      update_gmm=False)
        stats = {n: t.clone() for n, t in state.model.state_dict().items() if "running" in n}
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        runs.append((m, stats, grads, len(remat_layers)))
    (m0, s0, g0, n0), (m1, s1, g1, n1) = runs
    assert (n0, n1) == (0, n_remat)
    assert m0.loss.item() == m1.loss.item()
    for n in s0:
        assert torch.equal(s0[n], s1[n]), n
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
