"""Pretrained trunks from local torchvision-layout `.pth` files
(mgproto_tpu_torch/models/pretrained.py, `create_train_state` with
`ModelConfig.pretrained`) against the JAX package's, on the CPU.

Seeded torchvision-layout state_dicts (`features.` prefixes for VGG and
DenseNet, the classifier or fc head, `num_batches_tracked`) are written as
`.pth` files for resnet18, vgg11_bn and densenet121, and read by both
packages through `MGPROTO_PRETRAINED_DIR`, with JAX's converted cache
(`MGPROTO_CONVERTED_DIR`) and `TORCH_HOME` under `tmp_path`, `HOME` too,
so nothing is read from or written to the user's cache.

  * The port's trunk equals the file bit for bit, and JAX's trunk carried
    across by `from_jax_variables` bit for bit; the eval-mode proto maps of
    the two packages agree within 1e-5 of their maximum.
  * The GMM and the proxies equal those of the non-pretrained state from
    the same seed (the trunk is loaded after the seeded draws).
  * The same errors in both packages: a missing file (FileNotFoundError
    listing every searched directory), a plain torchvision resnet50 file
    (not matched: the BBN-iNaturalist variant only), a tensor of another
    shape (ValueError naming it).
  * Legacy DenseNet keys (`norm.1`, `conv.1`) and `module.` prefixes load.
  * `for_restore=True` reads no file.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from mgproto_tpu.config import EMConfig as JaxEMConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.models.pretrained import load_pretrained_trunk, merge_pretrained_trunk
from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.core.state import create_train_state
from mgproto_tpu_torch.models import pretrained
from mgproto_tpu_torch.models.convert import from_jax_variables
from mgproto_tpu_torch.models.registry import build_backbone, family

PX = 32


@pytest.fixture()
def dirs(tmp_path, monkeypatch):
    """(the .pth directory) with every cache directory under tmp_path."""
    pth_dir = tmp_path / "pth"
    pth_dir.mkdir()
    monkeypatch.setenv("MGPROTO_PRETRAINED_DIR", str(pth_dir))
    monkeypatch.setenv("MGPROTO_CONVERTED_DIR", str(tmp_path / "converted"))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return pth_dir


def torchvision_state(arch, seed):
    """A seeded state_dict in torchvision's layout for `arch`'s trunk, with
    the classifier head torchvision files carry."""
    rng = np.random.default_rng(seed)
    prefix = "" if family(arch) == "resnet" else "features."
    sd = {}
    for k, v in build_backbone(arch).state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[prefix + k] = torch.tensor(int(rng.integers(0, 1000)))
        elif k.endswith("running_var"):
            sd[prefix + k] = torch.from_numpy((0.5 + rng.random(v.shape)).astype(np.float32))
        else:
            sd[prefix + k] = torch.from_numpy(
                (0.1 * rng.normal(size=tuple(v.shape))).astype(np.float32))
    head = "fc" if family(arch) == "resnet" else "classifier"
    sd[f"{head}.weight"] = torch.zeros(10, 4)
    sd[f"{head}.bias"] = torch.zeros(10)
    return sd


def _cfgs(arch, pretrained_flag=True):
    jcfg, tcfg = jax_tiny_config(arch=arch), tiny_test_config(arch=arch)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, pretrained=pretrained_flag),
                        em=JaxEMConfig(async_bank=False))
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, pretrained=pretrained_flag))
    return jcfg, tcfg


def _jax_state(jcfg):
    """(trainer, state) of JAX's `create_train_state` with `pretrained`,
    its steps taken one by one so the random init is jitted (the pretrained
    branch reads files, so the whole function cannot be): the restore
    target's init, then the branch itself, `merge_pretrained_trunk(...,
    load_pretrained_trunk(arch))`."""
    trunk = load_pretrained_trunk(jcfg.model.arch)
    trainer = JaxTrainer(jcfg, steps_per_epoch=1)
    state = jax.jit(functools.partial(trainer.init_state, for_restore=True))(
        jax.random.PRNGKey(0))
    net, stats = merge_pretrained_trunk(state.params["net"], state.batch_stats, trunk)
    return trainer, jax.device_get(state.replace(params={**state.params, "net": net},
                                                 batch_stats=stats))


def _port_state(tcfg, seed=0, for_restore=False):
    return create_train_state(tcfg, torch.Generator().manual_seed(seed), "cpu",
                              for_restore=for_restore)


@pytest.mark.parametrize("arch", ["resnet18", "vgg11_bn", "densenet121"])
def test_both_packages_load_the_same_trunk(dirs, arch):
    sd = torchvision_state(arch, seed=3)
    torch.save(sd, dirs / f"{arch}-0123abcd.pth")
    jcfg, tcfg = _cfgs(arch)
    state = _port_state(tcfg)
    trunk = state.model.features.state_dict()
    prefix = "" if family(arch) == "resnet" else "features."
    for k, v in trunk.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[prefix + k]), k

    jtrainer, jstate = _jax_state(jcfg)
    jsd, _ = from_jax_variables({"params": jstate.params["net"],
                                 "batch_stats": jstate.batch_stats}, jstate.gmm, arch)
    for k, v in trunk.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, jsd["features." + k]), k

    # the proto maps of the two packages' whole models: their add-ons and
    # embeddings are JAX's, carried across
    state.model.load_state_dict(jsd)
    images = np.random.default_rng(4).normal(size=(2, PX, PX, 3)).astype(np.float32)
    apply = jax.jit(functools.partial(jtrainer._apply, train=False))
    (jmap, _), _ = apply(jstate.params, jstate.batch_stats, images)
    with torch.no_grad():
        pmap, _ = state.model.eval()(torch.from_numpy(images))
    jmap = np.asarray(jmap)
    assert np.abs(pmap.numpy() - jmap).max() <= 1e-5 * np.abs(jmap).max()


def test_the_seeded_draws_do_not_depend_on_the_trunk_load(dirs):
    torch.save(torchvision_state("resnet18", seed=5), dirs / "resnet18.pth")
    _, tcfg = _cfgs("resnet18")
    a = _port_state(tcfg)
    b = _port_state(_cfgs("resnet18", pretrained_flag=False)[1])
    assert torch.equal(a.gmm.means, b.gmm.means) and torch.equal(a.proxies, b.proxies)
    emb = ("embedding.weight", "embedding.bias", "add_on.conv0.weight", "add_on.conv1.weight")
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in emb)
    assert not torch.equal(sa["features.conv1.weight"], sb["features.conv1.weight"])


def _both_raise(arch, exc):
    """The port's and JAX's errors for a pretrained start of `arch`."""
    jcfg, tcfg = _cfgs(arch)
    with pytest.raises(exc) as port:
        _port_state(tcfg)
    with pytest.raises(exc) as jax_err:
        _jax_state(jcfg)
    return str(port.value), str(jax_err.value)


def test_a_missing_file_lists_the_searched_directories(dirs):
    port, jax_msg = _both_raise("vgg11", FileNotFoundError)
    for d in pretrained.search_dirs():
        assert d in port and d in jax_msg
    assert "vgg11-*.pth" in port and "vgg11-*.pth" in jax_msg


def test_a_plain_torchvision_resnet50_file_is_not_taken(dirs):
    (dirs / "resnet50-0676ba61.pth").write_bytes(b"")  # torchvision's name
    port, jax_msg = _both_raise("resnet50", FileNotFoundError)
    assert "BBN-iNaturalist" in port and "BBN-iNaturalist" in jax_msg


def test_a_shape_mismatch_fails_loudly(dirs):
    sd = torchvision_state("resnet18", seed=6)
    sd["layer2.0.conv1.weight"] = torch.zeros(128, 64, 1, 1)
    torch.save(sd, dirs / "resnet18-deadbeef.pth")
    port, jax_msg = _both_raise("resnet18", ValueError)
    assert "shape" in port and "shape" in jax_msg
    assert "layer2.0.conv1.weight" in port


def test_legacy_densenet_keys_and_wrapper_prefixes_load(dirs):
    """Old torchvision DenseNet files name the layers `norm.1`, `relu.1`,
    `conv.1`; checkpoints saved from DataParallel carry `module.`."""
    arch = "densenet121"
    sd = torchvision_state(arch, seed=7)
    legacy = {}
    for k, v in sd.items():
        k = k.replace(".norm1.", ".norm.1.").replace(".conv1.", ".conv.1.")
        legacy["module." + k.replace(".norm2.", ".norm.2.").replace(".conv2.", ".conv.2.")] = v
    assert any(".norm.1." in k for k in legacy)
    torch.save(legacy, dirs / f"{arch}.pth")
    state = _port_state(_cfgs(arch)[1])
    for k, v in state.model.features.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd["features." + k]), k


def test_a_restore_target_reads_no_file(dirs):
    _, tcfg = _cfgs("resnet18")
    with pytest.raises(FileNotFoundError):
        _port_state(tcfg)
    state = _port_state(tcfg, for_restore=True)  # no file on the search path
    ref = _port_state(_cfgs("resnet18", pretrained_flag=False)[1])
    assert torch.equal(state.model.features.conv1.weight, ref.model.features.conv1.weight)
    assert not os.listdir(dirs)
