"""The port's receptive-field arithmetic (mgproto_tpu_torch/ops/
receptive_field.py) and its trunks' `conv_info()` / `out_channels`
(models/{resnet,vgg,densenet,registry}.py) against the JAX package's.

Exact equality throughout (integer and half-integer host arithmetic): the
(kernels, strides, paddings) lists of every registered trunk, with and
without the stem pool where a family has one; `out_channels`; the RFInfo
of the prototype layer at 224 px and 32 px; `rf_box_at` / `rf_boxes` over
every latent position. `RFInfo.grid_size` equals the latent side the
port's forward gives, so `conv_info` lists the ops that run.
"""

import dataclasses

import pytest
import torch

from mgproto_tpu.models.registry import BACKBONES as JAX_BACKBONES
from mgproto_tpu.ops import receptive_field as jrf
from mgproto_tpu_torch.models import resnet
from mgproto_tpu_torch.models.registry import BACKBONES
from mgproto_tpu_torch.ops import receptive_field as trf

ARCHS = sorted(BACKBONES)


def _pair(arch, **kw):
    return BACKBONES[arch].factory(**kw), JAX_BACKBONES[arch].factory(**kw)


def test_the_registries_name_the_same_trunks():
    assert set(BACKBONES) == set(JAX_BACKBONES)


@pytest.mark.parametrize("arch", ARCHS)
def test_conv_info_and_out_channels_equal_jax(arch):
    port, ref = _pair(arch)
    assert [list(x) for x in port.conv_info()] == [list(x) for x in ref.conv_info()]
    assert port.out_channels == ref.out_channels
    for img in (224, 32):
        got = trf.proto_layer_rf_info(img, *port.conv_info())
        want = jrf.proto_layer_rf_info(img, *ref.conv_info())
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "densenet121"])
def test_conv_info_with_the_stem_pool_equals_jax(arch):
    port, ref = _pair(arch, stem_pool=True)
    assert [list(x) for x in port.conv_info()] == [list(x) for x in ref.conv_info()]


@pytest.mark.parametrize("arch", ["tiny", "resnet18", "vgg11", "densenet121"])
def test_grid_size_is_the_latent_side_the_forward_gives(arch):
    img = 64 if arch != "tiny" else 32
    model = BACKBONES[arch].factory().eval()
    with torch.no_grad():
        out = model(torch.zeros(1, 3, img, img))
    assert trf.proto_layer_rf_info(img, *model.conv_info()).grid_size == out.shape[-1]


@pytest.mark.parametrize("padding", [0, 1, 3, "SAME", "VALID"])
@pytest.mark.parametrize("n,kernel,stride", [(224, 7, 2), (15, 3, 2), (14, 2, 2), (7, 1, 1)])
def test_propagate_equals_jax(n, kernel, stride, padding):
    rf = trf.RFInfo(grid_size=n, jump=2, rf_size=5, start=1.5)
    jr = jrf.RFInfo(grid_size=n, jump=2, rf_size=5, start=1.5)
    assert dataclasses.asdict(trf.propagate(rf, kernel, stride, padding)) == \
        dataclasses.asdict(jrf.propagate(jr, kernel, stride, padding))


def test_rf_boxes_equal_jax():
    kw = dict(zip(("kernels", "strides", "paddings"), resnet.resnet34().conv_info()))
    rf = trf.proto_layer_rf_info(224, **kw)
    jr = jrf.proto_layer_rf_info(224, **kw)
    locs = [(i, h, w) for i in range(2) for h in range(rf.grid_size) for w in range(rf.grid_size)]
    assert trf.rf_boxes(rf, 224, locs) == jrf.rf_boxes(jr, 224, locs)
    assert trf.rf_box_at(rf, 224, 3, 5) == jrf.rf_box_at(jr, 224, 3, 5)
    with pytest.raises(AssertionError):
        trf.rf_box_at(rf, 224, rf.grid_size, 0)
