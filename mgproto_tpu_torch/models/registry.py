"""Backbone registry (counterpart of mgproto_tpu/models/registry.py): the
18 backbones the JAX package names, the tiny test trunk, the rules that
tie the block options to a family (the JAX `MGProtoFeatures.setup`), and
seeded random weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from mgproto_tpu_torch.models import densenet, resnet, vgg
from mgproto_tpu_torch.models.common import ConvInfo, batch_norm, conv


class TinyFeatures(nn.Module):
    """A 3-conv trunk for tests; the JAX package's TinyFeatures."""

    def __init__(self, width: int = 32):
        super().__init__()
        self.conv0 = conv(3, width, 3, 2, 1)
        self.bn0 = batch_norm(width)
        self.conv1 = conv(width, width, 3, 2, 1)
        self.bn1 = batch_norm(width)
        self.conv2 = conv(width, width, 3, 1, 1)
        self.out_channels = width

    def conv_info(self) -> ConvInfo:
        return [3, 3, 3], [2, 2, 1], [1, 1, 1]

    def forward(self, x):
        x = nn.functional.relu(self.bn0(self.conv0(x)))
        x = nn.functional.relu(self.bn1(self.conv1(x)))
        return nn.functional.relu(self.conv2(x))


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    factory: Callable[..., nn.Module]
    family: str  # resnet | vgg | densenet | tiny


BACKBONES: Dict[str, BackboneSpec] = {
    "resnet18": BackboneSpec(resnet.resnet18, "resnet"),
    "resnet34": BackboneSpec(resnet.resnet34, "resnet"),
    "resnet50": BackboneSpec(resnet.resnet50, "resnet"),
    "resnet101": BackboneSpec(resnet.resnet101, "resnet"),
    "resnet152": BackboneSpec(resnet.resnet152, "resnet"),
    "vgg11": BackboneSpec(vgg.vgg11, "vgg"),
    "vgg11_bn": BackboneSpec(vgg.vgg11_bn, "vgg"),
    "vgg13": BackboneSpec(vgg.vgg13, "vgg"),
    "vgg13_bn": BackboneSpec(vgg.vgg13_bn, "vgg"),
    "vgg16": BackboneSpec(vgg.vgg16, "vgg"),
    "vgg16_bn": BackboneSpec(vgg.vgg16_bn, "vgg"),
    "vgg19": BackboneSpec(vgg.vgg19, "vgg"),
    "vgg19_bn": BackboneSpec(vgg.vgg19_bn, "vgg"),
    "densenet121": BackboneSpec(densenet.densenet121, "densenet"),
    "densenet161": BackboneSpec(densenet.densenet161, "densenet"),
    "densenet169": BackboneSpec(densenet.densenet169, "densenet"),
    "densenet201": BackboneSpec(densenet.densenet201, "densenet"),
    "tiny": BackboneSpec(TinyFeatures, "tiny"),
}

# the stages `remat_stages` may name, per family
_REMAT_STAGES = {"resnet": resnet.STAGES, "densenet": densenet.STAGES}


def family(arch: str) -> str:
    """The family of a registered backbone; ValueError for an unknown one."""
    if arch not in BACKBONES:
        raise ValueError(f"unknown backbone {arch!r}; options: {sorted(BACKBONES)}")
    return BACKBONES[arch].family


def build_backbone(arch: str, fused_epilogue: bool = False, remat: bool = False,
                   remat_stages: Tuple[str, ...] = ()) -> nn.Module:
    """The trunk of `arch`. `remat` checkpoints every block (resnet blocks,
    dense layers); `remat_stages` the blocks of the named stages ("layer1"..
    "layer4", "denseblock1".."denseblock4"; ignored when `remat` is set).
    `fused_epilogue` mounts the BN epilogue kernel as the resnet blocks'
    tail; the other families refuse it. The refusals come in the JAX
    package's order."""
    fam = family(arch)
    if (remat or remat_stages) and fam not in _REMAT_STAGES:
        raise ValueError(f"remat is implemented for resnet/densenet blocks only (got arch={arch!r})")
    kw = {}
    if remat:
        kw["remat"] = True
    elif remat_stages:
        known = _REMAT_STAGES[fam]
        unknown = set(remat_stages) - set(known)
        if unknown:
            raise ValueError(f"unknown remat_stages {sorted(unknown)} for arch {arch!r}; "
                             f"options: {sorted(known)}")
        kw["remat_stages"] = tuple(remat_stages)
    if fam == "resnet":
        kw["fused_epilogue"] = fused_epilogue
    elif fused_epilogue:
        raise ValueError("fused_epilogue=True is implemented for resnet blocks only "
                         f"(got arch={arch!r}); leave it None/False here")
    return BACKBONES[arch].factory(**kw)


@torch.no_grad()
def init_random_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights in place: convs He-normal (fan_out, as
    torchvision), linear layers uniform(+-1/sqrt(fan_in)), and BatchNorm
    affine parameters and running statistics drawn around identity, so the
    eval-mode BatchNorm arithmetic is exercised. All draws come from
    `generator`, on the CPU, in module order."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_out = mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]
            w = torch.randn(mod.weight.shape, generator=generator)
            mod.weight.copy_(w * math.sqrt(2.0 / fan_out))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            mod.weight.copy_((torch.rand(mod.weight.shape, generator=generator) * 2 - 1) * bound)
            mod.bias.copy_((torch.rand(mod.bias.shape, generator=generator) * 2 - 1) * bound)
        elif isinstance(mod, nn.BatchNorm2d):
            c = mod.num_features
            mod.weight.copy_(0.5 + torch.rand(c, generator=generator))
            mod.bias.copy_(0.1 * torch.randn(c, generator=generator))
            mod.running_mean.copy_(0.1 * torch.randn(c, generator=generator))
            mod.running_var.copy_(0.5 + torch.rand(c, generator=generator))
