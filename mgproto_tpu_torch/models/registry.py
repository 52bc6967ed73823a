"""Backbone registry (counterpart of mgproto_tpu/models/registry.py), the
tiny test trunk, and seeded random weights.

The resnet family and `tiny` for now; VGG and DenseNet come later.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from mgproto_tpu_torch.models import resnet
from mgproto_tpu_torch.models.common import batch_norm, conv


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

    def forward(self, x):
        x = nn.functional.relu(self.bn0(self.conv0(x)))
        x = nn.functional.relu(self.bn1(self.conv1(x)))
        return nn.functional.relu(self.conv2(x))


RESNETS: Dict[str, Callable[..., resnet.ResNetFeatures]] = {
    "resnet18": resnet.resnet18,
    "resnet34": resnet.resnet34,
    "resnet50": resnet.resnet50,
    "resnet101": resnet.resnet101,
    "resnet152": resnet.resnet152,
}


def build_backbone(arch: str, fused_epilogue: bool = False, remat: bool = False,
                   remat_stages: Tuple[str, ...] = ()) -> nn.Module:
    """The trunk of `arch`. The block options (`fused_epilogue`, `remat`,
    `remat_stages`) are the resnet family's; `tiny` refuses them."""
    if arch in RESNETS:
        return RESNETS[arch](fused_epilogue=fused_epilogue, remat=remat,
                             remat_stages=tuple(remat_stages))
    if arch == "tiny":
        if fused_epilogue:
            raise ValueError("fused_epilogue is implemented for resnet blocks only")
        if remat or remat_stages:
            raise ValueError(f"remat is implemented for resnet blocks only (got arch={arch!r})")
        return TinyFeatures()
    raise ValueError(f"unknown backbone {arch!r}; options: {sorted(RESNETS) + ['tiny']}")


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
