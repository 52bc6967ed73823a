"""DenseNet feature trunks (counterpart of mgproto_tpu/models/densenet.py).

The reference's quirks, as in the JAX package: the stem pool0 is removed
(`stem_pool=False`), so denseblock1 runs at 112x112 and the grid is 14x14
at 224 px, and a final BN + ReLU caps the trunk.

Module names are torchvision's (`conv0`, `norm0`,
`denseblock1.denselayer1.norm1`, `transition1.conv`, `norm5`), so a
torchvision state_dict with its `features.` prefix stripped loads as it
is; the JAX package joins block and layer with `_`
(`denseblock1_denselayer1`).

Remat (`remat`, `remat_stages` over "denseblock1".."denseblock4"; the JAX
package's `nn.remat` per dense layer): every dense layer of a rematted
block is a `models/common.py::RematBlock` with `remat` set.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from mgproto_tpu_torch.models.common import (ConvInfo, RematBlock, avg_pool, batch_norm, conv,
                                             max_pool)

STAGES = ("denseblock1", "denseblock2", "denseblock3", "denseblock4")


class DenseLayer(RematBlock):
    """BN-ReLU-1x1 -> BN-ReLU-3x3, the output concatenated to the input
    along the channels."""

    def __init__(self, in_ch: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        width = bn_size * growth_rate
        self.norm1 = batch_norm(in_ch)
        self.conv1 = conv(in_ch, width, 1, 1, 0)
        self.norm2 = batch_norm(width)
        self.conv2 = conv(width, growth_rate, 3, 1, 1)

    def block_forward(self, x):
        y = self.conv1(nn.functional.relu(self.norm1(x)))
        y = self.conv2(nn.functional.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    """BN-ReLU-1x1 conv, then a 2x2 average pool."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm = batch_norm(in_ch)
        self.conv = conv(in_ch, out_ch, 1, 1, 0)

    def forward(self, x):
        return avg_pool(self.conv(nn.functional.relu(self.norm(x))), 2, 2)


class DenseNetFeatures(nn.Module):
    """The conv trunk of DenseNet (classifier removed) on NCHW tensors."""

    def __init__(self, growth_rate: int = 32, block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4, stem_pool: bool = False,
                 remat: bool = False, remat_stages: Tuple[str, ...] = ()):
        super().__init__()
        unknown = set(remat_stages) - set(STAGES)
        if unknown:
            raise ValueError(f"unknown remat_stages {sorted(unknown)}; options: {list(STAGES)}")
        self.stem_pool = stem_pool
        self.block_config = tuple(block_config)
        self.conv0 = conv(3, num_init_features, 7, 2, 3)
        self.norm0 = batch_norm(num_init_features)
        ch = num_init_features
        for bi, num_layers in enumerate(block_config):
            block = nn.Module()
            for li in range(num_layers):
                layer = DenseLayer(ch + li * growth_rate, growth_rate, bn_size)
                layer.remat = remat or f"denseblock{bi + 1}" in remat_stages
                block.add_module(f"denselayer{li + 1}", layer)
            self.add_module(f"denseblock{bi + 1}", block)
            ch += num_layers * growth_rate
            if bi != len(block_config) - 1:
                self.add_module(f"transition{bi + 1}", Transition(ch, ch // 2))
                ch //= 2
        self.norm5 = batch_norm(ch)
        self.num_blocks = len(block_config)
        self.out_channels = ch

    def conv_info(self) -> ConvInfo:
        """The stem conv, the stem pool when it runs, each dense layer's 1x1
        and 3x3, and each transition's 1x1 and 2x2 pool."""
        ks, ss, ps = [7], [2], [3]
        if self.stem_pool:
            ks, ss, ps = ks + [3], ss + [2], ps + [1]
        for bi, num_layers in enumerate(self.block_config):
            ks, ss, ps = ks + [1, 3] * num_layers, ss + [1, 1] * num_layers, ps + [0, 1] * num_layers
            if bi != len(self.block_config) - 1:
                ks, ss, ps = ks + [1, 2], ss + [1, 2], ps + [0, 0]
        return ks, ss, ps

    def forward(self, x):
        x = nn.functional.relu(self.norm0(self.conv0(x)))
        if self.stem_pool:
            x = max_pool(x, 3, 2, 1)
        for bi in range(1, self.num_blocks + 1):
            for layer in getattr(self, f"denseblock{bi}").children():
                x = layer(x)
            if bi != self.num_blocks:
                x = getattr(self, f"transition{bi}")(x)
        return nn.functional.relu(self.norm5(x))


def densenet121(**kw) -> DenseNetFeatures:
    return DenseNetFeatures(32, (6, 12, 24, 16), 64, **kw)


def densenet169(**kw) -> DenseNetFeatures:
    return DenseNetFeatures(32, (6, 12, 32, 32), 64, **kw)


def densenet201(**kw) -> DenseNetFeatures:
    return DenseNetFeatures(32, (6, 12, 48, 32), 64, **kw)


def densenet161(**kw) -> DenseNetFeatures:
    return DenseNetFeatures(48, (6, 12, 36, 24), 96, **kw)
