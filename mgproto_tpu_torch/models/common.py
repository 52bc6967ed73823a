"""Shared building blocks of the backbones (counterpart of mgproto_tpu/models/common.py).

Module names follow torchvision (conv1, bn1, layer1.0.conv2, ...), so a
torchvision state_dict loads as it is and `models/convert.py` maps the JAX
package's flax names onto the same keys.
"""

from __future__ import annotations

from torch import nn


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         padding: int = 0, bias: bool = False) -> nn.Conv2d:
    """Conv with explicit symmetric padding and no bias (flax `conv`)."""
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=bias)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    """torch BatchNorm2d defaults, as the JAX package sets flax's BatchNorm:
    eps 1e-5, momentum 0.1 (flax momentum 0.9)."""
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)
