"""ResNet feature trunks (counterpart of mgproto_tpu/models/resnet.py).

As in the JAX package: the stem max-pool is skipped by default
(`stem_pool=False`, the reference's quirk), so ResNet-34 at 224 px runs
layer1 at 112x112 and ends at 14x14; resnet50 has layers [3, 4, 6, 4].
`fused_epilogue` mounts `BNEpilogue` as the block's last BatchNorm (`bn2`
in BasicBlock, `bn3` in Bottleneck), under the same name and state keys as
the plain BatchNorm it replaces.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from mgproto_tpu_torch.models.common import batch_norm, conv
from mgproto_tpu_torch.ops.fused_epilogue import BNEpilogue


def _tail(planes: int, fused: bool):
    return BNEpilogue(planes, eps=1e-5) if fused else batch_norm(planes)


def _finish(bn, out, identity, fused: bool):
    if fused:
        return bn(out, identity)
    return nn.functional.relu(bn(out) + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, fused_epilogue: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, 1)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = _tail(planes, fused_epilogue)
        self.downsample = (
            nn.Sequential(conv(inplanes, planes, 1, stride, 0), batch_norm(planes))
            if downsample else None
        )
        self.fused_epilogue = fused_epilogue

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = nn.functional.relu(self.bn1(self.conv1(x)))
        out = self.conv2(out)
        return _finish(self.bn2, out, identity, self.fused_epilogue)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, fused_epilogue: bool = False):
        super().__init__()
        width = planes * self.expansion
        self.conv1 = conv(inplanes, planes, 1, 1, 0)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv(planes, width, 1, 1, 0)
        self.bn3 = _tail(width, fused_epilogue)
        self.downsample = (
            nn.Sequential(conv(inplanes, width, 1, stride, 0), batch_norm(width))
            if downsample else None
        )
        self.fused_epilogue = fused_epilogue

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = nn.functional.relu(self.bn1(self.conv1(x)))
        out = nn.functional.relu(self.bn2(self.conv2(out)))
        out = self.conv3(out)
        return _finish(self.bn3, out, identity, self.fused_epilogue)


class ResNetFeatures(nn.Module):
    """Conv trunk of ResNet with avgpool/fc removed. NCHW in and out; run it
    on channels_last tensors so the block tails see [M, C] rows."""

    def __init__(self, block_cls: type, layers: Sequence[int],
                 stem_pool: bool = False, fused_epilogue: bool = False):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3)
        self.bn1 = batch_norm(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1) if stem_pool else None
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if li == 0 else 2
            stage = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                needs_ds = bi == 0 and (
                    s != 1 or inplanes != planes * block_cls.expansion
                )
                stage.append(block_cls(inplanes, planes, s, needs_ds, fused_epilogue))
                inplanes = planes * block_cls.expansion
            self.add_module(f"layer{li + 1}", nn.Sequential(*stage))
        self.out_channels = 512 * block_cls.expansion

    def forward(self, x):
        x = nn.functional.relu(self.bn1(self.conv1(x)))
        if self.maxpool is not None:
            x = self.maxpool(x)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x


def resnet18(**kw) -> ResNetFeatures:
    return ResNetFeatures(BasicBlock, [2, 2, 2, 2], **kw)


def resnet34(**kw) -> ResNetFeatures:
    return ResNetFeatures(BasicBlock, [3, 4, 6, 3], **kw)


def resnet50(**kw) -> ResNetFeatures:
    # [3, 4, 6, 4]: the extra layer4 block of the BBN iNaturalist checkpoint
    return ResNetFeatures(Bottleneck, [3, 4, 6, 4], **kw)


def resnet101(**kw) -> ResNetFeatures:
    return ResNetFeatures(Bottleneck, [3, 4, 23, 3], **kw)


def resnet152(**kw) -> ResNetFeatures:
    return ResNetFeatures(Bottleneck, [3, 8, 36, 3], **kw)
