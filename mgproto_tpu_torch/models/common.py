"""Shared building blocks of the backbones (counterpart of mgproto_tpu/models/common.py).

Module names follow torchvision (conv1, bn1, layer1.0.conv2, ...), so a
torchvision state_dict loads as it is and `models/convert.py` maps the JAX
package's flax names onto the same keys.

Mixed precision (perf/precision.py) follows the activations' dtype, as
flax's `dtype=` does: a `Conv2d` casts its f32 master weight (and bias) to
its input's dtype at each call (flax `promote_dtype`), so the modules are
never cast and Adam and the checkpoints keep f32 masters; a `BatchNorm`
computes its statistics in f32 and its output in f32, rounded once to the
input's dtype (flax `_normalize`), in train and in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

# flax momentum: running = MOMENTUM * running + (1 - MOMENTUM) * batch
MOMENTUM = 0.9


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` in its input's dtype: the f32 weight and bias are cast to
    it at each call (autograd casts their gradients back to f32)."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, w, b)


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         padding: int = 0, bias: bool = False) -> Conv2d:
    """Conv with explicit symmetric padding and no bias (flax `conv`)."""
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=bias)


def bn_apply(x, mean, var, scale, bias, eps):
    """flax's normalize arithmetic on NCHW x with [C] statistics:
    (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + eps) * scale
    return (x - mean.reshape(shape)) * mul.reshape(shape) + bias.reshape(shape)


class BatchNorm(nn.BatchNorm2d):
    """A `BatchNorm2d` (same parameters, buffers and state-dict keys; eps
    1e-5) with flax `nn.BatchNorm`'s train mode, which the JAX package
    trains with:

      * batch statistics in f32 with the fast variance
        max(E[x^2] - E[x]^2, 0), biased, and normalization with it;
      * gradients flow through the statistics (they are graph nodes);
      * running update 0.9 * old + 0.1 * new with the BIASED variance
        (`nn.BatchNorm2d` uses the unbiased one, a factor N/(N-1) apart).

    The running statistics are updated in place during the train-mode
    forward, as torch's BatchNorm does, once per step: a forward recomputed
    by remat (models/resnet.py) runs with `update_stats` off.
    `engine/train.py` snapshots and restores them around a step the
    divergence guard skips. Eval mode is `BatchNorm2d`'s own in f32; a half
    input is normalized by `bn_apply` in f32 and rounded once, as flax
    does (torch's kernels need not round there)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1.0 - MOMENTUM)
        self.update_stats = True  # False while remat recomputes a forward

    def batch_statistics(self, x: torch.Tensor):
        """(mean, var) [C] of an NCHW batch, f32, and the running update."""
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.copy_(MOMENTUM * self.running_mean + (1.0 - MOMENTUM) * mean)
                self.running_var.copy_(MOMENTUM * self.running_var + (1.0 - MOMENTUM) * var)
        return mean, var

    def forward(self, x):
        if self.training:
            mean, var = self.batch_statistics(x)
        elif x.dtype == torch.float32:
            return super().forward(x)
        else:
            mean, var = self.running_mean, self.running_var
        return bn_apply(x, mean, var, self.weight, self.bias, self.eps).to(x.dtype)


def batch_norm(ch: int) -> BatchNorm:
    """The trunk's BatchNorm: eps 1e-5, flax momentum 0.9, as the JAX
    package sets flax's BatchNorm."""
    return BatchNorm(ch, eps=1e-5)
