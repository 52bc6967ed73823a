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

Under a mesh (parallel/), a BatchNorm whose `stats_group` is set takes its
train-mode statistics over the batch of every rank of that group.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mgproto_tpu_torch.parallel.collectives import all_reduce_sum, group_size

# a trunk's `conv_info()`: (kernels, strides, paddings) of the convs and
# pools its forward runs, in order (ops/receptive_field.py reads it)
ConvInfo = Tuple[List[int], List[int], List[Any]]

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
    """Conv with explicit symmetric padding, without a bias unless `bias`
    (flax `conv`'s `use_bias`; the VGG convs have one)."""
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
    With `stats_group` set (`set_stats_group`), the statistics are the
    means over the group's ranks of each rank's E[x] and E[x^2], summed by
    a collective whose backward sums the gradients back (equal batches on
    every rank, as the sharded loader gives; the JAX package's SPMD
    BatchNorm over the global batch). A remat recompute issues it again,
    in the same order on every rank.
    `engine/train.py` snapshots and restores them around a step the
    divergence guard skips. Eval mode is `BatchNorm2d`'s own in f32; a half
    input is normalized by `bn_apply` in f32 and rounded once, as flax
    does (torch's kernels need not round there)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1.0 - MOMENTUM)
        self.update_stats = True  # False while remat recomputes a forward
        self.stats_group = None  # the ranks whose batches the statistics span

    def batch_statistics(self, x: torch.Tensor):
        """(mean, var) [C] of an NCHW batch, f32, and the running update."""
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
        if group_size(self.stats_group) > 1:
            both = all_reduce_sum(torch.stack([mean, mean2]), self.stats_group)
            mean, mean2 = both / group_size(self.stats_group)
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


def set_stats_group(module: nn.Module, group) -> None:
    """Take the train-mode statistics of every BatchNorm in `module` over
    the ranks of `group` (None: this process's batch only)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.stats_group = group


def batch_norm(ch: int) -> BatchNorm:
    """The trunk's BatchNorm: eps 1e-5, flax momentum 0.9, as the JAX
    package sets flax's BatchNorm."""
    return BatchNorm(ch, eps=1e-5)


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """flax `nn.max_pool` with symmetric padding on NCHW x: the padding is
    -inf (it never wins a window) and a window that would run past the
    padded edge is dropped (VALID), as torch's floor mode does."""
    return nn.functional.max_pool2d(x, kernel, stride, padding)


def avg_pool(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax `nn.avg_pool` without padding on NCHW x: the window's mean,
    windows past the edge dropped."""
    return nn.functional.avg_pool2d(x, kernel, stride)


@contextlib.contextmanager
def stats_frozen(module: nn.Module):
    """The running statistics of `module`'s BatchNorms untouched in the
    block (a remat recompute); restored on every exit, early stop
    included."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class RematBlock(nn.Module):
    """A block (a ResNet block, a DenseNet layer) whose `block_forward`
    runs under `torch.utils.checkpoint` (non-reentrant) when `remat` is set
    and a gradient is being recorded in train mode: the backward recomputes
    the block's forward instead of keeping its activations (the JAX
    package's `nn.remat`). The recompute runs with the block's BatchNorms'
    `update_stats` off, so the running statistics take one update a step,
    as flax's do; the state-dict keys are the same with and without remat."""

    remat = False

    def forward(self, x):
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return self.block_forward(x)
        # context_fn: (the first forward's context, the recompute's)
        return checkpoint(self.block_forward, x, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), stats_frozen(self)))
