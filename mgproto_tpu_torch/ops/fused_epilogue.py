"""BatchNorm apply + residual add + ReLU: the ResNet block epilogue.

Counterpart of mgproto_tpu/ops/fused_epilogue.py. The CUDA kernel
(csrc/bn_epilogue.cu, which replaces the Pallas `_epilogue_kernel`) reads x
and the shortcut once and writes the block output once, with the per-channel
constants a = scale * rsqrt(var + eps), b = bias - mean * a folded here in
f32.

Gradient: the JAX package has no Pallas backward for the epilogue; its
backward is the VJP of `epilogue_reference`, recomputed. `_EpilogueFn` does
the same with autograd. `mean` and `var` are differentiable inputs, so in
train mode the gradient through the batch statistics stays in the caller's
graph (`BNEpilogue`).

Layout: 4-D activations are NCHW tensors in `torch.channels_last` memory, so
their storage is the JAX package's [B, H, W, C] rows, [M, C]. The wrapper
checks the layout on every device and never copies to fix it.

On a CUDA tensor `fused_bn_epilogue` launches the kernel (or raises); on a
CPU tensor it runs `epilogue_reference`, the plain BatchNorm arithmetic.
Both go through the same autograd Function, so the backward runs the same
ops on either device, and both report the forward to an active cost
counter (obs/opcount.py) as the kernel's analytic FLOPs and bytes
(`bn_epilogue_cost`).

Mixed precision (perf/precision.py): under `compute_dtype="bfloat16"` x and
the shortcut are bf16 and the statistics, scale and bias f32. The kernel
(`bn_epilogue_bf16`) folds a and b in f32, computes in f32 and rounds once;
the backward, as in JAX, is the VJP of `epilogue_reference` in bf16, which
rounds after every op. So do the plain version on the CPU and JAX's
`epilogue_reference`; flax's unfused BatchNorm (the JAX CPU default) rounds
its output once, then the add.
"""

from __future__ import annotations

import torch

from mgproto_tpu_torch.models.common import BatchNorm
from mgproto_tpu_torch.obs import opcount
from mgproto_tpu_torch.ops import _build

_KERNEL_DTYPES = {torch.float32: "bn_epilogue_f32", torch.bfloat16: "bn_epilogue_bf16"}


def epilogue_reference(x, mean, var, scale, bias, residual, eps, compute_dtype):
    """The plain version: BatchNorm's apply arithmetic in the compute dtype
    (y = (x - mean) * rsqrt(var + eps) * scale + bias), the shortcut add and
    the ReLU — mgproto_tpu's `epilogue_reference` op for op."""
    dt = compute_dtype
    shape = (1, -1, 1, 1) if x.dim() == 4 else (-1,)
    # eps rounded to dt as a device fill: a host scalar copied to the card
    # would synchronize the stream, once per call of the training backward
    mul = torch.rsqrt(var.to(dt) + torch.full((), eps, dtype=dt, device=var.device))
    mul = (mul * scale.to(dt)).reshape(shape)
    y = (x.to(dt) - mean.to(dt).reshape(shape)) * mul
    y = y + bias.to(dt).reshape(shape) + residual.to(dt)
    return torch.clamp_min(y, 0)


def _rows_layout_ok(t: torch.Tensor) -> bool:
    if t.dim() == 4:
        return t.is_contiguous(memory_format=torch.channels_last)
    return t.dim() == 2 and t.is_contiguous()


def fold_constants(mean, var, scale, bias, eps):
    """a = scale * rsqrt(var + eps), b = bias - mean * a, in f32."""
    a = torch.rsqrt(var.float() + eps) * scale.float()
    return a, bias.float() - mean.float() * a


def bn_epilogue_cost(x: torch.Tensor):
    """(FLOPs, bytes) of one epilogue on x: a multiply-add an element; x
    and the shortcut read once, the output written once, the two [C]
    constants read."""
    return 2.0 * x.numel(), 3.0 * x.numel() * x.element_size() + 2 * 4 * x.shape[1]


def _epilogue_forward(x, mean, var, scale, bias, residual, eps):
    """The kernel on CUDA, the plain version on the CPU; one cost row."""
    with opcount.counted("bn_epilogue", *bn_epilogue_cost(x)):
        if x.device.type == "cpu":
            return epilogue_reference(x, mean, var, scale, bias, residual, eps, x.dtype)
        return launch_bn_epilogue(x, residual, *fold_constants(mean, var, scale, bias, eps))


def launch_bn_epilogue(x, residual, a, b):
    """Launch the CUDA kernel: out = relu(x * a + b + residual) on [M, C]
    rows (x, residual channels_last [B, C, H, W] or contiguous [M, C],
    float32 or bfloat16; a, b [C] float32). Counts one launch."""
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"bn epilogue kernel takes float32 or bfloat16, not {x.dtype}")
    c = x.shape[1]
    for t in (a, b):
        if t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"bn epilogue constants must be contiguous float32 [{c}]")
    if any(t.device != x.device for t in (residual, a, b)):
        raise ValueError("bn epilogue operands must be on one device")
    if c % 4 or x.data_ptr() % 16 or residual.data_ptr() % 16:
        raise ValueError("bn epilogue kernel needs C % 4 == 0 and 16-byte aligned rows")
    out = torch.empty_like(x)  # keeps channels_last
    lib = _build.load("bn_epilogue")
    code = getattr(lib, _KERNEL_DTYPES[x.dtype])(
        x.data_ptr(), residual.data_ptr(), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), x.numel(), c, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "bn_epilogue launch")
    fused_bn_epilogue.launches += 1
    return out


def fused_bn_epilogue(x, mean, var, scale, bias, residual, eps: float = 1e-5):
    """relu(batchnorm(x) + residual), in and out in x's dtype.

    Args:
      x, residual: [B, C, H, W] in channels_last memory (or [M, C] rows).
      mean/var:    [C] statistics (running averages in eval mode).
      scale/bias:  [C] BatchNorm affine parameters (f32).
    """
    if x.shape != residual.shape or x.dtype != residual.dtype:
        raise ValueError("x and residual must have one shape and dtype")
    if not (_rows_layout_ok(x) and _rows_layout_ok(residual)):
        raise ValueError(
            "bn epilogue takes channels_last [B, C, H, W] (or contiguous "
            "[M, C]) tensors; convert the trunk with "
            "memory_format=torch.channels_last"
        )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bn epilogue runs on cuda or cpu, not {x.device}")
    inputs = (x, mean, var, scale, bias, residual)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _EpilogueFn.apply(*inputs, eps)
    return _epilogue_forward(*inputs, eps)


fused_bn_epilogue.launches = 0  # kernel launches since the last reset


class _EpilogueFn(torch.autograd.Function):
    """The kernel forward (the plain one on the CPU); the backward is
    autograd of `epilogue_reference` on the saved inputs, recomputed (the
    JAX package's `_bn_add_relu_bwd`)."""

    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, residual, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, mean, var, scale, bias, residual)
        return _epilogue_forward(x, mean, var, scale, bias, residual, eps)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = epilogue_reference(*inputs, ctx.eps, inputs[0].dtype)
            wrt = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(grads) if n else None for n in need), None)


class BNEpilogue(BatchNorm):
    """BatchNorm + residual add + ReLU with the tail in one pass.

    A `BatchNorm` (models/common.py: `BatchNorm2d` parameters and buffers,
    eps 1e-5, flax's train-mode statistics and biased running update), so
    weights load under the same `bn2`/`bn3` names whether or not the
    epilogue is fused. Train mode normalizes with the batch statistics,
    which stay graph nodes; eval mode with the running ones."""

    def forward(self, x, residual):  # type: ignore[override]
        if self.training:
            mean, var = self.batch_statistics(x)
        else:
            mean, var = self.running_mean, self.running_var
        return fused_bn_epilogue(
            x, mean, var, self.weight, self.bias, residual, eps=self.eps,
        )
