"""Int8 weight-only modules of a served model (perf/quant.py says which
weights are rounded and how).

`QuantConv2d` and `QuantLinear` take the place of a conv (`nn.Conv2d`,
models/common.py `Conv2d`) or an `nn.Linear` in an exported model. Each
holds its weight as int8 `qweight` in the float module's layout ([O, I, kh,
kw] or [O, I]) and one float32 `scale` per output channel (axis 0), both
buffers; a bias stays the float32 parameter it was. At each call the weight
is formed as `(qweight * scale).to(x.dtype)`: one product in float32 (int8
promotes exactly), rounded once to the input's dtype, as the JAX package's
`q.astype(f32) * scale` followed by flax's `promote_dtype`. That weight is a
temporary of the call, freed after it: nothing caches it, so the weights
stay int8 at rest.

The modules serve only: a call in train mode or with autograd recording
raises (the JAX package's int8 path is export-only too).

Readers of `.weight`: the quantized modules have none. The served and
explain forwards (engine/eval.py) and the receptive field
(ops/receptive_field.py, from the trunks' static `conv_info()`) read no
weight; `init_random_weights` and the training paths do, and a quantized
model is neither initialized nor trained.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def is_quantizable(module: nn.Module) -> bool:
    """A conv or dense layer: its `weight` is what the JAX package calls a
    `kernel` of rank >= 2."""
    return isinstance(module, (nn.Conv2d, nn.Linear)) and module.weight.ndim >= 2


class _Quantized(nn.Module):
    """The int8 weight, its per-output-channel scale and the f32 bias."""

    def _init_weight(self, q: torch.Tensor, scale: torch.Tensor, bias) -> None:
        if q.dtype != torch.int8 or scale.dtype != torch.float32 or scale.shape != q.shape[:1]:
            raise ValueError(f"want an int8 weight and a float32 scale [{q.shape[0]}], got "
                             f"{q.dtype} {tuple(q.shape)} and {scale.dtype} {tuple(scale.shape)}")
        self.register_buffer("qweight", q)
        self.register_buffer("scale", scale)
        self.bias = bias

    def dequantized_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight this call computes with (module docstring)."""
        _refuse_training(self)
        dequantize_weight.calls += 1
        return dequantize_weight(self.qweight, self.scale).to(dtype)

    def _bias(self, dtype):
        return None if self.bias is None else self.bias.to(dtype)


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q [O, ...] int8 times scale [O] in float32: one elementwise op."""
    return q * scale.view((-1,) + (1,) * (q.ndim - 1))


dequantize_weight.calls = 0  # the quantized modules' per-call dequantizes since the last reset


def _refuse_training(module: nn.Module) -> None:
    if module.training or torch.is_grad_enabled():
        raise RuntimeError(
            f"{type(module).__name__} holds int8 weights and serves only: call the model in "
            "eval mode under torch.inference_mode() or torch.no_grad() (the quantized path "
            "is export-only; train the float checkpoint)")


class QuantConv2d(_Quantized):
    """A conv on int8 weights dequantized at each call (module docstring)."""

    def __init__(self, conv: nn.Conv2d, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        if conv.padding_mode != "zeros":
            raise ValueError(f"padding_mode {conv.padding_mode!r} is not served quantized")
        for name in ("in_channels", "out_channels", "kernel_size", "stride", "padding",
                     "dilation", "groups"):
            setattr(self, name, getattr(conv, name))
        self._init_weight(q, scale, conv.bias)

    def forward(self, x):
        w = self.dequantized_weight(x.dtype)
        return nn.functional.conv2d(x, w, self._bias(x.dtype), self.stride, self.padding,
                                    self.dilation, self.groups)


class QuantLinear(_Quantized):
    """A dense layer on int8 weights dequantized at each call."""

    def __init__(self, linear: nn.Linear, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self._init_weight(q, scale, linear.bias)

    def forward(self, x):
        return nn.functional.linear(x, self.dequantized_weight(x.dtype), self._bias(x.dtype))


def quantized_modules(model: nn.Module) -> Iterator[Tuple[str, _Quantized]]:
    """(name, module) of every quantized module of `model`, in module order."""
    for name, mod in model.named_modules():
        if isinstance(mod, _Quantized):
            yield name, mod


def _replace(model: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, leaf, new)


def quantize_modules(model: nn.Module,
                     weights: Mapping[str, Tuple[np.ndarray, np.ndarray]]) -> nn.Module:
    """Replace each module named in `weights` ({module name: (int8 q, f32
    scale)}) by its quantized form, in place, on the module's device; the
    float weight goes with the module it belonged to. Returns `model`."""
    mods = dict(model.named_modules())
    for name, (q, scale) in weights.items():
        mod = mods[name]
        if not is_quantizable(mod):
            raise ValueError(f"{name} is a {type(mod).__name__}, not a conv or dense layer")
        dev = mod.weight.device
        q_t = torch.from_numpy(np.ascontiguousarray(q)).to(dev)
        s_t = torch.from_numpy(np.ascontiguousarray(scale)).to(dev)
        cls = QuantConv2d if isinstance(mod, nn.Conv2d) else QuantLinear
        _replace(model, name, cls(mod, q_t, s_t))
    return model


def quantized_skeleton(model: nn.Module) -> nn.Module:
    """Every conv and dense layer of `model` replaced, in place, by a
    quantized module of its shape holding zeros and unit scales, for
    `load_state_dict` of an int8 artifact's weights. Returns `model`."""
    weights = {}
    for name, mod in model.named_modules():
        if is_quantizable(mod):
            shape = tuple(mod.weight.shape)
            weights[name] = (np.zeros(shape, np.int8), np.ones(shape[0], np.float32))
    return quantize_modules(model, weights)


def dequantized_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An int8 state_dict with each (`qweight`, `scale`) pair replaced by the
    f32 `weight` the quantized module computes with, bit for bit (the
    dequantize-on-load twin's weights); other entries as they are."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if key.endswith(".scale") and key[:-len("scale")] + "qweight" in state:
            continue
        if key.endswith(".qweight"):
            prefix = key[:-len("qweight")]
            out[prefix + "weight"] = dequantize_weight(value, state[prefix + "scale"])
        else:
            out[key] = value
    return out
