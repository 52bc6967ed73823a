"""QuantPolicy and per-channel int8 weight-only quantization (counterpart
of mgproto_tpu/perf/quant.py; a copy of its numpy math, nothing imported).

`cli.export --quantize int8` rounds the weight of every conv and dense
layer of the model (the parameters whose JAX counterparts are `kernel`
leaves of rank >= 2) to int8 with one float32 scale per output channel:
symmetric, `scale = amax / 127`, a dead channel (amax 0) gets scale 1.0 so
its zeros round-trip exactly, and the round trip is within scale / 2 of the
weight. The output channel is axis 0 here (OIHW convs, [out, in] dense
layers), the last axis in the JAX package: the int8 values and the scales
are bit-equal to JAX's after that transpose. The served model holds them
as models/quantized.py's modules, which dequantize at each call.

What is never quantized, by type: the GMM (means, sigmas, priors), BatchNorm
weights, biases and statistics, the proxies, density and log p(x), and the
calibration. `QuantPolicy` refuses to demote them, as JAX's does.

`quantize_model` plays the part of JAX's `quantize_params`: it returns a
`QuantizedModel` with the quantized copy of the model, the per-parameter
report and the same byte accounting, and `quant_config()` is the meta.json
block. The accounting runs over the parameters JAX's `state.params` holds:
the model's and, given them, the proxies. Every key of the block equals
JAX's on the same carried state but `fingerprint`, which is this package's
own sha256 over its own tensors (as `gmm_fingerprint` is).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mgproto_tpu_torch.models.quantized import is_quantizable, quantize_modules, quantized_modules

QUANT_FORMAT = "mgproto-quant-v1"
SUPPORTED_QUANT_MODES = ("none", "int8")

# the serving-seam identity of the one supported scheme; "" = unquantized
QUANT_TAG_INT8 = "int8:per_channel:symmetric"


class QuantError(ValueError):
    """A request violated the quantization policy's f32 invariants."""


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """What may be quantized, stated as a type. Only `mode` is a knob; the
    f32 fields are stated so the trust plane's scale cannot be demoted."""

    mode: str = "none"  # conv and dense weights: none | int8
    granularity: str = "per_channel"  # one f32 scale per output channel
    symmetric: bool = True  # no zero point
    gmm_dtype: str = "float32"  # mixture banks / means / priors
    score_dtype: str = "float32"  # density / log p(x) math
    calibration_dtype: str = "float32"  # serving threshold math

    def __post_init__(self):
        if self.mode not in SUPPORTED_QUANT_MODES:
            raise QuantError(
                f"quantize mode must be one of {SUPPORTED_QUANT_MODES}, "
                f"got {self.mode!r}"
            )
        if self.granularity != "per_channel":
            raise QuantError(
                "granularity is not a knob: per-tensor scales lose the "
                "per-output-channel dynamic range conv kernels need "
                f"(got {self.granularity!r})"
            )
        if not self.symmetric:
            raise QuantError(
                "asymmetric quantization is not a knob: a zero point adds "
                "an integer add to the fused dequant path for no benefit "
                "on zero-centered weight distributions"
            )
        for field in ("gmm_dtype", "score_dtype", "calibration_dtype"):
            if getattr(self, field) != "float32":
                raise QuantError(
                    f"{field} is not a knob: it must stay float32 "
                    f"(got {getattr(self, field)!r}); quantizing the GMM/"
                    "score/calibration path shifts the p(x) scale every "
                    "trust threshold depends on"
                )

    @property
    def quantized(self) -> bool:
        return self.mode != "none"

    @property
    def tag(self) -> str:
        """Serving-seam identity ("" for f32: it matches an unstamped
        calibration by construction)."""
        return QUANT_TAG_INT8 if self.mode == "int8" else ""


def resolve_quant_policy(mode: str) -> QuantPolicy:
    """The policy a `--quantize MODE` flag implies."""
    return QuantPolicy(mode=str(mode or "none"))


def quantize_array(w) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: (q [int8, w.shape], scale [f32,
    w.shape[0]]). The output channel is axis 0 (OIHW convs, [out, in]
    dense layers). A dead channel (amax == 0) gets scale 1.0."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=tuple(range(1, w.ndim)))
    scale = np.where(amax > 0.0, amax / 127.0, 1.0).astype(np.float32)
    bscale = scale.reshape((-1,) + (1,) * (w.ndim - 1))
    q = np.clip(np.rint(w / bscale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_array(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """The inverse the served modules compute at each call."""
    q = np.asarray(q)
    return q.astype(np.float32) * np.asarray(scale, np.float32).reshape((-1,) + (1,) * (q.ndim - 1))


def _eligible(model: nn.Module) -> set:
    """Parameter names of the weights that quantize."""
    return {f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules() if is_quantizable(mod)}


def _leaves(model: nn.Module, proxies: Optional[torch.Tensor]):
    """(name, tensor) of what JAX's `state.params` holds: the model's
    parameters and, given them, the proxies."""
    yield from model.named_parameters()
    if proxies is not None:
        yield "proxies", proxies


def quant_fingerprint(state: Mapping[str, torch.Tensor]) -> str:
    """sha256 over each (`qweight`, `scale`) pair of an int8 state_dict, in
    its order (contiguous bytes, so the memory format does not count)."""
    h = hashlib.sha256(b"mgproto_tpu_torch.quant")
    for key, q in state.items():
        if key.endswith(".qweight"):
            scale = state[key[:-len("qweight")] + "scale"]
            for t in (q, scale):
                h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class QuantizedModel:
    """A quantized copy of a model: `model` (models/quantized.py's modules
    in place of the eligible layers; the caller's model when nothing was
    quantized), `proxies` as given, and one report row per parameter
    (`path`, `shape`, `quantized`, `f32_bytes`, `quant_bytes`)."""

    policy: QuantPolicy
    model: nn.Module
    proxies: Optional[torch.Tensor]
    report: Tuple[Dict[str, Any], ...]

    @property
    def num_quantized(self) -> int:
        return sum(1 for r in self.report if r["quantized"])

    @property
    def num_skipped(self) -> int:
        return sum(1 for r in self.report if not r["quantized"])

    @property
    def f32_weight_bytes(self) -> int:
        """f32 bytes of the quantized weights only."""
        return sum(r["f32_bytes"] for r in self.report if r["quantized"])

    @property
    def quantized_weight_bytes(self) -> int:
        """int8 + scale bytes of the quantized weights."""
        return sum(r["quant_bytes"] for r in self.report if r["quantized"])

    @property
    def total_weight_bytes(self) -> int:
        """Resident weight bytes of the quantized model (quantized weights
        as int8 + scales, the rest as f32)."""
        return sum(r["quant_bytes"] for r in self.report)

    @property
    def total_f32_bytes(self) -> int:
        """Resident weight bytes of the f32 model."""
        return sum(r["f32_bytes"] for r in self.report)

    def fingerprint(self) -> str:
        return quant_fingerprint(self.model.state_dict())

    def quant_config(self) -> Dict[str, Any]:
        """The meta.json provenance block; `tag` is what the calibration is
        stamped with and what the serving gate matches."""
        return {
            "format": QUANT_FORMAT,
            "mode": self.policy.mode,
            "granularity": self.policy.granularity,
            "symmetric": self.policy.symmetric,
            "tag": self.policy.tag,
            "num_quantized": self.num_quantized,
            "num_skipped": self.num_skipped,
            "f32_weight_bytes": int(self.f32_weight_bytes),
            "quantized_weight_bytes": int(self.quantized_weight_bytes),
            "total_weight_bytes": int(self.total_weight_bytes),
            "total_f32_bytes": int(self.total_f32_bytes),
            "fingerprint": self.fingerprint(),
        }


def quantize_model(model: nn.Module, policy: Optional[QuantPolicy] = None,
                   proxies: Optional[torch.Tensor] = None) -> QuantizedModel:
    """Quantize `model`'s conv and dense weights under `policy` (default
    int8) into a copy of it, on the host once, at export. With mode "none"
    nothing is quantized and the model is the caller's own. `proxies` (the
    state's, when its aux loss has them) join the accounting as an f32
    leaf, as they are one of JAX's `state.params`."""
    policy = policy or QuantPolicy(mode="int8")
    eligible = _eligible(model) if policy.quantized else set()
    rows, weights = [], {}
    for name, p in _leaves(model, proxies):
        f32_bytes = int(p.numel() * 4)
        row = {"path": name, "shape": list(p.shape), "quantized": name in eligible,
               "f32_bytes": f32_bytes, "quant_bytes": f32_bytes}
        if row["quantized"]:
            q, scale = quantize_array(p)
            weights[name[:-len(".weight")]] = (q, scale)
            row["quant_bytes"] = int(q.nbytes + scale.nbytes)
        rows.append(row)
    qmodel = quantize_modules(copy.deepcopy(model), weights) if weights else model
    return QuantizedModel(policy=policy, model=qmodel, proxies=proxies, report=tuple(rows))


def weight_rows(model: nn.Module, proxies: Optional[torch.Tensor] = None
                ) -> List[Dict[str, Any]]:
    """`quantize_model`'s report rows by shape math (no values read, so a
    model on the meta device works): per parameter, its f32 bytes and its
    bytes as int8 + per-channel scales where it would be quantized."""
    eligible = _eligible(model)
    rows = []
    for name, p in _leaves(model, proxies):
        n = int(p.numel())
        quantized = name in eligible
        rows.append({"path": name, "shape": list(p.shape), "quantized": quantized,
                     "f32_bytes": n * 4,
                     "quant_bytes": n + int(p.shape[0]) * 4 if quantized else n * 4})
    return rows


def weight_bytes_report(model: nn.Module, proxies: Optional[torch.Tensor] = None
                        ) -> Dict[str, int]:
    """Shape-math weight bytes: what the float model's weights cost
    resident as f32 and as int8 + per-channel scales (`weight_rows`)."""
    rows = weight_rows(model, proxies)
    return {"f32_bytes": int(sum(r["f32_bytes"] for r in rows)),
            "int8_bytes": int(sum(r["quant_bytes"] for r in rows))}


def quantized_param_bytes(f32_bytes: int, model: nn.Module, proxies: Optional[torch.Tensor],
                          mode: str) -> Optional[int]:
    """`f32_bytes` of the parameters (or a per-rank share of them) as `mode`
    holds them: scaled by `weight_bytes_report`'s int8 / f32 ratio of the
    whole tree, rounded (the JAX planner's int8 term). None for a mode that
    quantizes nothing; an unknown mode raises QuantError."""
    if resolve_quant_policy(mode).mode != "int8":
        return None
    rep = weight_bytes_report(model, proxies)
    if not rep["f32_bytes"]:
        return int(f32_bytes)
    return int(round(f32_bytes * rep["int8_bytes"] / rep["f32_bytes"]))


def resident_weight_bytes(model: nn.Module, proxies: Optional[torch.Tensor] = None) -> int:
    """Storage bytes of what the accounting counts, as the model holds it
    (each parameter, each quantized module's int8 weight and scale, the
    proxies), each storage counted once: equals `quant_config()[
    "total_weight_bytes"]` of a quantized model when no f32 copy of a
    quantized weight is held."""
    tensors = list(model.parameters())
    for _, mod in quantized_modules(model):
        tensors += [mod.qweight, mod.scale]
    if proxies is not None:
        tensors.append(proxies)
    storages = {(t.device, t.untyped_storage().data_ptr()): t.untyped_storage().nbytes()
                for t in tensors}
    return int(sum(storages.values()))
