"""Serving artifacts: one file that a serving process loads without a
checkpoint or a training run (counterpart of mgproto_tpu/engine/export.py).

The JAX package's `.mgproto` holds a StableHLO program with the weights
inlined. This package cannot write that, and neither `torch.export` nor
TorchScript captures its kernels (they are reached through ctypes,
`ops/_build.py`). So its artifact is a zip, by the same name convention,
holding

  weights.pt        the model's state_dict and the GMM (means, sigmas,
                    priors, keep): tensors only, read back with
                    `torch.load(..., weights_only=True)`; no pickled code;
                    stored, not deflated (float weights barely compress,
                    and inflating them would slow every load and swap);
  meta.json         the JAX `artifact_meta` keys with `format`
                    "mgproto-torch-artifact-v1", the full model config
                    (`model_config`), `gmm_fingerprint` (the port's own,
                    serving/calibration.py) and `static_batch` where one was
                    set;
  calibration.json  optional, JAX's schema (`Calibration.to_json`);
  explain.json      optional, JAX's explanation table (priors and push
                    provenance per flat prototype index).

An int8 artifact (`cli.export --quantize int8`, perf/quant.py) writes the
meta.json block `quant_config` (JAX's keys; with `--quantize none` the key is
not written and the zip's entries are byte for byte what they were). Its
weights.pt holds each quantized conv and dense weight as an int8 `qweight`
with its f32 `scale` (models/quantized.py) and no f32 copy of it, and, when
the state had them, the proxies under `proxies`, so it carries every tensor
its `quant_config` accounts for. `load_artifact` rebuilds the quantized
model, which dequantizes at each call, and refuses weights whose
`quant_fingerprint` is not meta.json's; `dequantize=True` builds the
ordinary f32 model on the dequantized values instead (the twin of JAX's
`dequant.stablehlo`).

`load_artifact` rebuilds the model through models/registry.py on the device
given: it serves through the score_pool and BN epilogue kernels on CUDA and
their plain versions on the CPU (the JAX export forces its portable scoring
path instead). A JAX artifact (it holds `model.stablehlo`) is refused with
`ArtifactFormatError`, which names its format. A `static_batch` artifact
refuses other batch sizes.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import zipfile
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from mgproto_tpu_torch.config import Config, ModelConfig
from mgproto_tpu_torch.core.mgproto import GMMState, build_mgproto, make_features
from mgproto_tpu_torch.engine.eval import Evaluator
from mgproto_tpu_torch.models.quantized import dequantized_state_dict, quantized_skeleton
from mgproto_tpu_torch.numerics import resolve_device
from mgproto_tpu_torch.perf.precision import policy_meta, resolve_policy
from mgproto_tpu_torch.perf.quant import quant_fingerprint
from mgproto_tpu_torch.serving.calibration import Calibration, gmm_fingerprint

FORMAT = "mgproto-torch-artifact-v1"
EXPLAIN_FORMAT = "mgproto-explain-v1"
_WEIGHTS = "weights.pt"
_META = "meta.json"
_CALIB = "calibration.json"
_EXPLAIN = "explain.json"
_JAX_PROGRAM = "model.stablehlo"  # the JAX package's artifact


class ArtifactFormatError(ValueError):
    """Not an artifact this package serves (a JAX `.mgproto`, another
    format, or a file that is no artifact)."""


def artifact_meta(cfg: Config, checkpoint_path: Optional[str], gmm_fp: str,
                  static_batch: Optional[int] = None,
                  quant: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """meta.json: JAX's keys, this package's format and the model config;
    `quant` (a `QuantizedModel.quant_config()`) as `quant_config`, which is
    not written when None."""
    m = cfg.model
    meta = {
        "gmm_fingerprint": gmm_fp,
        "static_batch": int(static_batch) if static_batch else None,
        "format": FORMAT,
        "arch": m.arch,
        "num_classes": m.num_classes,
        "prototypes_per_class": m.prototypes_per_class,
        "proto_dim": m.proto_dim,
        "img_size": m.img_size,
        "compute_dtype": m.compute_dtype,
        "precision_policy": policy_meta(resolve_policy(cfg)),
        "input": "float32 [batch, img_size, img_size, 3], normalized",
        "outputs": {
            "logits": "[batch, num_classes] class log-likelihoods log p(x|c)",
            "log_px": "[batch] generative OoD score log p(x)",
        },
        "dynamic_batch": not static_batch,
        "checkpoint": checkpoint_path,
        "torch_version": torch.__version__,
        "model_config": dataclasses.asdict(m),
    }
    if quant is not None:
        meta["quant_config"] = quant
    return meta


def quant_tag(meta: Dict[str, Any]) -> str:
    """The serving-seam quant identity of an artifact's meta.json (its
    `quant_config` tag; "" for an unquantized artifact)."""
    return str((meta.get("quant_config") or {}).get("tag") or "")


def explain_table(gmm: GMMState, provenance: Optional[Dict[str, Any]] = None,
                  top_e: Optional[int] = None) -> Dict[str, Any]:
    """explain.json: flat-indexed priors and the optional push provenance
    (engine/push.py `provenance_dict`), JAX's `explain_table` schema, plus
    `top_e`, the explanation depth chosen at export (JAX bakes it into its
    explain program)."""
    c, k = gmm.priors.shape
    table: Dict[str, Any] = {
        "format": EXPLAIN_FORMAT,
        "num_classes": int(c),
        "k_per_class": int(k),
        "priors": [round(float(v), 8) for v in gmm.priors.detach().cpu().reshape(-1).tolist()],
        "provenance": None,
    }
    if top_e is not None:
        table["top_e"] = int(top_e)
    if provenance is not None:
        for key in ("image_id", "spatial_idx", "log_prob"):
            if key not in provenance:
                raise ValueError(f"provenance dict missing {key!r} (expected the "
                                 "engine/push.py::provenance_dict shape)")
        table["provenance"] = {
            "image_id": [int(v) for v in np.asarray(provenance["image_id"]).reshape(-1)],
            "spatial_idx": [int(v) for v in np.asarray(provenance["spatial_idx"]).reshape(-1)],
            "log_prob": [round(float(v), 6) for v in np.asarray(provenance["log_prob"]).reshape(-1)],
        }
    return table


def _calib_json(calibration: Union[Calibration, Dict]) -> str:
    if isinstance(calibration, dict):
        return json.dumps(calibration, indent=2, sort_keys=True)
    return calibration.to_json()


def save_artifact(path: str, model: torch.nn.Module, gmm: GMMState, meta: Dict[str, Any],
                  calibration: Union[Calibration, Dict, None] = None,
                  explain: Optional[Dict[str, Any]] = None,
                  proxies: Optional[torch.Tensor] = None) -> None:
    """Write the zip (module docstring), through `path.tmp` and a rename.
    `proxies` are written only into an int8 artifact."""
    buf = io.BytesIO()
    payload = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
               "gmm": {k: v.detach().cpu() for k, v in gmm._asdict().items()}}
    if proxies is not None:
        if not quant_tag(meta):
            raise ValueError("proxies are written only into an int8 artifact")
        payload["proxies"] = proxies.detach().cpu()
    torch.save(payload, buf)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_DEFLATED) as z:
        z.writestr(_WEIGHTS, buf.getvalue(), compress_type=zipfile.ZIP_STORED)
        z.writestr(_META, json.dumps(meta, indent=2, sort_keys=True))
        if calibration is not None:
            z.writestr(_CALIB, _calib_json(calibration))
        if explain is not None:
            z.writestr(_EXPLAIN, json.dumps(explain, indent=2, sort_keys=True))
    os.replace(tmp, path)


def embed_calibration(path: str, calibration: Union[Calibration, Dict]) -> None:
    """Add or replace the artifact's calibration (a recalibration needs no
    re-export); rewrites the zip atomically."""
    tmp = path + ".tmp"
    with zipfile.ZipFile(path) as src, \
            zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_DEFLATED) as dst:
        for name in src.namelist():
            if name != _CALIB:
                dst.writestr(src.getinfo(name), src.read(name))  # keeps its compression
        dst.writestr(_CALIB, _calib_json(calibration))
    os.replace(tmp, path)


def read_meta(path: str) -> Dict[str, Any]:
    """meta.json of a port artifact; `ArtifactFormatError` for anything else."""
    try:
        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
            meta = json.loads(z.read(_META)) if _META in names else {}
    except zipfile.BadZipFile as e:
        raise ArtifactFormatError(f"{path} is not an artifact zip: {e}")
    fmt = meta.get("format")
    if _JAX_PROGRAM in names:
        raise ArtifactFormatError(
            f"{path} is a JAX artifact (format {fmt!r}, a StableHLO program): the PyTorch "
            f"port serves only {FORMAT!r} artifacts; export the checkpoint with "
            "`python -m mgproto_tpu_torch.cli.export`")
    if fmt != FORMAT or _WEIGHTS not in names:
        raise ArtifactFormatError(f"{path}: format {fmt!r} is not {FORMAT!r}")
    return meta


def load_calibration(path: str) -> Optional[Calibration]:
    with zipfile.ZipFile(path) as z:
        if _CALIB not in z.namelist():
            return None
        return Calibration.from_json(z.read(_CALIB).decode())


def load_explain_table(path: str) -> Optional[Dict[str, Any]]:
    with zipfile.ZipFile(path) as z:
        if _EXPLAIN not in z.namelist():
            return None
        return json.loads(z.read(_EXPLAIN))


def model_config_of(meta: Dict[str, Any]) -> ModelConfig:
    """The artifact's ModelConfig, with the kernel routes left to the device
    it is loaded on (the kernels on CUDA, the plain versions elsewhere)."""
    kw = dict(meta["model_config"])
    kw["remat_stages"] = tuple(kw.get("remat_stages") or ())
    kw.update(fused_scoring=None, fused_epilogue=None, pretrained=False)
    return ModelConfig(**kw)


class LoadedArtifact(NamedTuple):
    """An artifact on a device: its Evaluator (model and GMM), meta.json,
    calibration and explanation table (None when absent), and the proxies
    an int8 artifact carries (None otherwise)."""

    evaluator: Evaluator
    meta: Dict[str, Any]
    calibration: Optional[Calibration]
    explain_table: Optional[Dict[str, Any]]
    proxies: Optional[torch.Tensor] = None

    @property
    def static_batch(self) -> Optional[int]:
        return self.meta.get("static_batch") or None

    def infer(self, images) -> Dict[str, np.ndarray]:
        """images [b, H, W, 3] -> {"logits", "log_px"} numpy; a static-batch
        artifact refuses any other b."""
        check_batch(self.static_batch, len(images))
        out = self.evaluator(images)
        return {"logits": out.logits.cpu().numpy(), "log_px": out.log_px.cpu().numpy()}


def check_batch(static_batch: Optional[int], n: int) -> None:
    if static_batch and n != static_batch:
        raise ValueError(f"this artifact was exported with static_batch={static_batch}; "
                         f"got a batch of {n}")


def load_artifact(path: str, device: Union[str, torch.device, None] = None,
                  split: Optional[Callable[[str], None]] = None,
                  dequantize: bool = False) -> LoadedArtifact:
    """Rebuild the artifact's model and GMM on `device` (CUDA unless the
    caller names another; raises without a card). An int8 artifact gives
    the quantized model, built on the host and moved with its weights still
    int8; `dequantize=True` gives its f32 twin instead (a no-op on an
    unquantized artifact). `split(part)`, when given, is called after the
    read ("artifact_read") and after the model is built and its weights
    copied ("model_build")."""
    meta = read_meta(path)
    with zipfile.ZipFile(path) as z:
        payload = torch.load(io.BytesIO(z.read(_WEIGHTS)), map_location="cpu", weights_only=True)
    calibration, table = load_calibration(path), load_explain_table(path)
    if split is not None:
        split("artifact_read")
    mcfg = model_config_of(meta)
    weights, proxies = payload["model"], None
    quant = meta.get("quant_config")
    if quant:
        if quant_fingerprint(weights) != quant.get("fingerprint"):
            raise ArtifactFormatError(f"{path}: weights.pt's int8 weights do not match "
                                      "meta.json's quant_config fingerprint")
        proxies = payload.get("proxies")
    if quant and not dequantize:
        model = quantized_skeleton(make_features(mcfg, resolve_device(device)))
        model.load_state_dict(weights, strict=True)
        model = model.to(device=resolve_device(device), memory_format=torch.channels_last).eval()
    else:
        model, _ = build_mgproto(mcfg, device=device)
        model.load_state_dict(dequantized_state_dict(weights) if quant else weights, strict=True)
    gmm = GMMState(**payload["gmm"])
    if gmm_fingerprint(gmm) != meta.get("gmm_fingerprint"):
        raise ArtifactFormatError(f"{path}: weights.pt's GMM does not match meta.json's "
                                  "gmm_fingerprint")
    ev = Evaluator(model, gmm, Config(model=mcfg), device=device)
    if split is not None:
        split("model_build")
    if proxies is not None:
        proxies = proxies.to(ev.device)
    return LoadedArtifact(ev, meta, calibration, table, proxies)


def make_explain_fn(evaluator: Evaluator, top_e: int = 5,
                    static_batch: Optional[int] = None) -> Callable[[Any], Dict[str, np.ndarray]]:
    """The explain inference function: images -> {"logits", "log_px",
    "proto_idx" [B, E], "proto_logd" [B, E]} numpy, most activated first
    (`engine/eval.explain_forward`)."""

    def infer(images) -> Dict[str, np.ndarray]:
        check_batch(static_batch, len(images))
        out = evaluator.explain(images, top_e)
        return {"logits": out.logits.cpu().numpy(), "log_px": out.log_px.cpu().numpy(),
                "proto_idx": out.proto_idx.cpu().numpy(),
                "proto_logd": out.proto_logd.cpu().numpy()}

    return infer
