"""Carry the JAX package's weights across: flax variables -> the port's state_dict.

The inverse of mgproto_tpu/models/convert.py (torch -> flax), written anew:
  * conv kernel [kh, kw, I, O] -> weight [O, I, kh, kw];
  * Dense kernel [I, O] -> weight [O, I];
  * BatchNorm params scale/bias + batch_stats mean/var ->
    weight/bias/running_mean/running_var (+ num_batches_tracked = 0);
  * flax module names -> torchvision names: `layer1_0` -> `layer1.0`,
    `downsample_conv`/`downsample_bn` -> `downsample.0`/`downsample.1`.
Inputs are numpy arrays (`jax.device_get` of the variables), so this module
needs no JAX. `from_jax_train_state` carries a whole JAX `TrainState`
across: params (net and proxies), batch stats, GMM, memory bank and step.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from mgproto_tpu_torch.config import Config
from mgproto_tpu_torch.core.memory import Memory
from mgproto_tpu_torch.core.mgproto import GMMState
from mgproto_tpu_torch.core.state import TrainState, create_train_state

_RENAMES = (
    (re.compile(r"^layer(\d+)_(\d+)$"), r"layer\1.\2"),
    (re.compile(r"^downsample_conv$"), "downsample.0"),
    (re.compile(r"^downsample_bn$"), "downsample.1"),
)


def _torch_name(part: str) -> str:
    for pat, rep in _RENAMES:
        part = pat.sub(rep, part)
    return part


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def from_jax_variables(
    variables: Mapping[str, Any], gmm: Any
) -> Tuple[Dict[str, torch.Tensor], GMMState]:
    """Flax `{params, batch_stats}` of an MGProtoFeatures (top-level
    `features`/`add_on`/`embedding`) plus a GMMState-like object (attributes
    means/sigmas/priors/keep) -> (the port's MGProtoFeatures state_dict,
    the port's GMMState on the CPU)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _walk(variables["params"]):
        mod = ".".join(_torch_name(p) for p in path[:-1])
        leaf = path[-1]
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            sd[f"{mod}.weight"] = torch.from_numpy(np.ascontiguousarray(arr))
        elif leaf == "scale":  # BatchNorm
            sd[f"{mod}.weight"] = torch.from_numpy(np.array(arr))
            sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "bias":
            sd[f"{mod}.bias"] = torch.from_numpy(np.array(arr))
        else:
            raise ValueError(f"unexpected flax parameter {'/'.join(path)}")
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _walk(variables.get("batch_stats", {})):
        mod = ".".join(_torch_name(p) for p in path[:-1])
        if path[-1] not in stat_names:
            raise ValueError(f"unexpected flax batch stat {'/'.join(path)}")
        sd[f"{mod}.{stat_names[path[-1]]}"] = torch.from_numpy(np.array(arr))
    torch_gmm = GMMState(
        means=torch.from_numpy(np.array(gmm.means, np.float32)),
        sigmas=torch.from_numpy(np.array(gmm.sigmas, np.float32)),
        priors=torch.from_numpy(np.array(gmm.priors, np.float32)),
        keep=torch.from_numpy(np.array(gmm.keep, bool)),
    )
    return sd, torch_gmm


def from_jax_train_state(
    state: Any, cfg: Config, device: Union[str, torch.device, None] = None,
) -> TrainState:
    """A JAX `TrainState` (numpy leaves: `jax.device_get(state)`) -> the
    port's `TrainState` on `device`, built for `cfg`: the model's weights
    and BatchNorm statistics, the proxies, the GMM (its means become the
    mean optimizer's leaf), the memory bank (feats/length/cursor/updated)
    and `step`. Optimizer moments start at zero."""
    new = create_train_state(cfg, torch.Generator().manual_seed(0), device)
    dev = new.gmm.means.device
    sd, gmm = from_jax_variables(
        {"params": state.params["net"], "batch_stats": state.batch_stats}, state.gmm
    )
    new.model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        new.proxies.copy_(torch.from_numpy(np.array(state.params["proxies"], np.float32)))
        new.gmm.means.copy_(gmm.means)
    new.gmm = new.gmm._replace(
        sigmas=gmm.sigmas.to(dev), priors=gmm.priors.to(dev), keep=gmm.keep.to(dev)
    )
    mem = state.memory
    new.memory = Memory(
        feats=torch.from_numpy(np.array(mem.feats, np.float32)).to(dev),
        length=torch.from_numpy(np.array(mem.length, np.int32)).to(dev),
        cursor=torch.from_numpy(np.array(mem.cursor, np.int32)).to(dev),
        updated=torch.from_numpy(np.array(mem.updated, bool)).to(dev),
    )
    new.step = int(np.asarray(state.step))
    return new
