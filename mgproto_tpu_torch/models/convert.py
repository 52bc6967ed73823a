"""Carry the JAX package's weights across: flax variables -> the port's state_dict.

The inverse of mgproto_tpu/models/convert.py (torch -> flax), written anew:
  * conv kernel [kh, kw, I, O] -> weight [O, I, kh, kw];
  * Dense kernel [I, O] -> weight [O, I];
  * BatchNorm params scale/bias + batch_stats mean/var ->
    weight/bias/running_mean/running_var (+ num_batches_tracked = 0);
  * flax module names -> torchvision names: `layer1_0` -> `layer1.0`,
    `downsample_conv`/`downsample_bn` -> `downsample.0`/`downsample.1`,
    `denseblock1_denselayer2` -> `denseblock1.denselayer2`, and a VGG
    trunk's `conv{j}`/`bn{j}` -> their index in torchvision's `features`
    Sequential (models/vgg.py `torch_indices`; only with `arch` naming a
    VGG, since the tiny trunk and the add-on have `conv{j}` names too).
Inputs are numpy arrays (`jax.device_get` of the variables), so this module
needs no JAX. `from_jax_train_state` carries a whole JAX `TrainState`
across: params (net and proxies), batch stats, GMM, memory bank, step, and
the three optimizers' state: optax `scale_by_adam`'s mu, nu and count per
group become each torch Adam parameter's exp_avg, exp_avg_sq and step (the
moments laid out as the weights are), and the joint schedule's count
becomes `joint_updates`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from mgproto_tpu_torch.config import Config
from mgproto_tpu_torch.core.memory import Memory
from mgproto_tpu_torch.core.mgproto import GMMState
from mgproto_tpu_torch.core.state import TrainState, create_train_state
from mgproto_tpu_torch.models import vgg
from mgproto_tpu_torch.models.registry import family

_RENAMES = (
    (re.compile(r"^layer(\d+)_(\d+)$"), r"layer\1.\2"),
    (re.compile(r"^downsample_conv$"), "downsample.0"),
    (re.compile(r"^downsample_bn$"), "downsample.1"),
    (re.compile(r"^denseblock(\d+)_denselayer(\d+)$"), r"denseblock\1.denselayer\2"),
)


def _torch_name(part: str) -> str:
    for pat, rep in _RENAMES:
        part = pat.sub(rep, part)
    return part


def _vgg_names(arch: Optional[str]) -> Optional[Dict[str, str]]:
    """{flax `conv{j}`/`bn{j}`: torchvision index} of a VGG trunk's layers;
    None when `arch` is not a VGG."""
    if not arch or family(arch) != "vgg":
        return None
    return vgg.torch_names(arch)


def _module_name(parts: Tuple[str, ...], vgg_names: Optional[Dict[str, str]]) -> str:
    """A flax module path -> the torch module name."""
    if vgg_names is not None and len(parts) == 2 and parts[0] == "features":
        parts = (parts[0], vgg_names[parts[1]])
    return ".".join(_torch_name(p) for p in parts)


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()):
    """(path, array) of every array leaf; other leaves (optax's MaskedNode
    where a group does not hold a parameter) are skipped."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (str(k),))
        elif hasattr(v, "shape"):
            yield prefix + (str(k),), np.asarray(v)


def _find_states(tree: Any, fields: Tuple[str, ...]) -> List[Any]:
    """Every optax state NamedTuple with exactly `fields` inside `tree`
    (NamedTuples, tuples and dicts), in depth-first order."""
    if getattr(tree, "_fields", None) == fields:
        return [tree]
    if isinstance(tree, Mapping):
        children = tree.values()
    elif isinstance(tree, tuple):
        children = tree
    else:
        return []
    return [s for child in children for s in _find_states(child, fields)]


def _adam_of(group_state: Any) -> Any:
    """The one `ScaleByAdamState` (count, mu, nu) of an optax chain."""
    found = _find_states(group_state, ("count", "mu", "nu"))
    if len(found) != 1:
        raise ValueError(f"expected one scale_by_adam state, found {len(found)}")
    return found[0]


def _load_adam_state(opt: torch.optim.Adam, param: torch.Tensor, mu: np.ndarray,
                     nu: np.ndarray, count: int) -> None:
    """Give `param` the Adam state optax's (mu, nu, count) describe. The
    moments are made as torch makes them (`zeros_like`, the parameter's
    memory layout) and copied into; count 0 leaves the state empty, which
    torch reads as zero moments."""
    if count == 0:
        return
    exp_avg = torch.zeros_like(param, memory_format=torch.preserve_format)
    exp_avg_sq = torch.zeros_like(param, memory_format=torch.preserve_format)
    exp_avg.copy_(torch.from_numpy(np.array(mu, np.float32)).reshape(param.shape))
    exp_avg_sq.copy_(torch.from_numpy(np.array(nu, np.float32)).reshape(param.shape))
    opt.state[param] = {"step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}


def _load_group_states(opt: torch.optim.Adam, inner_states: Mapping, model,
                       proxies: torch.Tensor, groups: Tuple[str, ...],
                       vgg_names: Optional[Dict[str, str]] = None) -> None:
    """The optax `multi_transform` groups `groups` -> torch Adam state for
    the parameters they hold (net weights by name, and the proxies where
    there are any), matched by name, not by position. A group the JAX state
    lacks (`aux` without proxies) is skipped. A moment of a parameter `opt` does not train (the embedding of
    a state trained with the JAX `OptimConfig.train_embedding`, which the
    port does not carry) is refused."""
    params = dict(model.named_parameters())
    trained = {id(p) for group in opt.param_groups for p in group["params"]}
    for g in groups:
        if g not in inner_states:
            continue
        adam = _adam_of(inner_states[g])
        count = int(np.asarray(adam.count))
        # mu and nu share one tree structure, so their walks pair up
        for (path, mu), (_, nu) in zip(_walk(adam.mu.get("net", {})),
                                       _walk(adam.nu.get("net", {}))):
            name, mu_t = _weight_name(path, mu, vgg_names)
            if id(params[name]) not in trained:
                raise ValueError(f"the JAX state trains {name} in its {g!r} group; the port "
                                 "keeps it frozen (train_embedding is not ported)")
            _load_adam_state(opt, params[name], mu_t, _weight_name(path, nu, vgg_names)[1],
                             count)
        if proxies is not None and hasattr(adam.mu.get("proxies"), "shape"):
            _load_adam_state(opt, proxies, np.asarray(adam.mu["proxies"]),
                             np.asarray(adam.nu["proxies"]), count)


def _weight_name(path: Tuple[str, ...], arr: np.ndarray,
                 vgg_names: Optional[Dict[str, str]] = None) -> Tuple[str, np.ndarray]:
    """A flax parameter path and value -> the torch name and value: conv
    kernels [kh, kw, I, O] -> [O, I, kh, kw], Dense kernels [I, O] -> [O, I],
    BatchNorm scale -> weight."""
    mod = _module_name(path[:-1], vgg_names)
    leaf = path[-1]
    if leaf == "kernel":
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        return f"{mod}.weight", np.ascontiguousarray(arr)
    if leaf == "scale":
        return f"{mod}.weight", np.array(arr)
    if leaf == "bias":
        return f"{mod}.bias", np.array(arr)
    raise ValueError(f"unexpected flax parameter {'/'.join(path)}")


def from_jax_variables(
    variables: Mapping[str, Any], gmm: Any, arch: Optional[str] = None,
) -> Tuple[Dict[str, torch.Tensor], GMMState]:
    """Flax `{params, batch_stats}` of an MGProtoFeatures (top-level
    `features`/`add_on`/`embedding`) plus a GMMState-like object (attributes
    means/sigmas/priors/keep) -> (the port's MGProtoFeatures state_dict,
    the port's GMMState on the CPU). `arch` is needed for a VGG trunk,
    whose layer names depend on its cfg."""
    vgg_names = _vgg_names(arch)
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _walk(variables["params"]):
        name, value = _weight_name(path, arr, vgg_names)
        sd[name] = torch.from_numpy(value)
        if path[-1] == "scale":  # BatchNorm
            mod = name.removesuffix(".weight")
            sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _walk(variables.get("batch_stats", {})):
        mod = _module_name(path[:-1], vgg_names)
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
    mean optimizer's leaf), the memory bank (feats/length/cursor/updated),
    `step`, and the optimizer state: the joint optimizer's `features`,
    `add_on` and `aux` Adam moments and counts (and its schedule count as
    `joint_updates`), the warm optimizer's `add_on` and `aux`, and the mean
    optimizer's, each moment laid out as its parameter. A state without
    proxies (a pair aux loss) needs a `cfg` whose aux loss has none, and
    the other way round."""
    new = create_train_state(cfg, torch.Generator().manual_seed(0), device, for_restore=True)
    if ("proxies" in state.params) != (new.proxies is not None):
        raise ValueError(
            f"the JAX state {'has' if 'proxies' in state.params else 'has no'} proxies but "
            f"aux_loss {cfg.loss.aux_loss!r} {'has none' if new.proxies is None else 'has'}")
    dev = new.gmm.means.device
    arch = cfg.model.arch
    sd, gmm = from_jax_variables(
        {"params": state.params["net"], "batch_stats": state.batch_stats}, state.gmm, arch
    )
    new.model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        if new.proxies is not None:
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
    joint = state.opt_state.inner_states
    vgg_names = _vgg_names(arch)
    _load_group_states(new.opt, joint, new.model, new.proxies, ("features", "add_on", "aux"),
                       vgg_names)
    _load_group_states(new.warm_opt, state.warm_opt_state.inner_states, new.model, new.proxies,
                       ("add_on", "aux"), vgg_names)
    (sched,) = _find_states(joint["features"], ("count",))  # the staircase's count
    new.joint_updates = int(np.asarray(sched.count))
    mean_adam = _adam_of(state.proto_opt_state)
    _load_adam_state(new.mean_opt, new.gmm.means, np.asarray(mean_adam.mu),
                     np.asarray(mean_adam.nu), int(np.asarray(mean_adam.count)))
    return new
