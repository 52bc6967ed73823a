"""Where each part of the train state lives on the mesh (counterpart of
mgproto_tpu/parallel/sharding.py).

  * batches: sharded over EVERY rank, data and model axes alike (the JAX
    `batch_spec`): rank r takes rows [r*b, (r+1)*b) of a global batch of
    b*world rows (`put_batch`), which is what the sharded loader gives it
    (data/__init__.py).
  * the GMM, the memory bank and the mean optimizer's Adam state: the
    CLASS axis over 'model' (rule "class"): each rank holds the slab
    [c0, c1) of `Mesh.class_slab`, scores it, enqueues into it and runs EM
    on it (core/em.py). A class axis that 'model' does not divide stays
    whole on every rank, as the JAX rule replicates it.
  * the parameters and their Adam moments (rule "param"): JAX's per-param
    map puts each array's largest axis that 'model' divides on 'model'.
    `state_partition_specs` computes that layout, on the JAX package's
    array layouts (conv kernels HWIO, Dense kernels [in, out]), expressed
    in the port's axes; the trainer still places these leaves replicated,
    the layout JAX has at model axis 1 (model-axis sharding of the
    parameters is ROADMAP A item 5's remainder). BatchNorm's running
    statistics, the step counters: replicated.

Every TrainState field has an entry in `SHARDING_RULES`, and
`state_partition_specs` refuses a field without one
(`ShardingCoverageError`). A spec is a tuple with one entry per axis, the
axis name or None; () is replicated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Set, Tuple

import torch

from mgproto_tpu_torch.core.memory import Memory
from mgproto_tpu_torch.core.mgproto import GMMState
from mgproto_tpu_torch.core.state import TrainState
from mgproto_tpu_torch.parallel.collectives import all_gather
from mgproto_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

# field -> rule for every TrainState field (core/state.py): replicate,
# param (the per-param map; BatchNorm buffers inside the model replicate)
# or class (the leading class axis over 'model')
SHARDING_RULES: Dict[str, str] = {
    "step": "replicate",
    "model": "param",
    "proxies": "param",
    "gmm": "class",
    "memory": "class",
    "opt": "param",  # the joint Adam moments shard with their parameters
    "warm_opt": "param",
    "mean_opt": "class",  # the EM mean-Adam moments: class-leading
    "joint_updates": "replicate",
}

Spec = Tuple[Any, ...]


class ShardingCoverageError(ValueError):
    """A TrainState field has no entry in SHARDING_RULES."""


def param_partition_spec(shape, model_size: int) -> Spec:
    """The JAX per-param rule on a shape: the LARGEST axis divisible by
    `model_size` goes on 'model', ties to the last axis; no divisible axis
    (or model_size 1) is replicated."""
    if model_size <= 1 or not shape:
        return ()
    best = None  # (size, axis)
    for axis, dim in enumerate(shape):
        if dim % model_size == 0 and dim >= model_size:
            if best is None or dim >= best[0]:
                best = (dim, axis)
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best[1]] = MODEL_AXIS
    return tuple(spec)


# the port's axis i of a weight is the JAX layout's axis _TO_JAX[ndim][i]:
# conv [O, I, kh, kw] vs HWIO [kh, kw, I, O]; Linear [O, I] vs Dense [I, O]
_TO_JAX = {4: (3, 2, 0, 1), 2: (1, 0)}


def _weight_spec(name: str, shape, model_size: int) -> Spec:
    """`param_partition_spec` of a module weight taken on its JAX layout,
    returned in the port's axis order."""
    perm = _TO_JAX.get(len(shape)) if name.endswith(".weight") else None
    if perm is None:
        return param_partition_spec(tuple(shape), model_size)
    jax_shape = [0] * len(shape)
    for i, j in enumerate(perm):
        jax_shape[j] = shape[i]
    spec = param_partition_spec(tuple(jax_shape), model_size)
    if not spec:
        return ()
    return tuple(spec[j] for j in perm)


def _class_spec(t: torch.Tensor, num_classes: int, model_size: int, slab: bool) -> Spec:
    rows = num_classes // model_size if slab else num_classes
    if (model_size > 1 and t.dim() >= 1 and t.shape[0] == rows
            and num_classes % model_size == 0):
        return (MODEL_AXIS,)
    return ()


def _param_names(state: TrainState) -> Dict[int, str]:
    names = {id(p): n for n, p in state.model.named_parameters()}
    if state.proxies is not None:
        names[id(state.proxies)] = "proxies"
    names[id(state.gmm.means)] = "means"
    return names


def _opt_specs(opt: torch.optim.Optimizer, names: Dict[int, str], spec_of) -> Dict[str, Spec]:
    out = {}
    for group in opt.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{name}/{key}"] = spec_of(name, p)
            out[f"{name}/step"] = ()
    return out


def state_partition_specs(state: TrainState, num_classes: int, model_size: int,
                          class_slab: bool = False) -> Dict[str, Any]:
    """{field: spec, or {leaf name: spec}} for `state`, from
    SHARDING_RULES. `class_slab`: `state` holds one rank's class slab
    (`shard_classes`), num_classes / model_size of the `num_classes`.
    Shape math only: no group, no device. Raises `ShardingCoverageError`
    on a field the table does not name."""
    fields = [f.name for f in dataclasses.fields(state)]
    missing = [f for f in fields if f not in SHARDING_RULES]
    if missing:
        raise ShardingCoverageError(
            f"TrainState field(s) {missing} have no SHARDING_RULES entry: an unruled "
            "field would silently replicate on every rank. Add an explicit rule in "
            "parallel/sharding.py.")
    names = _param_names(state)
    params = dict(state.model.named_parameters())

    def param_spec(name, p):
        return _weight_spec(name, tuple(p.shape), model_size)

    def class_spec(_, t):
        return _class_spec(t, num_classes, model_size, class_slab)

    out: Dict[str, Any] = {}
    for f in fields:
        rule, sub = SHARDING_RULES[f], getattr(state, f)
        if f in ("step", "joint_updates"):
            out[f] = ()
        elif f == "model":
            out[f] = {n: (param_spec(n, params[n]) if n in params else ())
                      for n in sub.state_dict()}
        elif f == "proxies":
            out[f] = None if sub is None else param_spec(f, sub)
        elif f in ("gmm", "memory"):
            out[f] = {k: class_spec(k, t) for k, t in sub._asdict().items()}
        elif rule == "param":
            out[f] = _opt_specs(sub, names, param_spec)
        elif rule == "class":
            out[f] = _opt_specs(sub, names, class_spec)
        else:  # pragma: no cover - the table is module-local
            raise ValueError(f"unknown sharding rule {rule!r} for {f!r}")
    return out


def class_sharded_payload_paths(state: TrainState, num_classes: int,
                                model_size: int) -> Set[str]:
    """The leaves of a rank's class-slab `state` that rule "class" puts on
    'model', by their path in its checkpoint payload
    (utils/checkpoint.py `state_payload`: `gmm/<field>`, `memory/<field>`,
    `<optimizer>/state/<i>/<moment>` with i the parameter's position in
    the optimizer's groups): what each model column writes of a sharded
    checkpoint."""
    specs = state_partition_specs(state, num_classes, model_size, class_slab=True)
    names = _param_names(state)
    out: Set[str] = set()
    for f, rule in SHARDING_RULES.items():
        if rule != "class":
            continue
        sub = getattr(state, f)
        if f in ("gmm", "memory"):
            keyed = {f"{f}/{k}": spec for k, spec in specs[f].items()}
        else:  # an optimizer: its state_dict numbers the parameters in order
            params = [p for group in sub.param_groups for p in group["params"]]
            keyed = {f"{f}/state/{i}/{key}": specs[f][f"{names[id(p)]}/{key}"]
                     for i, p in enumerate(params) for key in ("exp_avg", "exp_avg_sq")}
        out.update(path for path, spec in keyed.items() if MODEL_AXIS in spec)
    return out


def spec_shard_factor(spec: Spec, model_size: int) -> int:
    """How many ways `spec` splits an array over the model axis."""
    return model_size if MODEL_AXIS in (spec or ()) else 1


def tree_bytes_per_chip(tensors: Dict[str, Any], specs: Dict[str, Any], model_size: int) -> int:
    """Bytes per rank of the tensors of a {name: tensor} tree (nested
    dicts allowed) under the matching spec tree: replicated leaves whole,
    sharded ones 1/factor."""
    total = 0
    for name, t in tensors.items():
        spec = specs[name]
        if isinstance(t, dict):
            total += tree_bytes_per_chip(t, spec, model_size)
        elif hasattr(t, "shape"):
            nbytes = int(math.prod(t.shape)) * t.element_size()
            total += nbytes // spec_shard_factor(spec, model_size)
    return int(total)


def put_batch(batch, mesh: Mesh):
    """This rank's rows of a global host batch (a tuple of arrays with one
    leading batch axis): rows [r*b, (r+1)*b) for b = rows / world."""
    out = []
    for x in batch:
        n = len(x)
        if n % mesh.size:
            raise ValueError(f"a global batch of {n} rows does not split over {mesh.size} ranks")
        b = n // mesh.size
        out.append(x[mesh.rank * b:(mesh.rank + 1) * b])
    return tuple(out)


# ------------------------------------------------------------- class slabs
def _mean_optimizer_like(old: torch.optim.Adam, means: torch.Tensor, st, rows) -> torch.optim.Adam:
    """A mean Adam on the leaf `means` with `old`'s settings and its state
    `st` (step, exp_avg, exp_avg_sq) mapped through `rows` (a function of
    a moment tensor), or no state when `st` is empty."""
    group = {k: v for k, v in old.param_groups[0].items() if k != "params"}
    new = torch.optim.Adam([means.requires_grad_(True)], **group)
    if st:
        new.state[means] = {"step": st["step"].clone(),
                            "exp_avg": rows(st["exp_avg"]), "exp_avg_sq": rows(st["exp_avg_sq"])}
    return new


def shard_classes(state: TrainState, mesh: Mesh) -> TrainState:
    """Cut a state holding every class down to this rank's slab in place:
    the GMM, the bank and the mean optimizer (a new Adam on the slab's
    means, the moments' rows cut with them). A no-op when the mesh does
    not split the class axis."""
    c = state.gmm.num_classes
    if not mesh.shards_classes(c):
        return state
    c0, c1 = mesh.class_slab(c)

    def rows(t):
        return t.detach()[c0:c1].clone()

    old = state.mean_opt
    means = rows(state.gmm.means)
    state.mean_opt = _mean_optimizer_like(old, means, old.state.get(state.gmm.means), rows)
    state.gmm = GMMState(means, *(rows(t) for t in state.gmm[1:]))
    state.memory = Memory(*(rows(t) for t in state.memory))
    return state


def gather_classes(t: torch.Tensor, mesh: Mesh, num_classes: int) -> torch.Tensor:
    """Every class's rows of a class-leading slab tensor, on every rank of
    the model group (a copy; the slab itself when the axis is whole)."""
    if not mesh.shards_classes(num_classes):
        return t
    return all_gather(t.detach(), 0, mesh.model_group)


def gather_gmm(gmm: GMMState, mesh: Mesh, num_classes: int) -> GMMState:
    return GMMState(*(gather_classes(t, mesh, num_classes) for t in gmm))


def gather_state(state: TrainState, mesh: Mesh, num_classes: int) -> TrainState:
    """A TrainState holding every class, from this rank's slab state: the
    GMM, the bank and the mean optimizer gathered over the model group (a
    collective: every rank of the group calls it together); the model,
    the proxies and the other optimizers are the slab state's own objects.
    The state itself when the mesh does not split the class axis."""
    if not mesh.shards_classes(num_classes):
        return state

    def full(t):
        return gather_classes(t, mesh, num_classes).clone()

    means = full(state.gmm.means)
    st = state.mean_opt.state.get(state.gmm.means)
    opt = _mean_optimizer_like(state.mean_opt, means, st, full)
    return dataclasses.replace(
        state, gmm=GMMState(means, *(full(t) for t in state.gmm[1:])),
        memory=Memory(*(full(t) for t in state.memory)), mean_opt=opt)

