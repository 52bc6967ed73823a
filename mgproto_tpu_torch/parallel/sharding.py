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
  * the parameters, the proxies and their Adam moments in the joint and
    warm optimizers (rule "param"): JAX's per-param map puts each array's
    largest axis that 'model' divides on 'model'. `state_partition_specs`
    computes that layout on the JAX package's array layouts (conv kernels
    HWIO, Dense kernels [in, out]), expressed in the port's axes, and
    `shard_params` holds it: at rest each such leaf keeps only the slice
    [i*n/m, (i+1)*n/m) of its spec's axis (i the rank's model index, m
    the model axis) in storage of its own, and so do both of its moments.
    The module Parameter stays the autograd leaf and the optimizers' key;
    only its data is swapped: `gather_params` puts the whole tensors in
    for a step (one all-gather over the model group), `scatter_grads`
    cuts the summed gradient back to the slice (a reduce-scatter over the
    model group, then a sum over the data group) and puts the slice back,
    so Adam steps the slice. `whole_params` lends the whole tensors to a
    reader outside a step. Leaves with no divisible axis, BatchNorm's
    running statistics and the step counters stay whole on every rank; a
    model axis of 1 holds everything whole.

Every TrainState field has an entry in `SHARDING_RULES`, and
`state_partition_specs` refuses a field without one
(`ShardingCoverageError`). A spec is a tuple with one entry per axis, the
axis name or None; () is replicated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from mgproto_tpu_torch.core.memory import Memory
from mgproto_tpu_torch.core.mgproto import GMMState
from mgproto_tpu_torch.core.state import TrainState
from mgproto_tpu_torch.parallel.collectives import (
    _gather,
    _reduce_scatter,
    all_gather,
    sum_tensors,
)
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

    def param_spec(name, p):  # on the whole shape, also for a rank's slice
        return _weight_spec(name, full_shape(p), model_size)

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


def sharded_payload_axes(state: TrainState, num_classes: int,
                         model_size: int) -> Dict[str, int]:
    """{path in the checkpoint payload: axis} of every leaf of a rank's
    prepared `state` that the model axis splits, by
    `state_partition_specs`: the class-rule leaves of a class slab on the
    class axis, the param-rule leaves (the parameters, the proxies and
    the joint and warm moments) on their spec's axis. Paths as
    utils/checkpoint.py `state_payload` names them: `model/<name>`,
    `proxies`, `gmm/<field>`, `memory/<field>`, `<optimizer>/state/<i>/
    <moment>` with i the parameter's position in the optimizer's groups.
    What each model column writes of a sharded checkpoint. A leaf held
    whole (a spec of (), a state that holds every class, a parameter not
    cut by `shard_params`) is not named."""
    slab = state.gmm.num_classes != num_classes
    specs = state_partition_specs(state, num_classes, model_size, class_slab=slab)
    names = _param_names(state)
    params = dict(state.model.named_parameters())
    # path -> (spec, the leaf, whether it is held cut)
    leaves: Dict[str, Tuple[Spec, torch.Tensor, bool]] = {}
    for n, t in state.model.state_dict().items():
        leaves[f"model/{n}"] = (specs["model"][n], t, n in params and is_sliced(params[n]))
    if state.proxies is not None:
        leaves["proxies"] = (specs["proxies"], state.proxies, is_sliced(state.proxies))
    for f in ("gmm", "memory"):
        for k, t in getattr(state, f)._asdict().items():
            leaves[f"{f}/{k}"] = (specs[f][k], t, slab)
    for f in ("opt", "warm_opt", "mean_opt"):
        opt = getattr(state, f)
        for i, p in enumerate(p for group in opt.param_groups for p in group["params"]):
            held = slab if SHARDING_RULES[f] == "class" else is_sliced(p)
            for key, t in opt.state.get(p, {}).items():
                if key in ("exp_avg", "exp_avg_sq"):
                    leaves[f"{f}/state/{i}/{key}"] = (specs[f][f"{names[id(p)]}/{key}"], t, held)
    return {path: spec.index(MODEL_AXIS) for path, (spec, _, held) in leaves.items()
            if held and MODEL_AXIS in spec}


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



# -------------------------------------------------------- parameter slices
_SHARD_ATTR = "_mgproto_param_shard"
_MOMENTS = ("exp_avg", "exp_avg_sq")


class ParamShard(NamedTuple):
    """How `shard_params` cut a differentiated leaf: on `axis`, the whole
    tensor's `shape` and memory format, this rank's slice `index` of
    `parts` (the model axis)."""

    axis: int
    shape: Tuple[int, ...]
    memory_format: torch.memory_format
    index: int
    parts: int

    def slice_of(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole tensor `t`, in storage of its own."""
        n = self.shape[self.axis] // self.parts
        return t.detach().narrow(self.axis, self.index * n, n).clone(
            memory_format=torch.contiguous_format)


def param_shard(t: torch.Tensor) -> Optional[ParamShard]:
    """The cut `shard_params` recorded on a leaf, or None (held whole)."""
    return getattr(t, _SHARD_ATTR, None)


def is_sliced(t: torch.Tensor) -> bool:
    """True while a cut leaf holds its slice (not the whole tensor)."""
    shard = param_shard(t)
    return shard is not None and tuple(t.shape) != shard.shape


def full_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The whole shape of a leaf, cut or not."""
    shard = param_shard(t)
    return tuple(t.shape) if shard is None else shard.shape


def _differentiated(state: TrainState) -> List[Tuple[str, torch.Tensor]]:
    out = list(state.model.named_parameters())
    if state.proxies is not None:
        out.append(("proxies", state.proxies))
    return out


def _moment_slots(state: TrainState, leaves) -> List[Tuple[dict, str, torch.Tensor]]:
    """(the optimizer's state dict of a leaf, the moment's key, the leaf)
    for every moment the joint and warm optimizers hold of `leaves`."""
    out = []
    for opt in (state.opt, state.warm_opt):
        for t in leaves:
            st = opt.state.get(t, {})
            out.extend((st, key, t) for key in _MOMENTS if key in st)
    return out


def _memory_format(t: torch.Tensor) -> torch.memory_format:
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def holds_slices(state: TrainState) -> bool:
    """True when a parameter or a joint or warm moment of `state` holds its
    slice."""
    leaves = [t for _, t in _differentiated(state)]
    return (any(is_sliced(t) for t in leaves)
            or any(tuple(st[key].shape) != full_shape(t)
                   for st, key, t in _moment_slots(state, leaves)))


def shard_params(state: TrainState, mesh: Mesh, num_classes: int) -> TrainState:
    """Cut `state`'s parameters, proxies and their joint and warm Adam
    moments to this rank's slices in place, by `state_partition_specs`
    (rule "param"): every leaf whose spec names 'model' keeps the slice
    `ParamShard.slice_of` of its spec's axis, in storage of its own, and
    its moments that slice's shape. No collective: every rank holds the
    same whole tensors (`ShardedTrainer.prepare` broadcasts them first).
    A model axis of 1, and a leaf already cut, are left as they are."""
    if mesh.model <= 1:
        return state
    specs = state_partition_specs(state, num_classes, mesh.model,
                                  class_slab=state.gmm.num_classes != num_classes)
    for name, t in _differentiated(state):
        spec = specs["proxies"] if name == "proxies" else specs["model"][name]
        if MODEL_AXIS not in spec or param_shard(t) is not None:
            continue
        shard = ParamShard(spec.index(MODEL_AXIS), tuple(t.shape), _memory_format(t),
                           mesh.model_index, mesh.model)
        setattr(t, _SHARD_ATTR, shard)
        for st, key, _ in _moment_slots(state, [t]):
            st[key] = shard.slice_of(st[key])
        t.data = shard.slice_of(t)
    return state


def _gather_slices(slices: List[torch.Tensor], shards: List[ParamShard],
                   group: Any) -> List[torch.Tensor]:
    """The whole tensors of this rank's `slices` (f32, each cut by its
    shard), from one all-gather of the packed slices over the model group,
    each in its recorded memory format."""
    sizes = [s.numel() for s in slices]
    rows = _gather(torch.cat([s.reshape(-1) for s in slices]), 0, group)
    per_rank = rows.view(shards[0].parts, -1)
    parts = [row.split(sizes) for row in per_rank]
    out = []
    for i, (s, shard) in enumerate(zip(slices, shards)):
        whole = torch.cat([p[i].view(s.shape) for p in parts], shard.axis)
        out.append(whole.contiguous(memory_format=shard.memory_format))
    return out


def gather_params(tensors: List[torch.Tensor], mesh: Optional[Mesh]) -> List[Tuple]:
    """Put the whole tensor in for each cut leaf of `tensors` that holds its
    slice (one all-gather over the model group: every rank of the group
    calls it together), for a train step's forward and backward. Returns
    [(leaf, its slice)] for `scatter_grads`; [] without a mesh or when
    nothing is cut."""
    held = [] if mesh is None else [t for t in tensors if is_sliced(t)]
    if not held:
        return []
    slices = [t.data for t in held]
    for t, whole in zip(held, _gather_slices(slices, [param_shard(t) for t in held],
                                             mesh.model_group)):
        t.data = whole
    return list(zip(held, slices))


def scatter_grads(held: List[Tuple], mesh: Mesh) -> None:
    """After the backward of a step that `gather_params` opened: each
    leaf's whole gradient summed over every rank and cut to this rank's
    slice (one reduce-scatter of the packed gradients over the model group,
    then one sum over the data group), the slice put back as its data and
    the summed slice as its gradient; a leaf without a gradient gets its
    slice back alone."""
    with_grad = [(t, s) for t, s in held if t.grad is not None]
    for t, s in held:
        if t.grad is None:
            t.data = s
    if not with_grad:
        return
    shards = [param_shard(t) for t, _ in with_grad]
    m = shards[0].parts
    packed = torch.cat([t.grad.detach().narrow(sh.axis, r * s.shape[sh.axis], s.shape[sh.axis])
                        .reshape(-1)
                        for r in range(m) for (t, s), sh in zip(with_grad, shards)])
    mine = _reduce_scatter(packed, 0, mesh.model_group)
    grads = [g.view(s.shape) for g, (_, s) in zip(mine.split([s.numel() for _, s in with_grad]),
                                                   with_grad)]
    sum_tensors(grads, mesh.data_group)
    for (t, s), g in zip(with_grad, grads):
        t.grad = None
        t.data = s
        t.grad = g


def whole_grads(tensors: List[torch.Tensor], mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """The whole gradients of `tensors` after a step: a cut leaf's summed
    slice gathered over the model group (one all-gather: every rank of
    the group calls it together), every other leaf's gradient as it is."""
    cut = [t for t in tensors if is_sliced(t) and t.grad is not None]
    wholes = {}
    if mesh is not None and cut:
        got = _gather_slices([t.grad for t in cut], [param_shard(t) for t in cut],
                             mesh.model_group)
        wholes = {id(t): g for t, g in zip(cut, got)}
    return [wholes.get(id(t), t.grad) for t in tensors]


@contextlib.contextmanager
def whole_params(state: TrainState, mesh: Optional[Mesh],
                 moments: bool = False) -> Iterator[TrainState]:
    """Lend a reader the whole parameters (and with `moments` the joint and
    warm moments) of a state `shard_params` cut: one all-gather over the
    model group on entry (every rank of the group enters together), the
    slices put back on exit (writes to the whole tensors are dropped).
    Leaves already whole (an enclosing call) are left to it, so calls
    nest; without a mesh, or with nothing cut, it gathers nothing."""
    if mesh is None:
        yield state
        return
    leaves = [t for _, t in _differentiated(state)]
    params = [t for t in leaves if is_sliced(t)]
    slots = [(st, key, t) for st, key, t in _moment_slots(state, leaves)
             if moments and param_shard(t) is not None
             and tuple(st[key].shape) != param_shard(t).shape]
    if not (params or slots):
        yield state
        return
    slices = [t.data for t in params] + [st[key] for st, key, _ in slots]
    shards = [param_shard(t) for t in params] + [param_shard(t) for _, _, t in slots]
    wholes = _gather_slices(slices, shards, mesh.model_group)
    for t, whole in zip(params, wholes):
        t.data = whole
    for (st, key, _), whole in zip(slots, wholes[len(params):]):
        st[key] = whole
    try:
        yield state
    finally:
        for t, s in zip(params, slices):
            t.data = s
        for (st, key, _), s in zip(slots, slices[len(params):]):
            st[key] = s


def param_tensors(state: TrainState, whole: bool = False) -> Dict[str, Any]:
    """The rule-"param" leaves of `state` as a {field: {leaf: tensor}} tree
    keyed as `state_partition_specs` keys them: the model's parameters,
    the proxies, and the joint and warm moments that exist. `whole`: meta
    tensors of the whole shapes (shape math, no storage)."""
    names = _param_names(state)

    def leaf(t, like):
        return torch.empty(full_shape(like), dtype=t.dtype, device="meta") if whole else t

    out: Dict[str, Any] = {"model": {n: leaf(p, p) for n, p in state.model.named_parameters()}}
    if state.proxies is not None:
        out["proxies"] = leaf(state.proxies, state.proxies)
    for f in ("opt", "warm_opt"):
        opt = getattr(state, f)
        out[f] = {f"{names[id(p)]}/{key}": leaf(st[key], p)
                  for group in opt.param_groups for p in group["params"]
                  for st in [opt.state.get(p, {})] for key in _MOMENTS if key in st}
    return out


def held_bytes(tree: Dict[str, Any]) -> int:
    """Bytes of the storages behind the tensors of a {name: tensor} tree
    (nested dicts allowed), each storage counted once: what a rank holds,
    views of a larger tensor charged with all of it."""
    seen: Dict[int, int] = {}

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, torch.Tensor):
            st = node.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()

    walk(tree)
    return int(sum(seen.values()))


def param_bytes_per_rank(state: TrainState, num_classes: int, model_size: int) -> int:
    """`tree_bytes_per_chip` of `param_tensors(state)` at the whole shapes
    under the specs of a model axis of `model_size`: the bytes of the
    parameters and moments a rank holds at rest (model_size 1: all)."""
    specs = state_partition_specs(state, num_classes, model_size,
                                  class_slab=state.gmm.num_classes != num_classes)
    tree = param_tensors(state, whole=True)
    return tree_bytes_per_chip(tree, {f: specs[f] for f in tree}, model_size)
