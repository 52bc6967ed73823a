"""Collectives with gradients (the port's own; the JAX package gets them
from SPMD partitioning and shard_map's transposes).

  * `all_reduce_sum`: the sum over a group on every rank; its backward is
    the sum of the ranks' gradients (BatchNorm's batch statistics,
    models/common.py).
  * `all_gather`: the ranks' tensors concatenated along a dim in rank
    order; its backward sums the gradients over the group and hands each
    rank its own slice (a reduce-scatter): the features entering the
    class-sharded head, its logits leaving it (core/mgproto.py), the
    embeddings of the aux loss (engine/train.py).

Each takes a process group (`parallel/mesh.py::Mesh`'s); None, or a group
of one rank, makes it a no-op, so a single process runs the same code.
`bank_groups` makes the async bank phase's own groups (engine/train.py):
its collectives run beside the trunk's, and the one host thread that
issues both fixes each group's order on every rank. The
backend the group was made with does the work on the tensors' device: a
collective it cannot do there raises, and nothing moves a tensor to
another device to get round it. `stats` accumulates the host seconds spent
in these calls when `stats.timing` is set (each call then synchronizes
the device before and after, so the time is the collective's alone); off,
it costs one flag test per call.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, NamedTuple

import torch
import torch.distributed as dist

from mgproto_tpu_torch.parallel.mesh import Mesh, grid_groups, group_timeout


class CollectiveStats:
    """Calls, host seconds (when `timing`) and bytes of the collectives."""

    def __init__(self):
        self.timing = False
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.seconds = 0.0
        self.bytes = 0


stats = CollectiveStats()


def group_size(group: Any) -> int:
    """Ranks in `group`; 1 for None or outside a process group."""
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _run(fn, tensor: torch.Tensor, *args, **kw) -> None:
    """One collective call, counted and (when timing) timed."""
    stats.calls += 1
    stats.bytes += tensor.numel() * tensor.element_size()
    if not stats.timing:
        fn(*args, **kw)
        return
    sync = tensor.device.type == "cuda"
    if sync:
        torch.cuda.synchronize(tensor.device)
    t0 = time.perf_counter()
    fn(*args, **kw)
    if sync:
        torch.cuda.synchronize(tensor.device)
    stats.seconds += time.perf_counter() - t0


def _wire(x: torch.Tensor) -> torch.Tensor:
    # gloo carries no bool: flags travel as bytes
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _sum_in_place(x: torch.Tensor, group: Any) -> torch.Tensor:
    _run(dist.all_reduce, x, x, op=dist.ReduceOp.SUM, group=group)
    return x


def _gather(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    wire = _wire(x).contiguous()
    parts = [torch.empty_like(wire) for _ in range(group_size(group))]
    _run(dist.all_gather, wire, parts, wire, group=group)
    return torch.cat(parts, dim).to(x.dtype)


def _reduce_scatter(g: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    chunks = [c.contiguous() for c in g.chunk(group_size(group), dim)]
    out = torch.empty_like(chunks[0])
    _run(dist.reduce_scatter, g, out, chunks, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_in_place(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _sum_in_place(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The sum of `x` over `group`, on every rank (a new tensor)."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, dim: int = 0, group: Any = None) -> torch.Tensor:
    """The ranks' `x` (one shape on every rank) concatenated along `dim`
    in rank order."""
    if group_size(group) == 1:
        return x
    if not x.requires_grad:
        return _gather(x, dim, group)
    return _AllGather.apply(x, dim, group)


def sum_tensors(tensors: List[torch.Tensor], group: Any = None) -> None:
    """Sum the tensors over `group` in place, as one flat all-reduce in
    list order (each a float tensor of one dtype and device)."""
    if group_size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _sum_in_place(flat, group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def broadcast_tensors(tensors: List[torch.Tensor], src: int = 0, group: Any = None) -> None:
    """Overwrite the tensors with rank `src`'s, as one flat broadcast."""
    if group_size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    _run(dist.broadcast, flat, flat, src, group=group)
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t).to(t.dtype))


class BankGroups(NamedTuple):
    """The async bank phase's process groups: `world` (every rank: the
    gather of the global batch's enqueue candidates) and `mesh`, the mesh
    with a model group of its own (EM's sums over the class slabs)."""

    world: Any
    mesh: Mesh


def bank_groups(mesh: Mesh) -> BankGroups:
    """New process groups for the bank phase of `mesh`'s ranks: every rank
    calls this together, in the same order (a trainer's constructor).
    At world size 1, no group."""
    if mesh.size == 1:
        return BankGroups(None, mesh)
    world = dist.new_group(list(range(mesh.size)), timeout=group_timeout())
    model_group, data_group = grid_groups(mesh.data, mesh.model, mesh.rank)
    return BankGroups(world, dataclasses.replace(mesh, model_group=model_group,
                                                 data_group=data_group))
