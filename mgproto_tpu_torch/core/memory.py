"""Per-class FIFO feature memory (counterpart of mgproto_tpu/core/memory.py).

A circular buffer per class: `feats` [C, cap, d], with `length`, `cursor`
and `updated` [C]. `memory_push` keeps the JAX package's semantics bit for
bit: rows are ranked within their class in batch order, the first `cap`
rows of a class are kept, invalid and out-of-range rows are dropped, and a
class's kept rows land at slots cursor, cursor + 1, ... (mod cap).

The JAX package writes the bank by a sort + gather + select over all of it
(scatter-free, for the TPU). Here the kept rows are written in place into
their slots: one indexed write of at most B*K rows instead of a copy of the
[C, cap, d] bank. Within a push every kept row has its own slot, so the
write order does not matter.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from mgproto_tpu_torch.perf.precision import assert_f32_stats


class Memory(NamedTuple):
    """feats [C, cap, d] f32; length/cursor [C] int32; updated [C] bool."""

    feats: torch.Tensor
    length: torch.Tensor
    cursor: torch.Tensor
    updated: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.feats.shape[1]

    @property
    def num_classes(self) -> int:
        return self.feats.shape[0]


def init_memory(num_classes: int, capacity: int, dim: int,
                device: Union[str, torch.device] = "cpu") -> Memory:
    return Memory(
        feats=torch.zeros(num_classes, capacity, dim, device=device),
        length=torch.zeros(num_classes, dtype=torch.int32, device=device),
        cursor=torch.zeros(num_classes, dtype=torch.int32, device=device),
        updated=torch.zeros(num_classes, dtype=torch.bool, device=device),
    )


def push_plan(mem: Memory, classes: torch.Tensor, valid: torch.Tensor):
    """(keep [N] bool, cls [N] long, rank [N] long, counts [C] int32): which
    candidate rows a push keeps, their class and rank within the class in
    batch order, and how many rows each class receives (<= cap)."""
    c, cap = mem.num_classes, mem.capacity
    classes = classes.long()
    ok = valid & (classes >= 0) & (classes < c)
    cls = torch.where(ok, classes, torch.full_like(classes, c))  # sentinel c
    one_hot = torch.nn.functional.one_hot(cls, c + 1)[:, :c]  # [N, C]
    rank = one_hot.cumsum(0).gather(1, cls.clamp(0, c - 1)[:, None])[:, 0] - 1
    keep = ok & (rank < cap)
    counts = (one_hot * keep[:, None]).sum(0).to(torch.int32)
    return keep, cls, rank, counts


def memory_push(mem: Memory, feats: torch.Tensor, classes: torch.Tensor,
                valid: torch.Tensor) -> Memory:
    """Enqueue a flat batch of candidates: feats [N, d], classes [N], valid
    [N] bool. Writes `mem.feats` in place and returns the new Memory. The
    bank is a statistics buffer: a half-precision bank is refused
    (perf/precision.py)."""
    assert_f32_stats(mem.feats, "memory bank feats")
    if feats.shape[0] == 0:
        return mem
    keep, cls, rank, counts = push_plan(mem, classes, valid)
    c, cap, d = mem.feats.shape
    kc = cls.clamp_max(c - 1)
    target = kc * cap + (mem.cursor.long()[kc] + rank) % cap  # flat slot per row
    rows = feats.detach().to(mem.feats.dtype)
    flat = mem.feats.view(c * cap, d)
    # A dropped row rewrites the first kept row's slot with that row's value
    # (or slot 0 with its own value when nothing is kept): duplicate targets
    # then carry equal values, so the write is deterministic, and no host
    # sync is needed to count the kept rows.
    first = keep.int().argmax()
    any_kept = keep.any()
    target = torch.where(keep, target, torch.where(any_kept, target[first], 0))
    fill = torch.where(any_kept, rows[first], flat[0])
    flat.index_put_((target,), torch.where(keep[:, None], rows, fill))
    return Memory(
        feats=mem.feats,
        length=torch.clamp_max(mem.length + counts, cap),
        cursor=(mem.cursor + counts) % cap,
        updated=mem.updated | (counts > 0),
    )


def clear_updated(mem: Memory) -> Memory:
    """Reset the per-class updated flags after an EM pass."""
    return mem._replace(updated=torch.zeros_like(mem.updated))
