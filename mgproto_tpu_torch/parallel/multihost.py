"""Host-side collectives of a multi-process run (counterpart of the first
half of mgproto_tpu/parallel/multihost.py).

Each rank holds its own rows of every batch, so dataset-level results
(accuracy, OoD percentiles, push candidates) are gathered across the ranks
in rank order (`allgather_rows`), and run-wide side effects (checkpoint
files, markers, rendered pictures) belong to rank 0 (`is_primary_host`).
`any_across_hosts` is the preemption agreement: a signal reaches one rank,
but every rank must stop after the same step. Every function is a no-op
(the identity) in one process.

The collectives run on the backend's device: the CPU for gloo, this
rank's card for NCCL. The JAX package's guarded barriers, heartbeats and
straggler detection (its second half) are not ported yet (ROADMAP A item
5): a dead peer surfaces as the process group's timeout.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from mgproto_tpu_torch.parallel.collectives import all_gather, sum_tensors
from mgproto_tpu_torch.parallel.mesh import world


def _wire_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def is_primary_host() -> bool:
    """True on rank 0 (and in one process)."""
    return world()[0] == 0


def host_local_rows(x: torch.Tensor) -> np.ndarray:
    """A tensor of this rank's rows on the host (each rank holds only its
    own rows, so nothing is selected)."""
    return x.detach().cpu().numpy()


def allgather_rows(x: np.ndarray) -> np.ndarray:
    """Equal-shaped host arrays of every rank concatenated along axis 0 in
    rank order. One process: `x`."""
    if world()[1] == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_wire_device())
    return all_gather(t, 0, dist.group.WORLD).cpu().numpy().astype(x.dtype, copy=False)


def allgather_sum(x: float) -> float:
    """A host scalar summed over the ranks, in float64."""
    if world()[1] == 1:
        return float(x)
    t = torch.tensor([float(x)], dtype=torch.float64, device=_wire_device())
    sum_tensors([t], dist.group.WORLD)
    return float(t.item())


def any_across_hosts(flag: bool) -> bool:
    """True when any rank passes True. A collective: every rank calls it
    at the same point."""
    if world()[1] == 1:
        return bool(flag)
    return allgather_sum(1.0 if flag else 0.0) > 0.0


def barrier() -> None:
    """Wait for every rank (the process group's timeout bounds it)."""
    if world()[1] > 1:
        dist.barrier()


def fetch_replicated(state: Any, mesh, num_classes: int) -> Any:
    """`state` (a TrainState or a GMMState of this rank's class slab of a
    model of `num_classes` classes) with every class, on every rank: the
    class axis gathered over the model group (parallel/sharding.py). A
    collective over that group; `state` itself without a mesh or when the
    mesh does not split the classes."""
    from mgproto_tpu_torch.core.mgproto import GMMState
    from mgproto_tpu_torch.parallel import sharding

    if mesh is None:
        return state
    if isinstance(state, GMMState):
        return sharding.gather_gmm(state, mesh, num_classes)
    return sharding.gather_state(state, mesh, num_classes)
