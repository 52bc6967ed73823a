"""Host-side collectives and the failure agreement of a multi-process run
(counterpart of mgproto_tpu/parallel/multihost.py but for its straggler
observer).

Each rank holds its own rows of every batch, so dataset-level results
(accuracy, OoD percentiles, push candidates) are gathered across the ranks
in rank order (`allgather_rows`), and run-wide side effects (checkpoint
files, markers, rendered pictures) belong to rank 0 (`is_primary_host`).
`any_across_hosts` is the preemption agreement: a signal reaches one rank,
but every rank must stop after the same step; `max_across_hosts` is the
memory planner's (every rank plans under the worst rank's numbers). Every function is a no-op
(the identity) in one process.

The collectives run on the backend's device: the CPU for gloo, this
rank's card for NCCL.

Failure agreement: a bare collective leaves every survivor waiting when a
peer dies or wedges. The guarded barrier (`configure_barrier`,
`guarded_barrier`) is the JAX package's file protocol over the shared
`model_dir`: every rank touches `<name>.<seq>.h<rank>` under
`.barrier/<session>/` and polls for its peers' files; a peer missing past
`timeout_s` makes the survivor count the missed barrier, record a
`barrier_timeout` event, write PEER_LOST.json naming the missing ranks,
dump the flight recorder (`peer_lost`) and raise `BarrierTimeoutError`,
which `cli/train.py` turns into exit code PEER_LOST_EXIT_CODE (75) so a
launcher relaunches every rank from the last committed checkpoint. The
host gathers below, the preemption agreement and the sharded checkpoint's
commit (`checkpoint_barrier`) pass through it first. Heartbeat files
(`hb.h<rank>`), touched after every train step, say in the marker how
long ago each peer last made progress.

In this port a peer loss usually surfaces in a torch.distributed call
first (a train step's all-reduce): under gloo a killed peer makes it raise
at once, a wedged one when the process group's timeout (tied to
--barrier_timeout_s, parallel/mesh.py) runs out. `agree_on_failure` then
holds one guarded barrier, `peer_lost`, for the barrier timeout plus the
process group's, so a live peer still blocked in a collective when this
rank failed reaches it first: the ranks that do not reach it are named in
the marker exactly as at any other barrier, and when every rank reaches
it the error was not a peer loss (an ordinary error on one rank, which
its peers meet as a collective's timeout) and is raised as it came.
Unconfigured, or in one process, every guard call is a no-op.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mgproto_tpu_torch.parallel.collectives import all_gather, sum_tensors
from mgproto_tpu_torch.parallel.mesh import group_timeout, world


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
    rank order (guarded first: a dead peer raises BarrierTimeoutError
    instead of a wait). One process: `x`."""
    if world()[1] == 1:
        return x
    guarded_barrier("allgather_rows")
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_wire_device())
    return all_gather(t, 0, dist.group.WORLD).cpu().numpy().astype(x.dtype, copy=False)


def allgather_sum(x: float) -> float:
    """A host scalar summed over the ranks, in float64."""
    if world()[1] == 1:
        return float(x)
    guarded_barrier("allgather_sum")
    t = torch.tensor([float(x)], dtype=torch.float64, device=_wire_device())
    sum_tensors([t], dist.group.WORLD)
    return float(t.item())


def max_across_hosts(values: List[float]) -> List[float]:
    """Each host float's maximum over the ranks, in float64 (one
    all-reduce; a collective, guarded through the barrier like the
    gathers). One process: the values."""
    if world()[1] == 1:
        return [float(v) for v in values]
    guarded_barrier("max_across_hosts")
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=_wire_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [float(v) for v in t.cpu().tolist()]


def any_across_hosts(flag: bool) -> bool:
    """True when any rank passes True. A collective: every rank calls it
    at the same point (guarded through `allgather_sum`)."""
    if world()[1] == 1:
        return bool(flag)
    return allgather_sum(1.0 if flag else 0.0) > 0.0


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


# --------------------------------------------------------------------------
# The guarded barrier: failure agreement instead of a wait without end.
# --------------------------------------------------------------------------

PEER_LOST_FILE = "PEER_LOST.json"
# the status a survivor exits with after writing the marker: the run is
# retryable, its state safe on disk (EX_TEMPFAIL)
PEER_LOST_EXIT_CODE = 75

BARRIER_SUBDIR = ".barrier"
_HEARTBEAT_PREFIX = "hb.h"


class BarrierTimeoutError(RuntimeError):
    """A peer missed a guarded barrier past the timeout (a dead or wedged
    rank). The survivor has written the marker and dumped the flight
    recorder; cli/train.py exits PEER_LOST_EXIT_CODE."""

    def __init__(self, name: str, missing: List[int], timeout_s: float):
        super().__init__(
            f"barrier {name!r}: processes {missing} missing after {timeout_s:.1f}s (dead or "
            "wedged peer); survivors exit for relaunch-from-last-commit")
        self.name = name
        self.missing = missing
        self.timeout_s = timeout_s


@dataclasses.dataclass
class BarrierGuard:
    """The file barrier and heartbeat state over a shared directory. Every
    rank touches `<name>.<seq>.h<rank>` and polls until all
    `num_processes` files of that (name, seq) exist; `seq` counts per name
    and stays aligned across ranks because every rank reaches every
    guarded call in the same order. The directory is namespaced by a
    session token per incarnation (`configure_barrier`), so a relaunch,
    whose seqs restart at 0, never reads a dead incarnation's files."""

    barrier_dir: str
    marker_dir: str
    timeout_s: float
    process_id: int
    num_processes: int
    poll_s: float = 0.05
    heartbeat_min_interval_s: float = 0.5
    _seq: Dict[str, int] = dataclasses.field(default_factory=dict)
    _last_heartbeat: float = -1e9

    def _file(self, name: str, seq: int, pid: int) -> str:
        safe = "".join(c if (c.isalnum() or c in "._-") else "_" for c in name)
        return os.path.join(self.barrier_dir, f"{safe}.{seq:06d}.h{pid:05d}")


_BARRIER: Optional[BarrierGuard] = None


def _agree_session_token() -> str:
    """Rank 0's wall clock at configure time, broadcast over the default
    process group (every rank is alive at bring-up, when this runs)."""
    t = torch.tensor([time.time_ns() & 0x7FFFFFFFFFFFFFFF], dtype=torch.int64,
                     device=_wire_device())
    dist.broadcast(t, 0)
    return f"{int(t.item()):x}"


def configure_barrier(model_dir: str, timeout_s: float, process_id: Optional[int] = None,
                      num_processes: Optional[int] = None, poll_s: float = 0.05,
                      session: Optional[str] = None) -> Optional[BarrierGuard]:
    """Install the process-global guard over `model_dir` (the shared
    directory the checkpoints live in). `timeout_s <= 0` uninstalls it.
    `session` names this incarnation's barrier directory: by default
    MGPROTO_BARRIER_SESSION (a launcher's incarnation id), else rank 0's
    clock broadcast over the process group (a collective: every rank calls
    this together), else "s0" in one process. Returns the guard."""
    global _BARRIER
    if timeout_s is None or timeout_s <= 0:
        _BARRIER = None
        return None
    rank, size = world()
    if session is None:
        session = os.environ.get("MGPROTO_BARRIER_SESSION") or (
            _agree_session_token() if process_id is None and size > 1 else "s0")
    guard = BarrierGuard(
        barrier_dir=os.path.join(model_dir, BARRIER_SUBDIR, session), marker_dir=model_dir,
        timeout_s=float(timeout_s), process_id=rank if process_id is None else int(process_id),
        num_processes=size if num_processes is None else int(num_processes), poll_s=poll_s)
    os.makedirs(guard.barrier_dir, exist_ok=True)
    _BARRIER = guard
    return guard


def barrier_guard() -> Optional[BarrierGuard]:
    return _BARRIER


def clear_barrier() -> None:
    """Uninstall the guard (run_training's `finally`)."""
    global _BARRIER
    _BARRIER = None


def heartbeat_tick() -> None:
    """Touch this rank's heartbeat file (at most every 0.5 s): called
    after every train step and at barrier entry, so the marker can say when
    each peer last made progress (it cannot tell dead from wedged). A no-op
    without a guard; a failed write never fails a step."""
    g = _BARRIER
    if g is None:
        return
    now = time.monotonic()
    if now - g._last_heartbeat < g.heartbeat_min_interval_s:
        return
    g._last_heartbeat = now
    try:
        with open(os.path.join(g.barrier_dir, f"{_HEARTBEAT_PREFIX}{g.process_id:05d}"), "w") as f:
            f.write(str(time.time()))
    except OSError:
        pass


def peer_heartbeat_ages() -> Dict[int, Optional[float]]:
    """Seconds since each rank's last heartbeat (None: never seen)."""
    g = _BARRIER
    if g is None:
        return {}
    ages: Dict[int, Optional[float]] = {}
    now = time.time()
    for pid in range(g.num_processes):
        try:
            ages[pid] = max(0.0, now - os.path.getmtime(
                os.path.join(g.barrier_dir, f"{_HEARTBEAT_PREFIX}{pid:05d}")))
        except OSError:
            ages[pid] = None
    return ages


def _on_barrier_timeout(g: BarrierGuard, name: str, missing: List[int], waited_s: float):
    """The survivor's path: the counters, a `barrier_timeout` event, the
    marker, the flight recorder's `peer_lost` dump, then the raise."""
    from mgproto_tpu_torch.obs.flightrec import get_recorder, record_event
    from mgproto_tpu_torch.resilience import metrics as _m

    ages = {str(k): v for k, v in peer_heartbeat_ages().items()}
    _m.counter(_m.MISSED_BARRIERS).inc(barrier=name)
    _m.counter(_m.PEER_LOST).inc()
    record_event("barrier_timeout", barrier=name, missing=str(missing),
                 heartbeat_ages=json.dumps(ages))
    marker = os.path.join(g.marker_dir, PEER_LOST_FILE)
    payload = {"barrier": name, "missing_processes": missing, "survivor": g.process_id,
               "timeout_s": g.timeout_s, "waited_s": waited_s, "heartbeat_ages_s": ages,
               "time": time.time(),
               "exit_code": PEER_LOST_EXIT_CODE}
    try:
        tmp = marker + f".tmp{g.process_id}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, marker)
    except OSError:
        pass  # the raise below still carries the diagnosis
    get_recorder().maybe_dump("peer_lost")
    raise BarrierTimeoutError(name, missing, waited_s)


def guarded_barrier(name: str, timeout_s: Optional[float] = None) -> None:
    """Wait until every rank reaches this named barrier, or raise
    `BarrierTimeoutError` after `timeout_s` (None: the guard's) naming the
    missing ranks. Every rank calls it in the same order. A no-op
    unconfigured or in one process."""
    g = _BARRIER
    if g is None or g.num_processes <= 1:
        return
    seq = g._seq.get(name, 0)
    g._seq[name] = seq + 1
    heartbeat_tick()
    with open(g._file(name, seq, g.process_id), "w") as f:
        f.write(str(time.time()))
    wait_s = g.timeout_s if timeout_s is None else float(timeout_s)
    deadline = time.monotonic() + wait_s
    while True:
        missing = [pid for pid in range(g.num_processes)
                   if not os.path.exists(g._file(name, seq, pid))]
        if not missing:
            break
        if time.monotonic() > deadline:
            _on_barrier_timeout(g, name, missing, wait_s)
        time.sleep(g.poll_s)
    # seq is complete on every rank: this rank's files of older seqs are
    # never awaited again
    for old in range(max(0, seq - 2), seq):
        try:
            os.unlink(g._file(name, old, g.process_id))
        except OSError:
            pass


def checkpoint_barrier(tag: str) -> None:
    """An agreement point of the sharded checkpoint protocol: guarded when
    a guard is configured, else `dist.barrier` (a save is coordinated even
    without the timeout protocol). One process: a no-op."""
    if world()[1] <= 1:
        return
    if _BARRIER is not None:
        guarded_barrier(f"ckpt.{tag}")
    else:
        dist.barrier()


def agree_on_failure(error: BaseException) -> Optional[BarrierTimeoutError]:
    """After `error` on a rank that is alive: hold the `peer_lost` guarded
    barrier for the guard's timeout plus the process group's, longer than
    a live peer can stay blocked in a collective this rank left. A rank
    that does not reach it is lost, and the BarrierTimeoutError (marker
    written, recorder dumped) is returned for the caller to exit with;
    None when there is no guard, or every rank reached it (the error was
    not a peer loss)."""
    if _BARRIER is None or _BARRIER.num_processes <= 1:
        return None
    try:
        # without a process group no collective can hold a peer
        held_s = group_timeout().total_seconds() if dist.is_initialized() else 0.0
        guarded_barrier("peer_lost", _BARRIER.timeout_s + held_s)
    except BarrierTimeoutError as lost:
        lost.__cause__ = error
        return lost
    return None
