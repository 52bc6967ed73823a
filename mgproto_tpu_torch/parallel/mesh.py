"""The rank mesh and the process group bring-up (counterpart of
mgproto_tpu/parallel/mesh.py).

The JAX package runs one program over a `jax.sharding.Mesh` of chips with
two logical axes; here every rank is one process with one device, and the
world's ranks form the same grid, row-major as the JAX mesh reshapes its
devices: rank r sits at data index r // model and model index r % model.

  * ``data``  - the batch axis. The batch is sharded over EVERY rank (the
    JAX `batch_spec` shards it over both axes), so gradients and
    BatchNorm's batch statistics are summed over the whole world.
  * ``model`` - the class axis of the GMM head, the memory bank and the EM
    (parallel/sharding.py). A rank's `model_group` holds the ranks of its
    data row: they score one set of rows against the class slabs and
    together hold every class once.

`initialize_distributed` joins the process group once per process, before
any device use; `make_mesh` then builds the grid and its process groups.
The backend is the caller's choice, never switched on a failure: with none
named it is NCCL for a CUDA device and gloo for the CPU. Every group is
made with a timeout (the default group's, which `cli/common.py` ties to
--barrier_timeout_s), so a rank that died or hangs leaves its peers with
an error in their next collective, not a wait without end.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# seconds a collective may wait for its peers before it raises, unless
# the caller names its own (cli/common.py: --barrier_timeout_s)
DEFAULT_TIMEOUT_S = 600.0
_timeout_s = DEFAULT_TIMEOUT_S  # the default group's, for the groups made after it

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device: Union[str, torch.device]) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    strict: bool = False,
) -> bool:
    """Join the default process group (idempotent); True when this process
    is in one afterwards.

    With `init_method`, `rank` and `world_size` given, they are used as
    they are; otherwise the torch launcher's environment (`RANK`,
    `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`; `LOCAL_RANK` picks the
    card) is read. With neither, the call is a no-op (one process) unless
    `strict`, or explicit arguments, ask for a group: then it raises, as
    a worker that went on alone would train a model of its own while its
    peers wait. On a CUDA `device` the process's card is set to
    `cuda:LOCAL_RANK` before the group is made."""
    if dist.is_initialized():
        return True
    explicit = strict or any(a is not None for a in (init_method, rank, world_size))
    from_env = all(k in os.environ for k in _LAUNCHER_ENV)
    if init_method is None and not from_env:
        if explicit:
            raise RuntimeError(
                "initialize_distributed: no init_method given and the launcher's "
                f"environment ({', '.join(_LAUNCHER_ENV)}) is not set; start the ranks "
                "with torchrun or pass init_method, rank and world_size")
        return False
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError("initialize_distributed: init_method needs rank and world_size")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_device(device))
    global _timeout_s
    _timeout_s = float(timeout_s)
    dist.init_process_group(
        backend or default_backend(device), init_method=init_method, rank=int(rank),
        world_size=int(world_size), timeout=datetime.timedelta(seconds=float(timeout_s)))
    return True


def leave_process_group() -> None:
    """Leave the default process group, if this process is in one (a
    main's last step)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_device(device: Union[str, torch.device]) -> torch.device:
    """`device` for this process: a bare "cuda" is `cuda:LOCAL_RANK` (0
    when the launcher set none); anything else as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def mesh_shape(world_size: int, data: int = -1, model: int = 1) -> Tuple[int, int]:
    """The (data, model) grid of `world_size` ranks, with the JAX
    `make_mesh`'s errors: the model axis must divide the world, and
    data x model must be the world."""
    if model < 1 or world_size % model:
        raise ValueError(f"model axis {model} must divide device count {world_size}")
    if data == -1:
        data = world_size // model
    if data * model != world_size:
        raise ValueError(f"mesh {data}x{model} != {world_size} devices")
    return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the [data, model] grid and the process groups
    it takes part in: `model_group`, the ranks of its data row (the class
    axis), and `data_group`, the ranks of its model column. A group of one
    rank is None, and so is every group at world size 1: collectives over
    it are no-ops (parallel/collectives.py)."""

    data: int
    model: int
    rank: int
    model_group: Any = None
    data_group: Any = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def world_group(self) -> Any:
        """The default group (every rank), None at world size 1."""
        return dist.group.WORLD if self.size > 1 else None

    def shards_classes(self, num_classes: int) -> bool:
        """True when the class axis is split over `model`: a model axis
        above 1 that divides the class count. Otherwise the GMM, the bank
        and the EM are whole on every rank (the JAX spec rule replicates
        a class axis it cannot split)."""
        return self.model > 1 and num_classes % self.model == 0

    def class_slab(self, num_classes: int) -> Tuple[int, int]:
        """[c0, c1): the classes this rank holds."""
        if not self.shards_classes(num_classes):
            return 0, num_classes
        per = num_classes // self.model
        return self.model_index * per, (self.model_index + 1) * per


def group_timeout() -> datetime.timedelta:
    """The timeout of the groups made after the default one: the default
    group's own (`initialize_distributed`'s `timeout_s`)."""
    return datetime.timedelta(seconds=_timeout_s)


def grid_groups(data: int, model: int, rank: int, timeout_s: Optional[float] = None):
    """(model_group, data_group) of `rank` in a [data, model] grid, made
    as new process groups: every rank calls this together, in the same
    order (a group of one rank is None)."""
    timeout = (group_timeout() if timeout_s is None
               else datetime.timedelta(seconds=float(timeout_s)))
    grid = [[d * model + m for m in range(model)] for d in range(data)]
    model_group = data_group = None
    for d in range(data):  # the data rows: one class axis each
        g = dist.new_group(grid[d], timeout=timeout) if model > 1 else None
        if rank // model == d:
            model_group = g
    for m in range(model):  # the model columns
        g = (dist.new_group([row[m] for row in grid], timeout=timeout) if data > 1
             else None)
        if rank % model == m:
            data_group = g
    return model_group, data_group


def make_mesh(data: int = -1, model: int = 1, timeout_s: Optional[float] = None) -> Mesh:
    """The mesh over every rank of the default group (one rank outside a
    group). Every rank must call it, in the same order as its peers: each
    process group is made by all ranks together, with `timeout_s` (None:
    the default group's)."""
    rank, size = world()
    data, model = mesh_shape(size, data, model)
    if size == 1:
        return Mesh(data, model, rank)
    return Mesh(data, model, rank, *grid_groups(data, model, rank, timeout_s))
