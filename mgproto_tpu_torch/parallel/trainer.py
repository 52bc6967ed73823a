"""The Trainer over a rank mesh (counterpart of mgproto_tpu/parallel/trainer.py).

The JAX `ShardedTrainer` jits the single-chip step with shardings pinned
and lets SPMD partitioning insert the collectives. Here each rank runs
engine/train.py's step on its own rows, and the collectives are written
out:

  * the batch is sharded over every rank: `train_step` and `eval_step`
    take this rank's rows (the sharded loader's, data/__init__.py, or
    `parallel/sharding.py::put_batch` of a global batch);
  * BatchNorm's batch statistics are summed over the world
    (models/common.py `stats_group`), in the forward and in a remat
    recompute alike;
  * each rank's loss is its share of the global means, the aux loss sees
    the global batch, and one flat sum-all-reduce of the gradients (and
    the scalars) after the backward gives every rank the global gradient
    (engine/train.py `_loss`, `_sum_over_world`); the parameters start
    equal (`prepare` broadcasts rank 0's) and stay bit-identical;
  * when the model axis is above 1, the parameters, the proxies and both
    Adam moments of the joint and warm optimizers are held cut at rest
    (`parallel/sharding.py::shard_params`, JAX's rule "param"): each leaf
    whose spec names 'model' keeps only this rank's slice of its spec's
    axis, in storage of its own. A step gathers the whole tensors over the
    model group before the forward and keeps them through the backward
    (a remat recompute, the bf16 trunk's per-call casts), sums each cut
    leaf's gradient over the world as a reduce-scatter over the model
    group and a sum over the data group, puts the slices back and steps
    Adam on them (elementwise, so the slice's update is the whole
    tensor's cut). The finiteness flag is summed over the model group, so
    every rank takes the same branch. The ranks of a model column hold
    the same slices bit for bit, so the gathered parameters are equal on
    every rank. A reader outside a step (the eval step, the test pass,
    the push, the interpretability passes, `full_state`, the replicated
    save) takes the whole tensors through `full_params(state)`, a
    collective of the model group that nests;
  * when the model axis divides the classes, the GMM, the bank and the
    mean-Adam state hold this rank's class slab (`parallel/sharding.py`):
    score_pool and its backward run on the slab for the model group's rows
    (core/mgproto.py `head_forward`), the enqueue sees the global batch's
    candidates and keeps its slab's, and EM runs on the slab with its gate
    and scalars summed over the group (core/em.py).

The async bank pipeline (`EMConfig.async_bank`) runs at any mesh, as the
JAX `ShardedTrainer` does: the trunk scores a copy of the one-step-stale
means of its class slab, and the held bank phase issues its gather of the
global batch's candidates and EM's model-group sums on process groups of
its own (`collectives.bank_groups`, made here by every rank together).

Checkpoints (`Trainer.save`): sharded under several ranks by default,
each rank writing what it owns (the first rank of a model column its
class slab and its slices of the parameters and moments, with their span
on the spec's axis; rank 0 every leaf held whole), or replicated (the
slabs and slices gathered, rank 0 writes); either restores onto any mesh,
whole first and then cut to each rank's slab and slices here, so a
checkpoint of N ranks restores onto M.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from mgproto_tpu_torch.config import Config
from mgproto_tpu_torch.core.em import resolve_em_config
from mgproto_tpu_torch.core.state import TrainState
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models.common import set_stats_group
from mgproto_tpu_torch.parallel.collectives import bank_groups, broadcast_tensors
from mgproto_tpu_torch.parallel.mesh import Mesh, make_mesh
from mgproto_tpu_torch.parallel.sharding import holds_slices, shard_classes, shard_params
from mgproto_tpu_torch.utils.checkpoint import restore_checkpoint


class ShardedTrainer(Trainer):
    """`ShardedTrainer(cfg, steps_per_epoch, mesh=None, device=None)`: the
    mesh defaults to `make_mesh(cfg.mesh.data, cfg.mesh.model)` over the
    process group (one rank outside one, where this is the Trainer).
    States pass through `prepare` once (`init_state` and `restore` do)."""

    def __init__(self, cfg: Config, steps_per_epoch: int, mesh: Optional[Mesh] = None,
                 device: Union[str, torch.device, None] = None):
        super().__init__(cfg, steps_per_epoch, device=device)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh.data, cfg.mesh.model)
        c, m = cfg.model.num_classes, self.mesh
        if m.model > 1 and c % m.model and cfg.model.fused_scoring is True:
            raise ValueError(
                f"fused_scoring=True requires num_classes ({c}) divisible by the mesh model "
                f"axis ({m.model}); adjust --mesh_model or drop --fused_scoring")
        self._world_group = m.world_group
        self._class_mesh = m if m.shards_classes(c) else None
        self._param_mesh = m if m.model > 1 else None
        if self.async_bank and m.size > 1:
            bank = bank_groups(m)
            self._bank_world = bank.world
            self._bank_class_mesh = bank.mesh if m.shards_classes(c) else None
        # the auto EM width is the GLOBAL batch's (each rank gets b rows)
        self.em_cfg = resolve_em_config(cfg.em, c, cfg.data.train_batch_size * m.size)

    def prepare(self, state: TrainState) -> TrainState:
        """Place `state` on the mesh in place: the model's parameters and
        buffers and the proxies set to rank 0's, then (model axis above 1)
        the parameters, the proxies and the joint and warm Adam moments cut
        to this rank's slices; BatchNorm's statistics over the world; and
        (when the model axis splits the classes) the GMM, the bank and the
        mean optimizer cut to this rank's slab. A state already prepared is
        left as it is."""
        if not holds_slices(state):
            if self._world_group is not None:
                tensors = list(state.model.parameters()) + list(state.model.buffers())
                if state.proxies is not None:
                    tensors.append(state.proxies)
                broadcast_tensors(tensors, 0, self._world_group)
            if self._param_mesh is not None:
                shard_params(state, self.mesh, self.cfg.model.num_classes)
        set_stats_group(state.model, self._world_group)
        if self._class_mesh is not None and state.gmm.num_classes == self.cfg.model.num_classes:
            shard_classes(state, self.mesh)
        return state

    def init_state(self, seed: int = 0, for_restore: bool = False) -> TrainState:
        return self.prepare(super().init_state(seed, for_restore=for_restore))

    def restore(self, path: str, state: Optional[TrainState] = None) -> TrainState:
        """The checkpoint at `path` (replicated or sharded, from any number
        of ranks) restored whole on every rank and cut to this rank's slab
        and slices; `state` is not used (the restore target is whole)."""
        full = Trainer.init_state(self, 0, for_restore=True)
        return self.prepare(restore_checkpoint(path, full))
