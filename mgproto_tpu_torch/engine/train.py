"""The synchronous train step and the epoch driver (counterpart of the JAX
package's `Trainer._step` and `Trainer.train_epoch`, mgproto_tpu/engine/train.py).

One step: the forward in train mode (BatchNorm batch statistics; the trunk
in `ModelConfig.compute_dtype`, everything after it in f32, as
`Trainer.precision` states), the CE + mine + aux losses (`LossConfig.
aux_loss`), the backward, the divergence guard, the optimizer step, then
the bank phase (memory enqueue and gated EM, core/em.py `bank_update`;
`EMConfig.reference_stepping` selects the reference's sequential EM). On CUDA, with the config's `fused_*` flags left
at None, the path launches the score_pool forward and backward kernels, the
BN epilogue kernel (16 times at ResNet-34) and the em_estep kernel
(`num_em_loop` times per EM call).

The JAX gates are traced scalars; here they are host-side Python. The step
reads the device once: the divergence-guard flag together with the EM
gate's counts (`bank_update`). A non-finite loss or gradient leaves the
parameters, the optimizer state, the BatchNorm running statistics (restored
from a snapshot taken before the forward), the bank and the GMM unchanged;
`step` counts attempts either way. The state is updated in place.

The async bank pipeline (`EMConfig.async_bank`, the JAX `_async_train_step`):
batch N's trunk (forward, losses, backward, optimizer) scores a copy of the
means taken after the newest completed bank phase (one step stale), then
batch N-1's held bank phase (`bank_update`, the one bank function of both
modes) is dispatched, on CUDA on a second stream, and batch N's enqueue
candidates are held for the next step. The trunk's optimizer gate reads its
own finiteness flag, after the bank's dispatch, so the bank stream runs
while the trunk's backward does. The bank stream waits on an event recorded
right after the copy, so the in-place EM writes of the means never race
the trunk's reads; every tensor the bank reads is marked used by its stream
(`record_stream`), so the caching allocator does not hand a freed block to
the main stream while the bank still reads it; and the main stream waits
for the bank's completion event before the step returns, so the metrics,
the next copy and everything after the epoch read a finished bank.
Each step also measures the JAX package's overlap estimate: the host
dispatch clock from one held bank dispatch to the end of the next trunk's
dispatch (`bank_overlap_step_s`, an upper bound on the device overlap),
which `train_epoch` feeds to the StepMonitor's
`bank_dispatch_overlap_fraction` gauge. `train_epoch` resets the
pipeline at its start and flushes it at its end and on a preemption; a
`DivergenceError` leaves held work that the next reset discards. Under a
mesh (parallel/trainer.py) the trunk holds its own rows' enqueue
candidates, and the bank phase issues its collectives (the
gather of the global batch's candidates, EM's sums over the model group)
on process groups of its own (`parallel/collectives.py::bank_groups`)
from inside the bank stream, so gloo's staging copies of CUDA tensors
wait for the bank stream's kernels and the trunk's collectives never
queue behind them.

Batch intake (the JAX `put_batch`): uint8 images stay uint8 on the wire.
On CUDA a host batch is staged in pinned memory and copied on a dedicated
copy stream; the step's stream waits on the copy's event and marks the
tensors as used by it, so neither the pinned source nor the device copy is
reused while in flight. With device augmentation on (`DataConfig.
device_augment`; None = on for CUDA), the loader's per-sample seeds become
a [B, 5] tensor of draws on the host (ops/augment.py `augment_draws`), and
`augment_tail` turns the uint8 batch into the normalized f32 batch on the
device before the trunk, outside autograd. A batch whose dtype does not
match the setting (f32 with augmentation on, uint8 with it off) is
refused. Each put records timing events around its copies, so
`train_epoch`'s step log holds each batch's copy time on the card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Union

import numpy as np
import torch

from mgproto_tpu_torch.config import Config
from mgproto_tpu_torch.core import losses as L
from mgproto_tpu_torch.core.em import BankAux, bank_update, resolve_em_config
from mgproto_tpu_torch.core.mgproto import head_forward
from mgproto_tpu_torch.core.state import TrainState, create_train_state, set_joint_lrs
from mgproto_tpu_torch.data.loader import device_prefetch
from mgproto_tpu_torch.engine.eval import EvalOutput, eval_forward, eval_mode, to_device_images
from mgproto_tpu_torch.models.common import BatchNorm
from mgproto_tpu_torch.numerics import apply_numerics_policy, resolve_device, use_kernel
from mgproto_tpu_torch.obs.flightrec import record_event
from mgproto_tpu_torch.ops.augment import augment_draws, augment_tail, resolve_device_augment
from mgproto_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_sum,
    group_size,
    sum_tensors,
)
from mgproto_tpu_torch.parallel.multihost import fetch_replicated, heartbeat_tick
from mgproto_tpu_torch.parallel.sharding import (
    gather_params,
    holds_slices,
    scatter_grads,
    whole_params,
)
from mgproto_tpu_torch.perf.precision import resolve_policy
from mgproto_tpu_torch.telemetry.monitor import ColdPaths
from mgproto_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    cross_entropy: torch.Tensor
    mine: torch.Tensor
    aux: torch.Tensor
    accuracy: torch.Tensor
    full_mem_ratio: torch.Tensor  # fraction of classes with a full queue
    em_active: int  # classes EM touched this step (epoch max after train_epoch)
    em_compact_fallback: int  # 0/1 per step, epoch sum after train_epoch
    nonfinite: bool  # this step's update was skipped


class DeviceBatch(NamedTuple):
    """A batch placed by `Trainer.put_batch`: images (uint8 or f32
    [B, H, W, 3]), labels [B] int64, the augmentation draws [B, 5] f32
    (None when device augmentation is off), the timing events recorded
    on the copy stream before and after the copies (None on the CPU) and
    the bytes copied host-to-device (images, all)."""

    images: torch.Tensor
    labels: torch.Tensor
    draws: Optional[torch.Tensor]
    ready: Optional[torch.cuda.Event]
    copy_start: Optional[torch.cuda.Event]
    image_bytes: int
    h2d_bytes: int

    def copy_ms(self) -> Optional[float]:
        """Device time of the host-to-device copies in ms, from the copy
        stream's events (waits for the copies); None on the CPU."""
        if self.ready is None:
            return None
        self.ready.synchronize()
        return self.copy_start.elapsed_time(self.ready)


class StepRecord(NamedTuple):
    """One step of `train_epoch` on the host clock: `wait_s`, the blocking
    part of fetching the batch (loader decode/IPC and the pinned staging
    of the next batches); `step_s`, from the end of the previous step to
    the end of this one, so the steps sum to the epoch's wall time."""

    wait_s: float
    step_s: float
    image_bytes: int
    h2d_bytes: int
    copy_ms: Optional[float]  # `DeviceBatch.copy_ms`; None on the CPU


class _TrunkOut(NamedTuple):
    """What a trunk pass leaves for the bank phase and the optimizer gate."""

    loss: torch.Tensor
    enq: tuple  # the enqueue candidates (feats, classes, valid)
    ce: torch.Tensor
    mine: torch.Tensor
    aux: torch.Tensor
    acc: torch.Tensor
    finite: torch.Tensor  # device bool: loss and every gradient finite
    stats: list  # BatchNorm running statistics, updated by the forward
    snapshot: Optional[torch.Tensor]  # their values before the forward


def split_batch(batch):
    """A `DataLoader` batch, (images, labels), (images, labels, ids) or
    (images, labels, ids, seeds) -> (images, labels, seeds or None)."""
    if len(batch) == 4:
        return batch[0], batch[1], batch[3]
    if len(batch) in (2, 3):
        return batch[0], batch[1], None
    raise ValueError(f"a batch is (images, labels[, ids[, seeds]]), got {len(batch)} arrays")


class Trainer:
    """`Trainer(cfg, steps_per_epoch, device)` owns the step; all state is in
    the `TrainState` it is handed. `device=None` means CUDA, or raise."""

    def __init__(self, cfg: Config, steps_per_epoch: int,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        apply_numerics_policy()
        # what runs in which dtype (perf/precision.py); validates the config
        self.precision = resolve_policy(cfg)
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.fused = use_kernel(cfg.model.fused_scoring, self.device)
        self.em_cfg = resolve_em_config(cfg.em, cfg.model.num_classes, cfg.data.train_batch_size)
        self.device_augment = resolve_device_augment(cfg.data.device_augment, self.device)
        self.last_bank: BankAux = BankAux(0, 0, None)  # the last step's bank phase
        self.step_log: List[StepRecord] = []  # the last train_epoch's steps
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        # `EMConfig.async_bank` None (auto) is off: the JAX rule turns it on
        # for a TPU only, and on CUDA a measurement has not decided it yet
        self.async_bank = bool(cfg.em.async_bank)
        self._bank_stream = (torch.cuda.Stream(self.device)
                             if self.async_bank and self.device.type == "cuda" else None)
        self._held = None  # the held bank phase: (enq, step0, update_gmm, finite)
        self._snap_ready: Optional[torch.cuda.Event] = None  # main stream, after the copy
        self._bank_done: Optional[torch.cuda.Event] = None  # bank stream, after its phase
        # the overlap clock: when the last held bank phase was dispatched,
        # and the last step's estimate (host seconds; 0 in sync mode)
        self._bank_dispatch_t: Optional[float] = None
        self.bank_overlap_step_s = 0.0
        # one process: no mesh. parallel/trainer.py's ShardedTrainer sets
        # the mesh, the group its batch is sharded over (every rank) and,
        # when its model axis splits the classes, `_class_mesh`
        self.mesh = None
        self._world_group = None
        self._class_mesh = None
        # the mesh when its model axis cuts the parameters and their moments
        # (parallel/sharding.py `shard_params`), else None
        self._param_mesh = None
        # the async bank phase's own groups under a mesh (bank_groups): the
        # world for the candidates' gather, the mesh when it splits classes
        self._bank_world = None
        self._bank_class_mesh = None
        # checkpoint format: None = sharded under several ranks (run_training
        # sets it from --ckpt_format)
        self.ckpt_sharded: Optional[bool] = None
        # the step's cold paths (telemetry/monitor.py): each batch shape's
        # first step, kernel builds after the first step
        self.cold_paths = ColdPaths()

    def init_state(self, seed: int = 0, for_restore: bool = False) -> TrainState:
        """A fresh state from `seed`; `for_restore=True` builds a restore
        target, which skips the pretrained trunk load."""
        return create_train_state(self.cfg, torch.Generator().manual_seed(int(seed)), self.device,
                                  for_restore=for_restore)

    def put_batch(self, batch) -> DeviceBatch:
        """(images, labels[, ids][, seeds]) host arrays -> a DeviceBatch.
        uint8 images stay uint8; any other dtype becomes f32. Seeds (or
        zero seeds, when device augmentation is on and none came) become
        the [B, 5] draws. On CUDA the copies are issued on the copy stream
        from pinned memory and return at once."""
        images, labels, seeds = split_batch(batch)
        images = _host_tensor(images)
        if images.dtype != torch.uint8:
            images = images.to(torch.float32)
        labels = _host_tensor(labels).to(torch.int64)
        draws = None
        if self.device_augment:
            seeds = (np.zeros(images.shape[0], np.uint32) if seeds is None
                     else _host_tensor(seeds).numpy())
            draws = torch.from_numpy(augment_draws(seeds))
        host = [t.contiguous() for t in (images, labels) + ((draws,) if draws is not None else ())]
        nbytes = sum(t.numel() * t.element_size() for t in host if t.device.type == "cpu")
        image_bytes = host[0].numel() * host[0].element_size()
        if self._copy_stream is None:
            out = [t.to(self.device) for t in host]
            start = ready = None
        else:
            host = [t.pin_memory() if t.device.type == "cpu" and not t.is_pinned() else t
                    for t in host]
            start = torch.cuda.Event(enable_timing=True)
            ready = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(self._copy_stream):
                start.record(self._copy_stream)
                out = [t.to(self.device, non_blocking=True) for t in host]
                ready.record(self._copy_stream)
        return DeviceBatch(out[0], out[1], out[2] if draws is not None else None, ready,
                           start, image_bytes, nbytes)

    def _claim(self, batch: DeviceBatch):
        """Make the step's stream wait for a put batch and own its tensors
        (the caching allocator then keeps them until that stream is done)."""
        if batch.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(batch.ready)
            for t in (batch.images, batch.labels, batch.draws):
                if t is not None:
                    t.record_stream(stream)
        return batch

    def _loss(self, state: TrainState, images: torch.Tensor, labels: torch.Tensor,
              use_mine: float, gmm):
        """The JAX `_loss_fn` against `gmm`: (loss, (enq, ce, mine, aux,
        accuracy)).

        Under a mesh of n ranks each holds 1/n of the global batch, and
        the returned loss, ce, mine and accuracy are this rank's SHARE of
        the global means (its rows' mean over n), so that one sum over the
        ranks gives the global value and the summed gradients the global
        gradient (`_sum_over_world`). The aux loss couples the batch's
        rows (per-class sums, [B, B] pair masks): it runs on the
        embeddings and labels of every rank, gathered in rank order, and
        is the same on every rank; its share is 1/n of it, so the gather's
        backward hands each rank the whole gradient of its rows and the
        replicated proxies collect theirs once. The enqueue candidates are
        the global batch's, in global row order."""
        proto_map, embed = state.model(images)
        gmm = gmm._replace(means=gmm.means.detach())
        logits, _, enq = head_forward(
            proto_map, gmm, labels, self.cfg.model.mine_T, fused=self.fused,
            mesh=self._class_mesh,
        )
        world, n = self._world_group, group_size(self._world_group)
        ce = L.cross_entropy(logits[..., 0], labels)
        mine = L.mine_loss(logits, labels) * float(use_mine)
        aux = L.aux_loss(self.cfg.loss.aux_loss, all_gather(embed, 0, world),
                         all_gather(labels, 0, world), state.proxies)
        c = self.cfg.loss
        loss = c.crs_ent * ce + c.mine * mine + c.aux * aux
        acc = (logits[..., 0].argmax(-1) == labels).float().mean()
        if not self.async_bank:  # the async bank phase gathers on its own groups
            enq = tuple(all_gather(t, 0, world) for t in enq)
        if n == 1:
            return loss, (enq, ce, mine, aux, acc)
        return loss / n, (enq, ce / n, mine / n, aux, acc / n)

    def _sum_over_world(self, params, loss, ce, mine, acc, held=()):
        """Under a mesh: every whole gradient and the four shares summed
        over the ranks, as one flat all-reduce in the parameters' order, so
        every rank holds the global gradient and scalars, bit for bit alike
        (and takes the same optimizer and divergence-guard branch); the
        gradients of the leaves `gather_params` opened (`held`) summed and
        cut to this rank's slices (`scatter_grads`), their slices put back.
        One process: as they are."""
        if self._world_group is None:
            return loss, ce, mine, acc
        cut = {id(t) for t, _ in held}
        scalars = torch.stack([loss.detach(), ce.detach(), mine.detach(), acc.detach()])
        sum_tensors([p.grad for p in params if p.grad is not None and id(p) not in cut]
                    + [scalars], self._world_group)
        scatter_grads(list(held), self.mesh)
        return tuple(scalars)

    def full_mem_ratio(self, mem) -> torch.Tensor:
        """The fraction of all classes whose queue is full (under a mesh
        that splits the classes, summed over the model group's slabs)."""
        return _full_ratio(mem, self._class_mesh)

    def class_slab(self):
        """[c0, c1): the classes this trainer's state holds."""
        c = self.cfg.model.num_classes
        return (0, c) if self._class_mesh is None else self._class_mesh.class_slab(c)

    def full_gmm(self, state: TrainState):
        """The GMM of every class: the state's own, or under a mesh that
        splits the classes its slabs gathered over the model group (a
        collective: every rank of the group calls it)."""
        if self._class_mesh is None:
            return state.gmm
        return fetch_replicated(state.gmm, self._class_mesh, self.cfg.model.num_classes)

    @contextlib.contextmanager
    def full_params(self, state: TrainState, moments: bool = False) -> Iterator[TrainState]:
        """Lend the block the whole parameters and proxies of `state` (with
        `moments`, the joint and warm Adam moments too): under a mesh that
        cuts them (parallel/sharding.py `whole_params`) gathered over the
        model group on entry, every rank of the group together, and cut
        back on exit; calls nest. One process, or nothing cut: a no-op."""
        with whole_params(state, self._param_mesh, moments) as st:
            yield st

    def full_state(self, state: TrainState) -> TrainState:
        """`state` with every class (`full_gmm`'s gather for the GMM, the
        bank and the mean optimizer). It shares the model and the joint and
        warm optimizers with `state`: under a mesh that cuts the parameters,
        call it inside `full_params(state, moments=True)`, or it raises."""
        if self._param_mesh is not None and holds_slices(state):
            raise RuntimeError("full_state: the parameters or moments hold this rank's "
                               "slices; call it inside trainer.full_params(state, "
                               "moments=True)")
        if self._class_mesh is None:
            return state
        return fetch_replicated(state, self._class_mesh, self.cfg.model.num_classes)

    def save(self, ckpt_dir: str, state: TrainState, name: str,
             metadata: Optional[dict] = None) -> str:
        """Write `state` as the checkpoint `ckpt_dir/name`
        (utils/checkpoint.py) in the format `ckpt_sharded` names (None:
        sharded under several ranks). Under a mesh every rank calls it:
        sharded, each rank writes what it owns of its state (its class
        slab, its slices of the parameters and moments); replicated, the
        state is gathered (`full_params`, `full_state`) and rank 0 writes
        it."""
        sharded = self.ckpt_sharded
        if sharded is None:
            sharded = self._world_group is not None
        if sharded:
            return save_checkpoint(ckpt_dir, state, name, metadata=metadata, sharded=True,
                                   mesh=self.mesh, num_classes=self.cfg.model.num_classes)
        with self.full_params(state, moments=True):
            return save_checkpoint(ckpt_dir, self.full_state(state), name, metadata=metadata,
                                   sharded=False)

    def restore(self, path: str, state: TrainState) -> TrainState:
        """`state` restored from the checkpoint at `path`
        (utils/checkpoint.py `restore_checkpoint`)."""
        return restore_checkpoint(path, state)

    @staticmethod
    def params(state: TrainState):
        """Every differentiated leaf: the model's parameters (the frozen
        embedding included, as the JAX guard sums its gradient too) and the
        proxies, where the aux loss has them."""
        proxies = [] if state.proxies is None else [state.proxies]
        return list(state.model.parameters()) + proxies

    def train_step(self, state: TrainState, images, labels, use_mine: bool,
                   update_gmm: bool, warm: bool = False, seeds=None):
        """One synchronous step on a host batch (or a DeviceBatch from
        `put_batch` as `images`, with `labels` None); `seeds` [B] uint32 are
        the loader's augmentation seeds, zero seeds when None (used only
        with device augmentation on). Images are uint8 pixels with device
        augmentation on and normalized floats with it off; the other way
        round raises ValueError. Returns (state, TrainMetrics)."""
        batch = images if isinstance(images, DeviceBatch) else self.put_batch(
            (images, labels) if seeds is None else (images, labels, None, seeds))
        batch = self._claim(batch)
        images, labels = batch.images, batch.labels
        if self.device_augment != (images.dtype == torch.uint8):
            raise ValueError(
                f"{str(images.dtype).removeprefix('torch.')} images with device augmentation "
                f"{'on' if self.device_augment else 'off'} (DataConfig.device_augment): "
                "the augmentation tail takes uint8 pixels, the trunk normalized f32")
        if self.device_augment:
            with torch.no_grad():  # inputs, not parameters
                images = augment_tail(images, batch.draws)
        if self.async_bank:
            out = self._async_train_step(state, images, labels, use_mine, update_gmm, warm)
            self.cold_paths.note(images.shape)
            return out
        trunk = self._trunk_step(state, images, labels, use_mine, state.gmm)
        step0 = state.step
        state.step += 1  # counts attempts
        state.gmm, state.memory, bank, ok = bank_update(
            state.gmm, state.memory, state.mean_opt, self.em_cfg,
            *trunk.enq, step0, update_gmm, trunk.finite, mesh=self._class_mesh,
        )
        self.last_bank = bank
        self._apply_trunk(state, trunk, ok, warm)
        self.cold_paths.note(images.shape)
        return state, self._metrics(trunk, self.full_mem_ratio(state.memory), bank, ok)

    def _trunk_step(self, state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                    use_mine: bool, gmm) -> _TrunkOut:
        """Forward in train mode against `gmm`, losses, backward and the
        finiteness flag (the JAX `_trunk_step` up to its optimizer gate)."""
        model = state.model.train()
        params = self.params(state)
        for p in params:
            p.grad = None
        stats = [t for m in model.modules() if isinstance(m, BatchNorm)
                 for t in (m.running_mean, m.running_var)]
        # one copy of every running statistic (none in a trunk without
        # BatchNorm, e.g. VGG without _bn)
        snapshot = torch.cat([t.reshape(-1) for t in stats]) if stats else None

        # under a mesh that cuts the parameters: the whole tensors through
        # the forward and the backward (a remat recompute included)
        held = gather_params(params, self._param_mesh)
        loss, (enq, ce, mine, aux, acc) = self._loss(state, images, labels, use_mine, gmm)
        loss.backward()
        loss, ce, mine, acc = self._sum_over_world(params, loss, ce, mine, acc, held)
        grad_sums = torch.stack([p.grad.sum() for p in params if p.grad is not None])
        if not held:
            finite = torch.isfinite(loss) & torch.isfinite(grad_sums).all()
        else:  # this rank's slices: the model group's count covers the whole gradient
            bad = (~torch.isfinite(grad_sums)).sum(dtype=torch.float32).reshape(1)
            sum_tensors([bad], self.mesh.model_group)
            finite = torch.isfinite(loss) & (bad[0] == 0)
        return _TrunkOut(loss, enq, ce, mine, aux, acc, finite, stats, snapshot)

    def _apply_trunk(self, state: TrainState, trunk: _TrunkOut, ok: bool, warm: bool) -> None:
        """The optimizer step when `ok`, else the BatchNorm statistics put
        back from the snapshot taken before the forward."""
        if ok:
            if warm:
                state.warm_opt.step()
            else:
                set_joint_lrs(self.cfg, state, self.steps_per_epoch)
                state.opt.step()
                state.joint_updates += 1
        elif trunk.stats:
            with torch.no_grad():
                for t, old in zip(trunk.stats,
                                  trunk.snapshot.split([t.numel() for t in trunk.stats])):
                    t.copy_(old.view_as(t))

    @staticmethod
    def _metrics(trunk: _TrunkOut, full_mem_ratio: torch.Tensor, bank: BankAux,
                 ok: bool) -> TrainMetrics:
        return TrainMetrics(
            loss=trunk.loss.detach(), cross_entropy=trunk.ce.detach(), mine=trunk.mine.detach(),
            aux=trunk.aux.detach(), accuracy=trunk.acc, full_mem_ratio=full_mem_ratio,
            em_active=bank.num_active, em_compact_fallback=bank.compact_fallback,
            nonfinite=not ok,
        )

    # ------------------------------------------------- async bank pipeline
    def _async_train_step(self, state: TrainState, images, labels, use_mine: bool,
                          update_gmm: bool, warm: bool):
        """One pipelined step: batch N's trunk against a copy of the means
        after the newest completed bank phase, then batch N-1's held bank
        phase, then batch N's candidates held. Metrics mix batch N's trunk
        scalars with batch N-1's bank scalars (zeros on the fill step)."""
        gmm = state.gmm._replace(means=state.gmm.means.detach().clone())
        if self._bank_stream is not None:
            self._snap_ready = torch.cuda.Event()
            self._snap_ready.record()
        trunk = self._trunk_step(state, images, labels, use_mine, gmm)
        now = time.perf_counter()
        # close the overlap window: the bank phase dispatched last was in
        # flight across this step's fetch and trunk dispatch (JAX's host
        # dispatch-clock estimate, an upper bound on the device overlap)
        self.bank_overlap_step_s = (0.0 if self._bank_dispatch_t is None
                                    else now - self._bank_dispatch_t)
        self._bank_dispatch_t = None
        step0 = state.step
        state.step += 1  # counts attempts
        flushed = self._dispatch_pending_bank(state)
        self._held = (trunk.enq, step0, update_gmm, trunk.finite)
        # the trunk's own gate: on CUDA this waits for batch N's backward on
        # the main stream only, while the bank stream works
        ok = bool(trunk.finite)
        self._apply_trunk(state, trunk, ok, warm)
        self._join_bank()
        if flushed is None:
            bank, fm = BankAux(0, 0, None), torch.zeros((), device=self.device)
        else:
            bank, fm = flushed
        self.last_bank = bank
        return state, self._metrics(trunk, fm, bank, ok)

    def _dispatch_pending_bank(self, state: TrainState):
        """Dispatch the held bank phase against `state` (in place): returns
        (BankAux, full_mem_ratio) or None when nothing is held. On CUDA it
        runs on the bank stream after the copy of the means; the kernels
        take the current stream, so the E-step lands there too."""
        held, self._held = self._held, None
        if held is None:
            return None
        (feats, classes, valid), step0, update_gmm, finite = held

        def bank():
            enq = (feats, classes, valid)
            if self._bank_world is not None:  # the global batch's candidates
                enq = tuple(all_gather(t, 0, self._bank_world) for t in enq)
            mesh = self._bank_class_mesh
            state.gmm, state.memory, aux, _ = bank_update(
                state.gmm, state.memory, state.mean_opt, self.em_cfg,
                *enq, step0, update_gmm, finite, mesh=mesh,
            )
            return aux, _full_ratio(state.memory, mesh)

        stream = self._bank_stream
        if stream is None:
            out = bank()
        else:
            stream.wait_event(self._snap_ready)
            for t in (feats, classes, valid, finite, *state.gmm, *state.memory):
                t.record_stream(stream)
            with torch.cuda.stream(stream):
                out = bank()
                self._bank_done = torch.cuda.Event()
                self._bank_done.record(stream)
        # opens the overlap window the next trunk dispatch closes
        self._bank_dispatch_t = time.perf_counter()
        return out

    def _join_bank(self) -> None:
        """Make the current stream wait for the last dispatched bank phase."""
        if self._bank_done is not None:
            torch.cuda.current_stream(self.device).wait_event(self._bank_done)
            self._bank_done = None

    def flush_bank(self, state: TrainState):
        """Drain the pipeline: dispatch the held bank phase (the last
        batch's enqueue and EM) and wait for it. Returns (state, (BankAux,
        full_mem_ratio) or None). Runs before anything reads the bank as
        current: `train_epoch` calls it at its end and on a preemption. A
        no-op in sync mode or when nothing is held."""
        if self._held is None:
            return state, None
        if self._bank_stream is not None:
            self._snap_ready = torch.cuda.Event()
            self._snap_ready.record()
        out = self._dispatch_pending_bank(state)
        self._bank_dispatch_t = None  # no trunk follows: nothing overlaps
        self._join_bank()
        return state, out

    def reset_bank_pipeline(self) -> None:
        """Discard the held bank phase (at epoch start: after a divergence
        rollback the held candidates belong to a state that is gone). The
        current stream waits for the bank stream, so a restore after this
        never races a bank phase still running."""
        self._held = None
        if self._bank_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._bank_stream)
        self._bank_done = None
        self._bank_dispatch_t = None
        self.bank_overlap_step_s = 0.0

    def eval_step(self, state: TrainState, images, labels=None) -> EvalOutput:
        """The eval forward of `state` on one host batch of normalized f32
        images (the JAX `eval_step`): the state's model in eval mode under
        inference mode for the call, its train mode put back after, so the
        next train step sees the state as it was."""
        if labels is not None:
            labels = _host_tensor(labels).to(torch.int64)
        x = to_device_images(images, self.device)
        with self.full_params(state), eval_mode(state.model) as model:
            out = eval_forward(model, state.gmm, x, labels, self.cfg.model.mine_T, self.fused,
                               mesh=self._class_mesh)
        self.cold_paths.note(("eval",) + tuple(x.shape))
        return out

    def epoch_flags(self, state: TrainState, epoch: int) -> Dict[str, bool]:
        """Python-side epoch gates (the JAX `epoch_flags`)."""
        s = self.cfg.schedule
        all_full = bool(self.full_mem_ratio(state.memory) == 1.0)
        return {
            "warm": epoch < s.num_warm_epochs,
            "use_mine": epoch >= s.mine_start,
            "update_gmm": (epoch >= s.update_gmm_start) and all_full,
        }

    def train_epoch(self, state: TrainState, batches: Iterable, epoch: int, guard=None,
                    flags: Optional[Dict[str, bool]] = None, monitor=None, window=None):
        """Steps over host batches, (images, labels[, ids][, seeds]) as
        `split_batch` reads them (a `DataLoader`'s batches as they come),
        placed by `put_batch` through `device_prefetch` with
        `DataConfig.prefetch_depth` batches in flight. Returns (state, the
        last step's metrics), except `em_active` and `full_mem_ratio`,
        which are epoch maxima, and `em_compact_fallback`, the epoch sum
        (in async mode the flushed bank phase's scalars fold into them).
        Each step's loader wait and interval land in `self.step_log`.

        `flags`: the epoch's gates (`epoch_flags`); None computes them from
        `state`, which a mid-epoch resume must not do (the bank may have
        filled since the epoch began). `guard` (resilience/guard.py
        `EpochGuard`) wraps the placed batches (the chaos drill) and sees
        each step's metrics: it may stop the epoch after the step in flight
        (a preemption), or raise `DivergenceError`. On a stop, the batches
        already prefetched are dropped once their copies are done.

        `monitor` (telemetry/monitor.py `StepMonitor`) observes each step
        from the step log's figures: its interval, loader wait and
        host-to-device bytes (host arithmetic, no device read of its own),
        and in async mode the step's bank-dispatch overlap estimate.

        `window` (obs/profiler.py `ProfilerWindow`) observes each step too,
        with the step's loader-wait share: it opens and closes a profiler
        capture on its step range or its anomaly triggers (a spike over its
        EMA, a cold path through `monitor`, loader wait). Every step also
        lands on the flight recorder's ring, so a failure dump shows the
        steps that led to it."""
        self.reset_bank_pipeline()
        flags = self.epoch_flags(state, epoch) if flags is None else flags
        last = None
        em_max = fb_sum = 0
        fm_max = None
        self.step_log = []
        prefetched = device_prefetch(iter(batches), self.put_batch,
                                     depth=self.cfg.data.prefetch_depth)
        placed = prefetched
        if guard is not None:
            guard.begin_epoch(epoch, state)
            placed = guard.wrap_batches(prefetched)
        t_prev = time.perf_counter()
        try:
            while True:
                t_fetch = time.perf_counter()
                batch = next(placed, None)
                if batch is None:
                    break
                wait_s = time.perf_counter() - t_fetch
                state, last = self.train_step(state, batch, None, **flags)
                heartbeat_tick()  # the guarded barrier's liveness file, if armed
                now = time.perf_counter()
                step_s = now - t_prev
                # the step read the device, so the copy is done: no wait here
                self.step_log.append(StepRecord(wait_s, step_s, batch.image_bytes,
                                                batch.h2d_bytes, batch.copy_ms()))
                if monitor is not None:
                    monitor.observe_step(int(batch.images.shape[0]), step_s,
                                         transfer_bytes=batch.h2d_bytes, wait_seconds=wait_s,
                                         bank_overlap_seconds=self.bank_overlap_step_s)
                t_prev = now
                record_event("step", epoch=epoch, i=len(self.step_log) - 1,
                             seconds=round(step_s, 6), wait_s=round(wait_s, 6))
                if window is not None:
                    window.on_step(step_s, wait_fraction=wait_s / step_s if step_s > 0 else 0.0)
                em_max = max(em_max, last.em_active)
                fb_sum += last.em_compact_fallback
                fm = last.full_mem_ratio
                fm_max = fm if fm_max is None else torch.maximum(fm_max, fm)
                if guard is not None and guard.after_step(last):
                    break  # preemption: after the finished step
            # async mode: the last batch's bank phase is still held; drain
            # it so the returned state's bank is current (epoch_flags, the
            # test pass, checkpoints and the preempt save read it next)
            state, flushed = self.flush_bank(state)
            if flushed is not None:
                aux, fm = flushed
                em_max = max(em_max, aux.num_active)
                fb_sum += aux.compact_fallback
                fm_max = fm if fm_max is None else torch.maximum(fm_max, fm)
            if guard is not None:
                guard.end_epoch()
        finally:
            # a stop (preemption, divergence) leaves placed batches in the
            # prefetch queue: let their copies finish, then free them and
            # their pinned sources
            if self._copy_stream is not None:
                self._copy_stream.synchronize()
            prefetched.close()
        if last is not None:
            last = last._replace(em_active=em_max, full_mem_ratio=fm_max,
                                 em_compact_fallback=fb_sum)
        return state, last


def _full_ratio(mem, mesh) -> torch.Tensor:
    """The fraction of all classes whose queue is full; under `mesh` (one
    that splits the classes) summed over its model group's slabs."""
    full = (mem.length == mem.capacity).float()
    if mesh is None:
        return full.mean()
    return all_reduce_sum(full.sum(), mesh.model_group) / (mem.num_classes * mesh.model)


def _host_tensor(a) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) as a CPU tensor, no copy where
    none is needed."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))
