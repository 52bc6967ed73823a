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

import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Union

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
from mgproto_tpu_torch.ops.augment import augment_draws, augment_tail, resolve_device_augment
from mgproto_tpu_torch.perf.precision import resolve_policy


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
              use_mine: float):
        """The JAX `_loss_fn`: (loss, (enq, ce, mine, aux, accuracy))."""
        proto_map, embed = state.model(images)
        gmm = state.gmm._replace(means=state.gmm.means.detach())
        logits, _, enq = head_forward(
            proto_map, gmm, labels, self.cfg.model.mine_T, fused=self.fused,
        )
        ce = L.cross_entropy(logits[..., 0], labels)
        mine = L.mine_loss(logits, labels) * float(use_mine)
        aux = L.aux_loss(self.cfg.loss.aux_loss, embed, labels, state.proxies)
        c = self.cfg.loss
        loss = c.crs_ent * ce + c.mine * mine + c.aux * aux
        acc = (logits[..., 0].argmax(-1) == labels).float().mean()
        return loss, (enq, ce, mine, aux, acc)

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
        model = state.model.train()
        params = self.params(state)
        for p in params:
            p.grad = None
        stats = [t for m in model.modules() if isinstance(m, BatchNorm)
                 for t in (m.running_mean, m.running_var)]
        # one copy of every running statistic (none in a trunk without
        # BatchNorm, e.g. VGG without _bn)
        snapshot = torch.cat([t.reshape(-1) for t in stats]) if stats else None

        loss, (enq, ce, mine, aux, acc) = self._loss(state, images, labels, use_mine)
        loss.backward()
        grad_sums = torch.stack([p.grad.sum() for p in params if p.grad is not None])
        finite = torch.isfinite(loss) & torch.isfinite(grad_sums).all()

        step0 = state.step
        state.step += 1  # counts attempts
        state.gmm, state.memory, bank, ok = bank_update(
            state.gmm, state.memory, state.mean_opt, self.em_cfg,
            *enq, step0, update_gmm, finite,
        )
        self.last_bank = bank
        if ok:
            if warm:
                state.warm_opt.step()
            else:
                set_joint_lrs(self.cfg, state, self.steps_per_epoch)
                state.opt.step()
                state.joint_updates += 1
        elif stats:
            with torch.no_grad():
                for t, old in zip(stats, snapshot.split([t.numel() for t in stats])):
                    t.copy_(old.view_as(t))
        mem = state.memory
        return state, TrainMetrics(
            loss=loss.detach(), cross_entropy=ce.detach(), mine=mine.detach(),
            aux=aux.detach(), accuracy=acc,
            full_mem_ratio=(mem.length == mem.capacity).float().mean(),
            em_active=bank.num_active, em_compact_fallback=bank.compact_fallback,
            nonfinite=not ok,
        )

    def eval_step(self, state: TrainState, images, labels=None) -> EvalOutput:
        """The eval forward of `state` on one host batch of normalized f32
        images (the JAX `eval_step`): the state's model in eval mode under
        inference mode for the call, its train mode put back after, so the
        next train step sees the state as it was."""
        if labels is not None:
            labels = _host_tensor(labels).to(torch.int64)
        with eval_mode(state.model) as model:
            return eval_forward(model, state.gmm, to_device_images(images, self.device), labels,
                                self.cfg.model.mine_T, self.fused)

    def epoch_flags(self, state: TrainState, epoch: int) -> Dict[str, bool]:
        """Python-side epoch gates (the JAX `epoch_flags`)."""
        s = self.cfg.schedule
        mem = state.memory
        all_full = bool((mem.length == mem.capacity).all())
        return {
            "warm": epoch < s.num_warm_epochs,
            "use_mine": epoch >= s.mine_start,
            "update_gmm": (epoch >= s.update_gmm_start) and all_full,
        }

    def train_epoch(self, state: TrainState, batches: Iterable, epoch: int, guard=None,
                    flags: Optional[Dict[str, bool]] = None):
        """Steps over host batches, (images, labels[, ids][, seeds]) as
        `split_batch` reads them (a `DataLoader`'s batches as they come),
        placed by `put_batch` through `device_prefetch` with
        `DataConfig.prefetch_depth` batches in flight. Returns (state, the
        last step's metrics), except `em_active` and `full_mem_ratio`,
        which are epoch maxima, and `em_compact_fallback`, the epoch sum.
        Each step's loader wait and interval land in `self.step_log`.

        `flags`: the epoch's gates (`epoch_flags`); None computes them from
        `state`, which a mid-epoch resume must not do (the bank may have
        filled since the epoch began). `guard` (resilience/guard.py
        `EpochGuard`) wraps the placed batches (the chaos drill) and sees
        each step's metrics: it may stop the epoch after the step in flight
        (a preemption), or raise `DivergenceError`. On a stop, the batches
        already prefetched are dropped once their copies are done."""
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
                now = time.perf_counter()
                # the step read the device, so the copy is done: no wait here
                self.step_log.append(StepRecord(wait_s, now - t_prev, batch.image_bytes,
                                                batch.h2d_bytes, batch.copy_ms()))
                t_prev = now
                em_max = max(em_max, last.em_active)
                fb_sum += last.em_compact_fallback
                fm = last.full_mem_ratio
                fm_max = fm if fm_max is None else torch.maximum(fm_max, fm)
                if guard is not None and guard.after_step(last):
                    break  # preemption: after the finished step
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


def _host_tensor(a) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) as a CPU tensor, no copy where
    none is needed."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))
