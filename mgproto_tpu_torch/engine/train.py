"""The synchronous train step and the epoch driver (counterpart of the JAX
package's `Trainer._step` and `Trainer.train_epoch`, mgproto_tpu/engine/train.py).

One step: the forward in train mode (BatchNorm batch statistics), the CE +
mine + proxy-anchor losses, the backward, the divergence guard, the
optimizer step, then the bank phase (memory enqueue and gated EM,
core/em.py `bank_update`). On CUDA, with the config's `fused_*` flags left
at None, the path launches the score_pool forward and backward kernels, the
BN epilogue kernel (16 times at ResNet-34) and the em_estep kernel
(`num_em_loop` times per EM call).

The JAX gates are traced scalars; here they are host-side Python. The step
reads the device once: the divergence-guard flag together with the EM
gate's counts (`bank_update`). A non-finite loss or gradient leaves the
parameters, the optimizer state, the BatchNorm running statistics (restored
from a snapshot taken before the forward), the bank and the GMM unchanged;
`step` counts attempts either way. The state is updated in place.
"""

from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Union

import numpy as np
import torch

from mgproto_tpu_torch.config import Config
from mgproto_tpu_torch.core import losses as L
from mgproto_tpu_torch.core.em import BankAux, bank_update, resolve_em_config
from mgproto_tpu_torch.core.mgproto import head_forward
from mgproto_tpu_torch.core.state import TrainState, create_train_state, set_joint_lrs
from mgproto_tpu_torch.models.common import BatchNorm
from mgproto_tpu_torch.numerics import apply_numerics_policy, resolve_device, use_kernel


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


class Trainer:
    """`Trainer(cfg, steps_per_epoch, device)` owns the step; all state is in
    the `TrainState` it is handed. `device=None` means CUDA, or raise."""

    def __init__(self, cfg: Config, steps_per_epoch: int,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        apply_numerics_policy()
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.fused = use_kernel(cfg.model.fused_scoring, self.device)
        self.em_cfg = resolve_em_config(cfg.em, cfg.model.num_classes, cfg.data.train_batch_size)
        self.last_bank: BankAux = BankAux(0, 0, None)  # the last step's bank phase

    def init_state(self, seed: int = 0) -> TrainState:
        return create_train_state(self.cfg, torch.Generator().manual_seed(int(seed)), self.device)

    def _put(self, images, labels):
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        if isinstance(labels, np.ndarray):
            labels = torch.from_numpy(np.asarray(labels, np.int64))
        return (images.to(device=self.device, dtype=torch.float32).contiguous(),
                labels.to(device=self.device, dtype=torch.long))

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
        aux = L.proxy_anchor(embed, labels, state.proxies)
        c = self.cfg.loss
        loss = c.crs_ent * ce + c.mine * mine + c.aux * aux
        acc = (logits[..., 0].argmax(-1) == labels).float().mean()
        return loss, (enq, ce, mine, aux, acc)

    @staticmethod
    def params(state: TrainState):
        """Every differentiated leaf: the model's parameters (the frozen
        embedding included, as the JAX guard sums its gradient too) and the
        proxies."""
        return list(state.model.parameters()) + [state.proxies]

    def train_step(self, state: TrainState, images, labels, use_mine: bool,
                   update_gmm: bool, warm: bool = False):
        """One synchronous step; returns (state, TrainMetrics)."""
        images, labels = self._put(images, labels)
        model = state.model.train()
        params = self.params(state)
        for p in params:
            p.grad = None
        stats = [t for m in model.modules() if isinstance(m, BatchNorm)
                 for t in (m.running_mean, m.running_var)]
        snapshot = torch.cat([t.reshape(-1) for t in stats])

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
        else:
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

    def train_epoch(self, state: TrainState, batches: Iterable, epoch: int):
        """Steps over host (images, labels) batches. Returns (state, the last
        step's metrics), except `em_active` and `full_mem_ratio`, which are
        epoch maxima, and `em_compact_fallback`, the epoch sum."""
        flags = self.epoch_flags(state, epoch)
        last = None
        em_max = fb_sum = 0
        fm_max = None
        for images, labels in batches:
            state, last = self.train_step(state, images, labels, **flags)
            em_max = max(em_max, last.em_active)
            fb_sum += last.em_compact_fallback
            fm = last.full_mem_ratio
            fm_max = fm if fm_max is None else torch.maximum(fm_max, fm)
        if last is not None:
            last = last._replace(em_active=em_max, full_mem_ratio=fm_max,
                                 em_compact_fallback=fb_sum)
        return state, last
