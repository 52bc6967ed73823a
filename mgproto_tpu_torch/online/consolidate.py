"""Consolidation: captured traffic -> memory banks -> compact EM
(counterpart of mgproto_tpu/online/consolidate.py).

On a poll-driven cadence (an injectable clock; nothing sleeps), staged
samples from the trusted capture are drained and pushed, one batch of
`batch_width` rows at a time (the tail padded with valid=False rows, which
`memory_push` drops), through

    images --(the eval-mode trunk: the epilogue kernel on the card)--> feature map
           --(head_forward with the staged labels: the score_pool kernel)--> enqueue candidates
           --(core/memory.memory_push)--> per-class banks
           --(core/em.em_update at resolve_em_config(cfg.em, C, width):
              compact dirty-class EM, the em_estep kernel)--> candidate GMM

This is the training step's enqueue (each sample's top-1 patch per
prototype of its class, deduplicated) and its compact EM: a batch of W
samples dirties at most W classes, so the compact slab covers every dirty
bank.

THE CANDIDATE IS A COPY. The port updates training state in place, and the
serving replicas share one loaded model. So the consolidator owns its own
GMM (the means a fresh leaf), bank and mean optimizer (a fresh
`torch.optim.Adam` over the cloned means, holding copies of the serving
state's Adam moments). EM writes only these; a served request scores the
serving mixture, bit for bit, until a republish swaps the candidate in
(online/republish.py). The trunk is shared and only read: consolidation
runs it in eval mode under inference mode, as serving does.

`steady_recompiles()`: the JAX package compiles the consolidation program
once and counts recompiles after that. The port compiles no program; its
counter is what the serving engine's counts are: batches at an input shape
other than the first batch's, plus kernel library builds after the first
batch (ops/_build.py `builds`). Both must stay 0.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from mgproto_tpu_torch.core.em import em_update, resolve_em_config
from mgproto_tpu_torch.core.memory import Memory, memory_push
from mgproto_tpu_torch.core.mgproto import GMMState, head_forward
from mgproto_tpu_torch.engine.eval import eval_mode, to_device_images
from mgproto_tpu_torch.online import metrics as om
from mgproto_tpu_torch.online.capture import CapturedSample, TrustedCapture
from mgproto_tpu_torch.ops import _build
from mgproto_tpu_torch.telemetry.monitor import StepMonitor
from mgproto_tpu_torch.telemetry.session import current_session

RESULT_RAN = "ran"
RESULT_EMPTY = "empty"


@dataclasses.dataclass(frozen=True)
class ConsolidatorConfig:
    cadence_s: float = 1.0  # how often `tick` consolidates
    batch_width: int = 16  # the one consolidation batch shape
    min_samples: int = 1  # don't bother below this many staged


@dataclasses.dataclass(frozen=True)
class ConsolidationReport:
    """What one cadence firing did."""

    t: float
    drained: int
    batches: int
    em_active_max: int  # widest EM call of the run (0 = no bank was ready)
    compact_fallbacks: int
    result: str  # ran | empty

    def to_dict(self):
        return dataclasses.asdict(self)


def copy_gmm(gmm: GMMState) -> GMMState:
    """A GMM of fresh tensors; its means a new leaf that requires grad (the
    mean optimizer's parameter)."""
    out = GMMState(*(t.detach().clone() for t in gmm))
    out.means.requires_grad_(True)
    return out


def copy_memory(memory: Memory) -> Memory:
    return Memory(*(t.clone() for t in memory))


def copy_mean_optimizer(opt: torch.optim.Adam, means: torch.Tensor) -> torch.optim.Adam:
    """A fresh Adam over `means` with `opt`'s settings and copies of its
    moments and step count (nothing shared with `opt`)."""
    sd = opt.state_dict()
    state = {k: {n: v.clone() if torch.is_tensor(v) else v for n, v in s.items()}
             for k, s in sd["state"].items()}
    new = torch.optim.Adam([means])
    new.load_state_dict({"state": state, "param_groups": copy.deepcopy(sd["param_groups"])})
    return new


class Consolidator:
    """drain -> push -> compact EM on the candidate (module docstring). One
    consolidating caller per process, the serving pump between polls, as
    in the JAX package."""

    def __init__(self, trainer, state, capture: Optional[TrustedCapture] = None,
                 config: Optional[ConsolidatorConfig] = None, clock=time.monotonic,
                 monitor=None):
        self.config = config or ConsolidatorConfig()
        self.capture = capture
        self.clock = clock
        self.trainer = trainer
        cfg = trainer.cfg
        self._k = cfg.model.prototypes_per_class
        self._img = cfg.model.img_size
        self._c = cfg.model.num_classes
        self._mine_t = cfg.model.mine_T
        self._width = max(int(self.config.batch_width), 1)
        self.device = trainer.device
        self.model = state.model  # shared with serving, only read
        # the candidate: copies of the serving state's mixture, bank and
        # mean-optimizer moments
        self.gmm = copy_gmm(state.gmm)
        self.memory = copy_memory(state.memory)
        self.mean_opt = copy_mean_optimizer(state.mean_opt, self.gmm.means)
        # compact dirty-class EM at the consolidation width
        self._em_cfg = resolve_em_config(cfg.em, self._c, self._width)
        self._next_due = self.clock() + self.config.cadence_s
        self._shape = None  # the first batch's input shape
        self._off_shape = 0  # batches at another shape since
        self._builds0: Optional[int] = None  # kernel builds after the first batch
        # the last batch's enqueue: each row's top-1 patch per prototype of
        # its class [W, K], the margin of that top-1 density over the second
        # [W, K] and the candidates' valid mask [W*K] (references to tensors
        # the batch made; a comparison of two devices reads them)
        self.last_enqueue = None
        # telemetry (an open session's, or `monitor`): the first batch and
        # every steady recompile are cold paths of phase "online"
        # (telemetry/monitor.py)
        if monitor is None and current_session() is not None:
            monitor = StepMonitor(phase="online")  # into the session's registry
        self.monitor = monitor
        if monitor is not None:
            monitor.watch(lambda: (self._shape is not None) + self.steady_recompiles())
        self.runs = 0
        self.batches = 0
        self.samples_consolidated = 0
        self.reports: List[ConsolidationReport] = []

    # ---------------------------------------------------------------- cadence
    def tick(self, now: Optional[float] = None) -> Optional[ConsolidationReport]:
        """One poll: consolidate iff the cadence elapsed and enough samples
        are staged. Returns the report when the cadence fired, else None."""
        now = self.clock() if now is None else now
        if now < self._next_due or self.capture is None:
            return None
        self._next_due = now + self.config.cadence_s
        if self.capture.staged_count() < self.config.min_samples:
            om.counter(om.CONSOLIDATIONS).inc(result=RESULT_EMPTY)
            report = ConsolidationReport(t=now, drained=0, batches=0, em_active_max=0,
                                         compact_fallbacks=0, result=RESULT_EMPTY)
            self.reports.append(report)
            return report
        return self.ingest(self.capture.drain(), now=now)

    # ----------------------------------------------------------------- ingest
    def ingest(self, samples: Sequence[CapturedSample],
               now: Optional[float] = None) -> ConsolidationReport:
        """Consolidate `samples` now, in batches of the one width; the tail
        pads with valid=False rows."""
        now = self.clock() if now is None else now
        w = self._width
        em_active_max = fallbacks = batches = 0
        for i in range(0, len(samples), w):
            chunk = samples[i:i + w]
            images = np.zeros((w, self._img, self._img, 3), np.float32)
            classes = np.full((w,), -1, np.int64)
            valid = np.zeros((w,), bool)
            for j, s in enumerate(chunk):
                images[j] = np.asarray(s.payload, np.float32)
                classes[j] = s.class_id
                valid[j] = True
            n_active, fallback = self._consolidate(images, classes, valid)
            em_active_max = max(em_active_max, n_active)
            fallbacks += fallback
            batches += 1
        self.runs += 1
        self.batches += batches
        self.samples_consolidated += len(samples)
        om.counter(om.CONSOLIDATIONS).inc(result=RESULT_RAN)
        om.counter(om.CONSOLIDATED_SAMPLES).inc(float(len(samples)))
        report = ConsolidationReport(t=now, drained=len(samples), batches=batches,
                                     em_active_max=em_active_max, compact_fallbacks=fallbacks,
                                     result=RESULT_RAN)
        self.reports.append(report)
        return report

    def _consolidate(self, images: np.ndarray, classes: np.ndarray, valid: np.ndarray):
        """One batch: trunk, enqueue, push, EM on the candidate. Returns
        (classes EM touched, compact fallback 0/1)."""
        x = to_device_images(images, self.device)
        if self._shape is None:
            self._shape = tuple(x.shape)
        elif tuple(x.shape) != self._shape:
            self._off_shape += 1
        # padding rows carry class -1: clipped for the label-indexed gather,
        # and dropped at the push by their valid=False
        labels = torch.from_numpy(np.clip(classes, 0, self._c - 1)).to(self.device)
        rows = torch.from_numpy(valid).to(self.device)
        with eval_mode(self.model) as model:
            proto_map, _ = model(x)
            _, pooled, enq = head_forward(proto_map, self.gmm, labels, self._mine_t,
                                          fused=self.trainer.fused)
            rows_i = torch.arange(len(labels), device=self.device)
            top1 = pooled.top1_idx[rows_i, labels]
            act = pooled.log_act[rows_i, labels]  # [W, K, T], descending
            margin = (act[..., 0] - act[..., 1] if act.shape[-1] > 1
                      else torch.full_like(act[..., 0], float("inf")))
        # out of inference mode: EM's m-step differentiates
        feats, enq_classes, enq_valid = (t.clone() for t in enq)
        enq_valid = enq_valid & rows.repeat_interleave(self._k)
        self.last_enqueue = (top1, margin, enq_valid)
        self.memory = memory_push(self.memory, feats, enq_classes, enq_valid)
        self.gmm, self.memory, aux = em_update(self.gmm, self.memory, self.mean_opt,
                                               self._em_cfg)
        if self._builds0 is None:
            self._builds0 = _build.builds
        if self.monitor is not None:
            self.monitor.check_recompiles()
        return int(aux.num_active), int(aux.compact_fallback)

    # ------------------------------------------------------------- candidate
    def claim_class(self, slot: int) -> None:
        """Class addition (online/classes.py): the padded slot's priors
        raised to 1/K in the candidate mixture."""
        from mgproto_tpu_torch.online.classes import claim_slot

        self.gmm = claim_slot(self.gmm, slot)

    def candidate_state(self, serving_state):
        """`serving_state` with a snapshot of the candidate's GMM, bank and
        mean optimizer (copies: later consolidation does not move it); the
        trunk and the other optimizers are `serving_state`'s."""
        gmm = copy_gmm(self.gmm)
        return dataclasses.replace(serving_state, gmm=gmm, memory=copy_memory(self.memory),
                                   mean_opt=copy_mean_optimizer(self.mean_opt, gmm.means))

    def bank_arrays(self):
        """(feats, length) of the candidate bank as host numpy: the drift
        monitor's `observe_bank` input."""
        return self.memory.feats.cpu().numpy(), self.memory.length.cpu().numpy()

    def steady_recompiles(self) -> int:
        """Batches at an input shape other than the first batch's, plus
        kernel library builds after the first batch (module docstring)."""
        builds = 0 if self._builds0 is None else _build.builds - self._builds0
        return self._off_shape + builds
