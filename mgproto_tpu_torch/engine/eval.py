"""The eval forward (counterpart of `Trainer._eval`, mgproto_tpu/engine/train.py).

trunk in eval mode -> head_forward(labels=None) -> level-0 logits and
log p(x). On CUDA, with the config's `fused_*` flags left at None, the block
tails run the BN epilogue kernel and the head runs the score_pool kernel.
`Evaluator` serves a model it owns; `eval_mode` lends a train state's model
to a test or push pass and puts train mode back after it.

`explain_forward` is the served-explanation forward: the same logits and
log p(x), and each request's top-E prototypes by their peak patch
log-density. The peak is level 0 of the head's top-T pool (the score_pool
kernel's values on CUDA, sorted descending), so no dense [B, C, K, H, W]
density is built; pruned prototypes (prior 0) are masked to -inf, and the
top E goes through `ops/pooling.top_t` (`lax.top_k`'s tie order).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from mgproto_tpu_torch.config import Config
from mgproto_tpu_torch.core.mgproto import (
    GMMState,
    MGProtoFeatures,
    head_forward,
    log_px,
)
from mgproto_tpu_torch.numerics import apply_numerics_policy, resolve_device, use_kernel
from mgproto_tpu_torch.ops.pooling import top_t


class EvalOutput(NamedTuple):
    logits: torch.Tensor  # [B, C] level-0 class log-likelihoods
    log_px: torch.Tensor  # [B] log p(x) OoD score
    correct: torch.Tensor  # [B] bool (vs labels if given, else False)


def to_device_images(images, device: torch.device) -> torch.Tensor:
    """A host batch (numpy or tensor) of images as contiguous f32 on `device`."""
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    return images.to(device=device, dtype=torch.float32).contiguous()


def eval_forward(model: MGProtoFeatures, gmm: GMMState, images: torch.Tensor,
                 labels: Optional[torch.Tensor], mine_T: int, fused: bool,
                 mesh=None) -> EvalOutput:
    """One eval batch through `model` as it is (the caller sets eval mode
    and inference mode). `mesh`: the class-sharded head
    (core/mgproto.py `head_forward`), `gmm` this rank's slab."""
    proto_map, _ = model(images)
    logits, _, _ = head_forward(proto_map, gmm, None, mine_T, fused=fused, mesh=mesh)
    lvl0 = logits[..., 0]
    if labels is not None:
        correct = lvl0.argmax(-1) == labels.to(lvl0.device)
    else:
        correct = torch.zeros(lvl0.shape[0], dtype=torch.bool, device=lvl0.device)
    return EvalOutput(logits=lvl0, log_px=log_px(lvl0), correct=correct)


class ExplainOutput(NamedTuple):
    logits: torch.Tensor  # [B, C] level-0 class log-likelihoods
    log_px: torch.Tensor  # [B] log p(x) OoD score
    proto_idx: torch.Tensor  # [B, E] flat C*K prototype indices, most activated first
    proto_logd: torch.Tensor  # [B, E] their peak patch log-densities


def explain_forward(model: MGProtoFeatures, gmm: GMMState, images: torch.Tensor, mine_T: int,
                    fused: bool, top_e: int) -> ExplainOutput:
    """The eval forward with each image's top-`top_e` live prototypes (see
    the module docstring); the caller sets eval mode and inference mode."""
    proto_map, _ = model(images)
    logits, pooled, _ = head_forward(proto_map, gmm, None, mine_T, fused=fused)
    lvl0 = logits[..., 0]
    b = lvl0.shape[0]
    c, k = gmm.priors.shape
    peak = pooled.log_act[..., 0].reshape(b, c * k)
    live = (gmm.priors > 0).reshape(1, c * k)
    masked = torch.where(live, peak, torch.full_like(peak, float("-inf")))
    logd, idx = top_t(masked, min(int(top_e), c * k))
    return ExplainOutput(logits=lvl0, log_px=log_px(lvl0), proto_idx=idx, proto_logd=logd)


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """BatchNorm on its running statistics and no autograd for the block;
    the model's train/eval mode is put back on exit, also on an exception."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield model
    finally:
        model.train(was_training)


class Evaluator:
    """`Evaluator(model, gmm, cfg, device)(images [B, H, W, 3])` -> EvalOutput.

    `device` defaults to CUDA (and raises without it); the model and the GMM
    are moved there. Runs under `torch.inference_mode()`."""

    def __init__(self, model: MGProtoFeatures, gmm: GMMState, cfg: Config,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        apply_numerics_policy()
        self.cfg = cfg
        self.model = model.to(device=self.device, memory_format=torch.channels_last).eval()
        self.gmm = gmm.to(self.device)
        self.fused = use_kernel(cfg.model.fused_scoring, self.device)

    def __call__(self, images, labels: Optional[torch.Tensor] = None) -> EvalOutput:
        with torch.inference_mode():
            return eval_forward(self.model, self.gmm, to_device_images(images, self.device),
                                labels, self.cfg.model.mine_T, self.fused)

    def explain(self, images, top_e: int) -> ExplainOutput:
        with torch.inference_mode():
            return explain_forward(self.model, self.gmm, to_device_images(images, self.device),
                                   self.cfg.model.mine_T, self.fused, top_e)
