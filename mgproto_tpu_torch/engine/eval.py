"""The eval forward (counterpart of `Trainer._eval`, mgproto_tpu/engine/train.py).

trunk in eval mode -> head_forward(labels=None) -> level-0 logits and
log p(x). On CUDA, with the config's `fused_*` flags left at None, the block
tails run the BN epilogue kernel and the head runs the score_pool kernel.
"""

from __future__ import annotations

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


class EvalOutput(NamedTuple):
    logits: torch.Tensor  # [B, C] level-0 class log-likelihoods
    log_px: torch.Tensor  # [B] log p(x) OoD score
    correct: torch.Tensor  # [B] bool (vs labels if given, else False)


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
            if isinstance(images, np.ndarray):
                images = torch.from_numpy(np.ascontiguousarray(images, np.float32))
            x = images.to(device=self.device, dtype=torch.float32).contiguous()
            proto_map, _ = self.model(x)
            logits, _, _ = head_forward(
                proto_map, self.gmm, None, self.cfg.model.mine_T, fused=self.fused
            )
            lvl0 = logits[..., 0]
            if labels is not None:
                correct = lvl0.argmax(-1) == labels.to(self.device)
            else:
                correct = torch.zeros(lvl0.shape[0], dtype=torch.bool, device=self.device)
            return EvalOutput(logits=lvl0, log_px=log_px(lvl0), correct=correct)
