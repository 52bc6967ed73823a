"""The interpretability entry point (counterpart of mgproto_tpu/cli/interpret.py,
without its argparse `main`).

Reference: eval_consistency.py, eval_stability.py, eval_purity.py. Restores
a checkpoint, runs the CUB test split once through the gt-class activation
collector (one clean pass shared by every metric; the stability metric adds
one noisy pass), computes the selected metrics and, on request, writes the
per-prototype patch CSV.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Union

import torch

from mgproto_tpu_torch.config import Config
from mgproto_tpu_torch.data import Cub2011Eval, DataLoader, ood_transform
from mgproto_tpu_torch.data.cub_parts import CubParts
from mgproto_tpu_torch.engine.interpretability import (
    collect_gt_activations,
    evaluate_consistency,
    evaluate_purity,
    evaluate_stability,
    export_prototype_patches_csv,
)
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.numerics import resolve_device
from mgproto_tpu_torch.utils.checkpoint import (
    adopt_checkpoint_train_config,
    latest_checkpoint,
    restore_checkpoint,
)

METRICS = ("consistency", "stability", "purity", "all")


def build_eval_loader(cfg: Config, cub_root: str) -> DataLoader:
    """Squash-resize eval loader over the CUB test split — the reference
    eval scripts' transform (interpretability.py:29-33 Resize((img,img)),
    NOT the center-crop test pipeline), so part coordinates scaled by
    width/height line up with the activation grid. One process: shard 0 of
    1; the tail batch is padded with label -1 rows, as the JAX loader pads it."""
    dataset = Cub2011Eval(
        cub_root, train=False, transform=ood_transform(cfg.model.img_size)
    )
    return DataLoader(dataset, cfg.data.test_batch_size, num_workers=cfg.data.num_workers,
                      shard_index=0, shard_count=1)


@contextlib.contextmanager
def _timed(seconds: Dict[str, float], name: str, device: torch.device):
    """Wall seconds of the block into `seconds[name]`, the device's queued
    work included."""
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds[name] = time.perf_counter() - t0


def run_interpret(
    cfg: Config,
    cub_root: str,
    checkpoint: str = "auto",
    metric: str = "all",
    half_size: int = 36,
    purity_half_size: int = 16,
    purity_top_k: int = 10,
    export_csv: str = "",
    device: Union[str, torch.device, None] = None,
) -> dict:
    """The body of the JAX CLI's `main`: consistency and stability with
    boxes of `half_size`, purity (mean and std) over each prototype's top
    `purity_top_k` images with boxes of `purity_half_size`, and the patch
    CSV at `export_csv` when it is not empty. `checkpoint`: "auto" takes the
    newest checkpoint in `cfg.model_dir`, else a checkpoint path; the
    checkpoint's training settings (compute dtype, aux loss, EM stepping)
    are adopted into `cfg` first (`adopt_checkpoint_train_config`), and
    the rest of its model must match `cfg`'s. `device`: CUDA unless the
    caller names another.

    Returns the metrics the JAX CLI prints ("consistency", "stability",
    "purity", "purity_std", "csv_rows", "csv") and "checkpoint", "images",
    and "seconds": the clean and noisy passes and each metric's host
    post-pass and the CSV, each with the device's queued work."""
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r} not in {METRICS}")
    dev = resolve_device(device)
    path = latest_checkpoint(cfg.model_dir) if checkpoint == "auto" else checkpoint
    if not path:
        raise FileNotFoundError(f"no checkpoint in {cfg.model_dir}")
    cfg = adopt_checkpoint_train_config(cfg, path)
    parts = CubParts(cub_root)
    trainer = Trainer(cfg, steps_per_epoch=1, device=dev)
    state = restore_checkpoint(path, trainer.init_state(cfg.seed))

    c = cfg.model.num_classes
    seconds: Dict[str, float] = {}
    results: dict = {"checkpoint": path}
    loader = build_eval_loader(cfg, cub_root)
    try:
        with _timed(seconds, "clean_pass", dev):
            clean = collect_gt_activations(trainer, state, iter(loader))
        results["images"] = len(clean[1])
        if metric in ("consistency", "all"):
            with _timed(seconds, "consistency", dev):
                results["consistency"] = evaluate_consistency(
                    trainer, state, None, parts, c, half_size=half_size, activations=clean)
        if metric in ("stability", "all"):
            with _timed(seconds, "noisy_pass", dev):
                noisy = collect_gt_activations(trainer, state, iter(loader), use_noise=True)
            with _timed(seconds, "stability", dev):
                results["stability"] = evaluate_stability(
                    trainer, state, None, parts, c, half_size=half_size,
                    activations=clean, noisy_activations=noisy)
        if metric in ("purity", "all"):
            with _timed(seconds, "purity", dev):
                mean, std = evaluate_purity(
                    trainer, state, None, parts, c, half_size=purity_half_size,
                    top_k=purity_top_k, activations=clean)
            results["purity"], results["purity_std"] = mean, std
        if export_csv:
            with _timed(seconds, "csv", dev):
                results["csv_rows"] = export_prototype_patches_csv(
                    export_csv, trainer, state, None, c, half_size=purity_half_size,
                    top_k=purity_top_k, activations=clean)
            results["csv"] = export_csv
    finally:
        loader.close()
    results["seconds"] = seconds
    return results
