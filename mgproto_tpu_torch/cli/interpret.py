"""The interpretability entry point (counterpart of mgproto_tpu/cli/interpret.py).

    python -m mgproto_tpu_torch.cli.interpret --cub_root CUB_200_2011 \
        [--metric all] [--checkpoint auto|<path>] [--export_csv p.csv] [--device cuda]
    torchrun --nproc_per_node 2 -m mgproto_tpu_torch.cli.interpret --distributed \
        [--mesh_model 2] --cub_root CUB_200_2011 ...

Reference: eval_consistency.py, eval_stability.py, eval_purity.py. Restores
a checkpoint (replicated, or sharded by any number of ranks) through the
ShardedTrainer, runs the CUB test split once through the gt-class
activation collector (one clean pass shared by every metric; the
stability metric adds one noisy pass), computes the selected metrics and,
on request, writes the per-prototype patch CSV. With --distributed every
rank reads every global batch and scores its own rows (against its class
slab when the model axis splits the classes, trust/interp_sharded.py),
the maps are gathered onto every rank, and rank 0 prints the line and
writes the CSV: the metrics of one process, on any mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Dict, Optional, Union

import torch

from mgproto_tpu_torch.cli.common import add_train_args, config_from_args, maybe_init_distributed
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
from mgproto_tpu_torch.numerics import resolve_device
from mgproto_tpu_torch.parallel.mesh import leave_process_group
from mgproto_tpu_torch.parallel.multihost import is_primary_host
from mgproto_tpu_torch.parallel.trainer import ShardedTrainer
from mgproto_tpu_torch.trust.interp_sharded import sharded_act_fn
from mgproto_tpu_torch.utils.checkpoint import adopt_checkpoint_train_config, latest_checkpoint

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
    caller names another. In a process group every rank calls it: the
    checkpoint is restored onto the mesh of `cfg.mesh` and the passes run
    sharded (trust/interp_sharded.py `sharded_act_fn`), every rank
    computing the same metrics; rank 0 alone writes the CSV.

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
    trainer = ShardedTrainer(cfg, steps_per_epoch=1, device=dev)
    state = trainer.restore(path)
    act_fn = sharded_act_fn(trainer, state)  # gt_act in one process

    c = cfg.model.num_classes
    seconds: Dict[str, float] = {}
    results: dict = {"checkpoint": path}
    loader = build_eval_loader(cfg, cub_root)
    try:
        with _timed(seconds, "clean_pass", dev):
            clean = collect_gt_activations(trainer, state, iter(loader), act_fn=act_fn)
        results["images"] = len(clean[1])
        if metric in ("consistency", "all"):
            with _timed(seconds, "consistency", dev):
                results["consistency"] = evaluate_consistency(
                    trainer, state, None, parts, c, half_size=half_size, activations=clean)
        if metric in ("stability", "all"):
            with _timed(seconds, "noisy_pass", dev):
                noisy = collect_gt_activations(trainer, state, iter(loader), use_noise=True,
                                               act_fn=act_fn)
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
        if export_csv and is_primary_host():  # every rank holds every map
            with _timed(seconds, "csv", dev):
                results["csv_rows"] = export_prototype_patches_csv(
                    export_csv, trainer, state, None, c, half_size=purity_half_size,
                    top_k=purity_top_k, activations=clean)
            results["csv"] = export_csv
    finally:
        loader.close()
    results["seconds"] = seconds
    return results


def main(argv: Optional[list] = None) -> None:
    """Parse the JAX CLI's flags, join the process group for --distributed,
    run `run_interpret`, print its metrics as the JAX CLI prints them (one
    JSON line: consistency, stability, purity, purity_std, and csv_rows and
    csv with --export_csv; rank 0 alone under --distributed)."""
    p = argparse.ArgumentParser(
        description="Prototype interpretability metrics (the reference's eval_*.py)")
    add_train_args(p)
    p.add_argument("--metric", default="all", choices=list(METRICS))
    p.add_argument("--cub_root", required=True,
                   help="CUB_200_2011 root (images.txt, parts/, images/)")
    p.add_argument("--checkpoint", default="auto")
    p.add_argument("--half_size", type=int, default=36,
                   help="box half-size for consistency/stability (purity uses 16)")
    p.add_argument("--purity_half_size", type=int, default=16)
    p.add_argument("--purity_top_k", type=int, default=10)
    p.add_argument("--export_csv", default="",
                   help="also write the per-prototype top-K patch CSV")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    maybe_init_distributed(args)
    try:
        results = run_interpret(
            cfg, args.cub_root, checkpoint=args.checkpoint, metric=args.metric,
            half_size=args.half_size, purity_half_size=args.purity_half_size,
            purity_top_k=args.purity_top_k, export_csv=args.export_csv, device=args.device)
        if is_primary_host():
            print(f"loaded {results['checkpoint']}")
            keys = ("consistency", "stability", "purity", "purity_std", "csv_rows", "csv")
            print(json.dumps({k: results[k] for k in keys if k in results}))
    finally:
        leave_process_group()


if __name__ == "__main__":
    main()
