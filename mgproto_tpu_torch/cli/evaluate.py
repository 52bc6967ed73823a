"""Evaluate a checkpoint: test accuracy and the OoD metrics (counterpart of
mgproto_tpu/cli/evaluate.py).

    python -m mgproto_tpu_torch.cli.evaluate --test_dir ... [--ood_dir ...] \
        [--checkpoint auto|<path>] [--ood_score sum|max|paper] [--device cuda]
    torchrun --nproc_per_node 2 -m mgproto_tpu_torch.cli.evaluate --distributed ...

Restores the checkpoint (the newest in --model_dir by default; replicated,
or sharded by any number of ranks and committed) after
adopting its training settings, runs the test pass (with the OoD sets when
--ood_dir is given) and prints the JAX CLI's JSON line: the checkpoint,
the accuracy and the pass's results. With --distributed each rank
restores the checkpoint onto the mesh (parallel/trainer.py), evaluates its
loader shard, and rank 0 prints the line of the gathered pass.

Telemetry (on unless --no-telemetry): a session in
`model_dir/telemetry_eval` (--telemetry_dir), so a training run's
directory beside it is never overwritten, holding an `evaluate` span, the
eval step's cold paths and a ModelHealth record of the restored state.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Optional

from mgproto_tpu_torch.cli.common import add_train_args, config_from_args, maybe_init_distributed
from mgproto_tpu_torch.cli.train import _health_view, _test
from mgproto_tpu_torch.data import build_pipelines
from mgproto_tpu_torch.parallel.mesh import leave_process_group
from mgproto_tpu_torch.parallel.multihost import is_primary_host
from mgproto_tpu_torch.parallel.trainer import ShardedTrainer
from mgproto_tpu_torch.telemetry import make_session
from mgproto_tpu_torch.utils.checkpoint import adopt_checkpoint_train_config, latest_checkpoint


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description="Evaluate an MGProto checkpoint (test acc + OoD)")
    add_train_args(p)
    p.add_argument("--checkpoint", default="auto",
                   help="checkpoint path ('auto' = the latest in --model_dir)")
    p.add_argument("--ood_score", "--score_rule", dest="ood_score", default="sum",
                   choices=["sum", "max", "paper"],
                   help="the OoD operating-point rule (engine/evaluate.py "
                        "`evaluate_with_ood`); AUROC is reported for every rule")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    maybe_init_distributed(args)
    try:
        path = latest_checkpoint(cfg.model_dir) if args.checkpoint == "auto" else args.checkpoint
        if not path:
            raise FileNotFoundError(f"no checkpoint found in {cfg.model_dir}")
        log = print if is_primary_host() else (lambda *a, **k: None)
        cfg = adopt_checkpoint_train_config(cfg, path, log=log)
        _, _, test_loader, ood_loaders = build_pipelines(cfg, device=args.device)
        telem = None
        try:
            trainer = ShardedTrainer(cfg, steps_per_epoch=1, device=args.device)
            state = trainer.restore(path)
            log(f"loaded {path}")
            telem = make_session(
                args.telemetry_dir or os.path.join(cfg.model_dir, "telemetry_eval"),
                not args.no_telemetry)
            if telem:
                telem.monitor.watch(trainer.cold_paths.total)
            with telem.span("evaluate", checkpoint=path) if telem else contextlib.nullcontext():
                accu, results = _test(trainer, state, test_loader, ood_loaders, log,
                                      score_rule=args.ood_score)
            if telem:
                telem.monitor.check_recompiles()
                telem.health.record(_health_view(trainer, state))
                telem.flush()
        finally:
            if telem:
                telem.close()
            for loader in (test_loader, *ood_loaders):
                loader.close()
        log(json.dumps({"checkpoint": path, "accuracy": accu, **results}))
    finally:
        leave_process_group()


if __name__ == "__main__":
    main()
