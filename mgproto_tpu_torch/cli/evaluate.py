"""Evaluate a checkpoint: test accuracy and the OoD metrics (counterpart of
mgproto_tpu/cli/evaluate.py).

    python -m mgproto_tpu_torch.cli.evaluate --test_dir ... [--ood_dir ...] \
        [--checkpoint auto|<path>] [--ood_score sum|max|paper] [--device cuda]

Restores the checkpoint (the newest in --model_dir by default) after
adopting its training settings, runs the test pass (with the OoD sets when
--ood_dir is given) and prints the JAX CLI's JSON line: the checkpoint,
the accuracy and the pass's results.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from mgproto_tpu_torch.cli.common import add_train_args, config_from_args
from mgproto_tpu_torch.cli.train import _test
from mgproto_tpu_torch.data import build_pipelines
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.utils.checkpoint import (
    adopt_checkpoint_train_config,
    latest_checkpoint,
    restore_checkpoint,
)


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

    path = latest_checkpoint(cfg.model_dir) if args.checkpoint == "auto" else args.checkpoint
    if not path:
        raise FileNotFoundError(f"no checkpoint found in {cfg.model_dir}")
    cfg = adopt_checkpoint_train_config(cfg, path, log=print)
    _, _, test_loader, ood_loaders = build_pipelines(cfg, device=args.device)
    try:
        trainer = Trainer(cfg, steps_per_epoch=1, device=args.device)
        state = restore_checkpoint(path, trainer.init_state(cfg.seed, for_restore=True))
        print(f"loaded {path}")
        accu, results = _test(trainer, state, test_loader, ood_loaders, print,
                              score_rule=args.ood_score)
    finally:
        for loader in (test_loader, *ood_loaders):
            loader.close()
    print(json.dumps({"checkpoint": path, "accuracy": accu, **results}))


if __name__ == "__main__":
    main()
