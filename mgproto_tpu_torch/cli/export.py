"""Export a checkpoint as a serving artifact (counterpart of
mgproto_tpu/cli/export.py; the artifact format is engine/export.py's).

    python -m mgproto_tpu_torch.cli.export --model_dir runs/r1 --out model.mgproto \
        [--checkpoint auto|<path>] [--calibrate --test_dir ...] [--explain] \
        [--static_batch N] [--device cuda]

Restores the checkpoint (the newest in --model_dir by default; replicated,
or sharded by any number of ranks and committed) after
adopting its training settings, as the JAX main does; `--calibrate` embeds
the calibration from the --test_dir loader (serving/calibration.py
`calibrate_from_config`); `--explain` embeds the explanation table, with
the run's push provenance (`push_provenance.json` in --model_dir) when it
has one. Prints one JSON line: the artifact, its bytes and its provenance.
`--aot-cache`, `--aot_buckets` and `--quantize int8` are refused
(cli/common.py `EXPORT_REFUSED`), and `config_from_args` refuses the
training flags of `REFUSED` (`--ckpt_format sharded` among them), both
before anything loads.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from mgproto_tpu_torch.cli.common import (
    EXPORT_REFUSED,
    SINGLE_PROCESS_REFUSED,
    add_train_args,
    check_ported,
    config_from_args,
)
from mgproto_tpu_torch.engine.export import artifact_meta, explain_table, save_artifact
from mgproto_tpu_torch.engine.push import load_push_provenance
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.serving.calibration import calibrate_from_config, gmm_fingerprint
from mgproto_tpu_torch.utils.checkpoint import (
    adopt_checkpoint_train_config,
    latest_checkpoint,
    restore_checkpoint,
)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description="Export an MGProto checkpoint as a serving artifact")
    add_train_args(p)
    p.add_argument("--checkpoint", default="auto",
                   help="checkpoint path ('auto' = the latest in --model_dir)")
    p.add_argument("--out", required=True, help="artifact path to write (convention: *.mgproto)")
    p.add_argument("--static_batch", type=int, default=0,
                   help="serve only this batch size (0 = any batch)")
    p.add_argument("--calibrate", action="store_true",
                   help="derive the serving calibration from the --test_dir loader and embed "
                        "it as calibration.json (cli.serve refuses an uncalibrated artifact "
                        "unless --allow-uncalibrated)")
    p.add_argument("--calib_percentile", type=float, default=5.0,
                   help="ID percentile of the default abstention operating point")
    p.add_argument("--explain", action="store_true",
                   help="embed the explanation table (explain.json: priors, the top "
                        "prototypes' depth and the run's push provenance when present); "
                        "cli.serve --explain then serves explanations")
    p.add_argument("--explain_top", type=int, default=5,
                   help="prototypes per explanation (most activated first)")
    p.add_argument("--aot-cache", "--aot_cache", dest="aot_cache", action="store_true",
                   help="not ported (A7): refused")
    p.add_argument("--aot_buckets", default="1,2,4,8", help="not ported (A7): the default only")
    p.add_argument("--quantize", choices=("none", "int8"), default="none",
                   help="'int8' is not ported (A9): refused")
    args = p.parse_args(argv)
    check_ported(args, EXPORT_REFUSED)
    check_ported(args, SINGLE_PROCESS_REFUSED)
    cfg = config_from_args(args)

    path = latest_checkpoint(cfg.model_dir) if args.checkpoint == "auto" else args.checkpoint
    if not path:
        raise FileNotFoundError(f"no checkpoint found in {cfg.model_dir}")
    cfg = adopt_checkpoint_train_config(cfg, path, log=print)
    trainer = Trainer(cfg, steps_per_epoch=1, device=args.device)
    state = restore_checkpoint(path, trainer.init_state(cfg.seed, for_restore=True))

    static = args.static_batch if args.static_batch > 0 else None
    meta = artifact_meta(cfg, path, gmm_fingerprint(state.gmm), static_batch=static)
    calib = None
    if args.calibrate:
        calib = calibrate_from_config(cfg, trainer, state, percentile=args.calib_percentile,
                                      device=args.device)
    explain = None
    if args.explain:
        provenance = load_push_provenance(cfg.model_dir)
        if provenance is not None:
            print(f"explain provenance: {cfg.model_dir}/push_provenance.json")
        else:
            print(f"explain provenance: none (no push_provenance.json in {cfg.model_dir}; "
                  "explanations carry prototype identity, prior and density but no source "
                  "patches)")
        explain = explain_table(state.gmm, provenance=provenance, top_e=args.explain_top)
    save_artifact(args.out, state.model, state.gmm, meta, calibration=calib, explain=explain)
    line = {
        "artifact": args.out,
        "bytes": os.path.getsize(args.out),
        "calibrated": calib is not None,
        "explain": explain is not None,
        "quantize": args.quantize,
        **{k: meta[k] for k in ("arch", "num_classes", "img_size", "dynamic_batch",
                                "checkpoint", "gmm_fingerprint")},
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
