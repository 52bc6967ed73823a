"""Export a checkpoint as a serving artifact (counterpart of
mgproto_tpu/cli/export.py; the artifact format is engine/export.py's).

    python -m mgproto_tpu_torch.cli.export --model_dir runs/r1 --out model.mgproto \
        [--checkpoint auto|<path>] [--calibrate --test_dir ...] [--explain] \
        [--static_batch N] [--quantize MODE] [--device cuda]

Restores the checkpoint (the newest in --model_dir by default; replicated,
or sharded by any number of ranks and committed) after
adopting its training settings, as the JAX main does; `--calibrate` embeds
the calibration from the --test_dir loader (serving/calibration.py
`calibrate_from_config`); `--explain` embeds the explanation table, with
the run's push provenance (`push_provenance.json` in --model_dir) when it
has one. Prints one JSON line: the artifact, its bytes and its provenance.

`--quantize` (perf/quant.py `SUPPORTED_QUANT_MODES`) quantizes the restored
model's conv and dense weights, as JAX's main does: the calibration is
measured through the quantized model on the device, so its thresholds are
those of the rounded weights the artifact serves, and it is stamped with the
policy's tag; meta.json gets the `quant_config` block. The GMM, BatchNorm,
biases, proxies, log p(x) and the calibration math stay f32.
`--aot-cache` and `--aot_buckets` are refused (cli/common.py
`EXPORT_REFUSED`), and `config_from_args` refuses the training flags of
`REFUSED` (`--ckpt_format sharded` among them), both before anything loads.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from mgproto_tpu_torch.perf.quant import (
    SUPPORTED_QUANT_MODES,
    quantize_model,
    resolve_quant_policy,
)
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
    p.add_argument("--quantize", choices=SUPPORTED_QUANT_MODES, default="none",
                   help="weight-only quantization of the conv and dense weights "
                        "(perf/quant.py): per-output-channel symmetric scales, dequantized "
                        "at each call; stamps quant_config into meta.json and the "
                        "calibration. 'none' (default) writes the f32 artifact byte for "
                        "byte as before. The GMM, priors, log p(x) and calibration math "
                        "are never quantized")
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

    qmodel = None
    policy = resolve_quant_policy(args.quantize)
    if policy.quantized:
        qmodel = quantize_model(state.model, policy, proxies=state.proxies)
        # the calibration and the artifact both see the rounded weights
        state = dataclasses.replace(state, model=qmodel.model)
    static = args.static_batch if args.static_batch > 0 else None
    meta = artifact_meta(cfg, path, gmm_fingerprint(state.gmm), static_batch=static,
                         quant=qmodel.quant_config() if qmodel is not None else None)
    calib = None
    if args.calibrate:
        calib = calibrate_from_config(cfg, trainer, state, percentile=args.calib_percentile,
                                      device=args.device, quant_config=policy.tag)
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
    save_artifact(args.out, state.model, state.gmm, meta, calibration=calib, explain=explain,
                  proxies=qmodel.proxies if qmodel is not None else None)
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
