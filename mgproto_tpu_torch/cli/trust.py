"""The trust command: the robustness matrix and the trust report
(counterpart of mgproto_tpu/cli/trust.py).

    python -m mgproto_tpu_torch.cli.trust matrix --synthetic --device cpu --out report.json
    python -m mgproto_tpu_torch.cli.trust matrix --artifact m.mgproto --test_dir D \\
        --ood_dir O [--max_samples 64] --out report.json
    python -m mgproto_tpu_torch.cli.trust matrix --checkpoint auto --model_dir run/ \\
        --test_dir D --ood_dir O [model flags] --out report.json
    python -m mgproto_tpu_torch.cli.trust report report.json       # render its verdicts
    python -m mgproto_tpu_torch.cli.trust report --matrix m.json --interp i.json --out r.json

`matrix --synthetic` is the hermetic drill: the tiny model's mixture fitted
through the production consolidation path (online/consolidate.py: the
memory push and compact EM, the E-step kernel on the card; no backprop),
calibrated through `calibrate`, served through a warmed ServingEngine
against three OoD families. Seeded and deterministic; `state=` takes the
initial TrainState (the tests carry JAX's PRNGKey state across). The
matrix exits 0 when every gate of `cli/telemetry.py::trust_gates` passes,
1 otherwise, after printing JAX's one-line summary.

    python -m mgproto_tpu_torch.cli.trust interp --cub_root CUB --model_dir run/ \
        [--checkpoint auto] [model flags] --out interp.json
    torchrun --nproc_per_node 2 -m mgproto_tpu_torch.cli.trust interp --distributed ...

`--device` is the port's flag (default cuda). The training flags that the
port refuses elsewhere are refused here too. `interp` scores consistency,
stability and purity of a checkpoint on a CUB-layout parts tree through
trust/interp_sharded.py on a ShardedTrainer (one process, or the ranks of
--distributed with --mesh_data/--mesh_model), and writes JAX's
`trust_interp` record (rank 0), which `report --interp` merges.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, Optional

import numpy as np


# ------------------------------------------------------------ hermetic drill
def _pattern(cls: int, img: int, drift: float = 0.0, channel: float = 1.0) -> np.ndarray:
    """A deterministic class texture: an oriented wave and a per-class
    channel balance. `drift` rotates the texture off the trained manifold;
    `channel=-2.0` is the off-manifold inversion this toy's p(x) collapses
    on."""
    xx, yy = np.meshgrid(np.arange(img), np.arange(img), indexing="ij")
    ang = (cls * 45.0 + drift * 30.0) * np.pi / 180.0
    wave = np.cos(2.0 * np.pi * (cls + 1) * (xx * np.cos(ang) + yy * np.sin(ang)) / float(img))
    base = np.repeat(wave[..., None].astype(np.float32), 3, axis=2)
    base[..., cls % 3] += channel
    base[..., (cls + 1) % 3] += drift * 0.6
    return base


def _samples(rng, cls: int, img: int, count: int, drift: float = 0.0, channel: float = 1.0,
             noise: float = 0.05) -> np.ndarray:
    base = _pattern(cls, img, drift, channel)
    return np.stack([base + rng.randn(img, img, 3).astype(np.float32) * noise
                     for _ in range(count)])


def run_synthetic_matrix(seed: int = 0, classes: int = 4, per_class: int = 16,
                         bootstrap_epochs: int = 20, bootstrap_per_class: int = 8,
                         percentile: float = 5.0, config_overrides: Optional[Dict] = None,
                         state=None, device=None) -> Dict:
    """The hermetic drill as a report dict (the JAX drill's schema).
    `state`: the initial TrainState of the drill's config; None draws one
    from `seed`. `device`: CUDA unless named."""
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.online.capture import CapturedSample
    from mgproto_tpu_torch.online.consolidate import Consolidator, ConsolidatorConfig
    from mgproto_tpu_torch.serving.calibration import calibrate
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.trust.matrix import MatrixConfig, run_matrix

    cfg = synthetic_config(classes)
    trainer = Trainer(cfg, steps_per_epoch=1, device=device)
    state = trainer.init_state(seed) if state is None else state
    img = cfg.model.img_size
    rng = np.random.RandomState(seed + 11)

    # the hermetic bootstrap: labeled class textures through the production
    # consolidation (memory push and compact EM, no backprop), so the served
    # accuracy below is real
    cons = Consolidator(trainer, state, config=ConsolidatorConfig(cadence_s=1.0, batch_width=8),
                        clock=lambda: 0.0)
    for _ in range(int(bootstrap_epochs)):
        for c in range(classes):
            cons.ingest([CapturedSample(p, c, None, "bootstrap", True)
                         for p in _samples(rng, c, img, bootstrap_per_class)])
    state = cons.candidate_state(state)

    # the calibration through the serving forward, on a held-out ID draw
    calib_images = [_samples(rng, c, img, 8) for c in range(classes) for _ in range(2)]
    ev = Evaluator(state.model, state.gmm, cfg, device=trainer.device)
    calib = calibrate(ev, calib_images, percentile=percentile, source="trust-drill")
    engine = ServingEngine.from_live(ev, calibration=calib, buckets=(1, 2, 4, 8))
    engine.warmup()

    # the evaluation sets: fresh ID draws and three OoD families
    id_parts, id_labels = [], []
    for c in range(classes):
        id_parts.append(_samples(rng, c, img, per_class))
        id_labels.append(np.full((per_class,), c, np.int32))
    id_images = np.concatenate(id_parts)
    id_labels = np.concatenate(id_labels)
    # OoD families along the directions this toy's p(x) collapses on:
    # structural and channel departures (an untrained trunk scores pure
    # noise high, so noise would gate the toy's blindness, not the path)
    checker = np.tile(((np.indices((img, img)).sum(0) % 2).astype(np.float32) * 2.0
                       - 1.0)[..., None], (1, 1, 3))
    ood_sets = {
        "inverted": np.concatenate([_samples(rng, c, img, per_class // 2, channel=-2.0)
                                    for c in range(classes)]),
        "dimmed": np.concatenate([_samples(rng, c, img, per_class // 2, channel=0.0)
                                  for c in range(classes)]),
        "checker": np.stack([checker + rng.randn(img, img, 3).astype(np.float32) * 0.05
                             for _ in range(classes * (per_class // 2))]),
    }

    # the drill's bars: measured properties of this seeded toy (an untrained
    # trunk, chance accuracy 1/classes), not the production defaults; what
    # is gated is the machinery
    overrides = {"auroc_floor": 0.85, "answered_accuracy_floor": 0.30, "monotone_tol": 0.05,
                 **(config_overrides or {})}
    report = run_matrix(engine, id_images, id_labels, ood_sets,
                        MatrixConfig(seed=seed, **overrides))
    report["synthetic_drill"] = {
        "seed": int(seed), "classes": int(classes), "per_class": int(per_class),
        "bootstrap_epochs": int(bootstrap_epochs), "arch": cfg.model.arch, "img_size": int(img),
    }
    return report


def synthetic_config(classes: int = 4):
    """The drill's config: the tiny config at `classes`, with the drill's
    EM mean step (0.05) so the bootstrap converges in a few passes."""
    from mgproto_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config(num_classes=classes)
    return cfg.replace(em=dataclasses.replace(cfg.em, mean_lr=0.05))


# --------------------------------------------------------------- real matrix
def _loader_arrays(loader, max_samples: int):
    """Drain a loader into bounded host arrays (images, labels or None),
    dropping padded sentinel rows (label -1)."""
    images, labels, have_labels = [], [], False
    n = 0
    for batch in loader:
        if isinstance(batch, tuple):
            imgs, lbls = batch[0], batch[1]
            have_labels = True
        else:
            imgs, lbls = batch, None
        imgs = np.asarray(imgs, np.float32)
        if lbls is not None:
            valid = np.asarray(lbls) >= 0
            imgs, lbls = imgs[valid], np.asarray(lbls)[valid]
            labels.append(lbls)
        images.append(imgs)
        n += len(imgs)
        if n >= max_samples:
            break
    imgs = np.concatenate(images)[:max_samples]
    lbls = np.concatenate(labels)[:max_samples] if have_labels else None
    return imgs, lbls


def _matrix_sets(cfg, max_samples: int, device):
    """(id images, id labels, {ood name: images}) from the config's test
    and OoD loaders, each cut at `max_samples`."""
    from mgproto_tpu_torch.data import build_pipelines

    _, _, test_loader, ood_loaders = build_pipelines(cfg, device=device)
    try:
        id_images, id_labels = _loader_arrays(test_loader, max_samples)
        ood_sets = {}
        for i, ld in enumerate(ood_loaders, start=1):
            name = (os.path.basename(cfg.data.ood_dirs[i - 1].rstrip("/"))
                    if i <= len(cfg.data.ood_dirs) else f"ood{i}")
            ood_sets[name], _ = _loader_arrays(ld, max_samples)
    finally:
        for loader in (test_loader, *ood_loaders):
            loader.close()
    return id_images, id_labels, ood_sets


def matrix_main(argv=None) -> int:
    from mgproto_tpu_torch.cli.common import (
        SINGLE_PROCESS_REFUSED,
        add_train_args,
        check_ported,
    )
    from mgproto_tpu_torch.numerics import resolve_device

    p = argparse.ArgumentParser(
        prog="python -m mgproto_tpu_torch.cli.trust matrix",
        description="Serving-path robustness matrix: ID x OoD pairs + corruption ladder "
                    "through the calibrated engine")
    add_train_args(p)
    p.add_argument("--synthetic", action="store_true",
                   help="the hermetic drill (tiny model, production consolidation "
                        "bootstrap, seeded)")
    p.add_argument("--artifact", default="",
                   help="serve a calibrated artifact (cli.export) instead of a checkpoint")
    p.add_argument("--checkpoint", default="auto",
                   help="checkpoint path ('auto' = the latest in --model_dir)")
    p.add_argument("--max_samples", type=int, default=512,
                   help="cap per matrix cell (bounded eval memory)")
    p.add_argument("--classes", type=int, default=4, help="synthetic drill: generator classes")
    p.add_argument("--per_class", type=int, default=16,
                   help="synthetic drill: eval samples per class")
    p.add_argument("--percentile", type=float, default=5.0,
                   help="abstention operating point (ID percentile)")
    p.add_argument("--out", default="trust_report.json", help="report path")
    args = p.parse_args(argv)
    check_ported(args)
    check_ported(args, SINGLE_PROCESS_REFUSED)
    if resolve_device(args.device).type == "cuda":
        # the missing kernels of this face, one nvcc each, all at once
        from mgproto_tpu_torch.ops import _build

        _build.build_all(_build.SYNTHETIC_KERNELS if args.synthetic else _build.SERVE_KERNELS)

    if args.synthetic:
        report = run_synthetic_matrix(seed=args.seed, classes=args.classes,
                                      per_class=args.per_class, percentile=args.percentile,
                                      device=args.device)
    else:
        from mgproto_tpu_torch.cli.common import config_from_args
        from mgproto_tpu_torch.serving.engine import ServingEngine
        from mgproto_tpu_torch.trust.matrix import MatrixConfig, run_matrix

        cfg = config_from_args(args)
        id_images, id_labels, ood_sets = _matrix_sets(cfg, args.max_samples, args.device)
        if not ood_sets:
            raise SystemExit("no OoD sets: pass --ood_dir (repeatable) or --synthetic")
        if args.artifact:
            engine = ServingEngine.from_artifact(args.artifact, device=args.device)
        else:
            from mgproto_tpu_torch.engine.eval import Evaluator
            from mgproto_tpu_torch.engine.train import Trainer
            from mgproto_tpu_torch.serving.calibration import calibrate_from_config
            from mgproto_tpu_torch.utils.checkpoint import (
                adopt_checkpoint_train_config,
                latest_checkpoint,
                restore_checkpoint,
            )

            path = (latest_checkpoint(cfg.model_dir) if args.checkpoint == "auto"
                    else args.checkpoint)
            if not path:
                raise FileNotFoundError(f"no checkpoint found in {cfg.model_dir}")
            cfg = adopt_checkpoint_train_config(cfg, path, log=print)
            trainer = Trainer(cfg, steps_per_epoch=1, device=args.device)
            state = restore_checkpoint(path, trainer.init_state(cfg.seed, for_restore=True))
            calib = calibrate_from_config(cfg, trainer, state, percentile=args.percentile,
                                          device=args.device)
            engine = ServingEngine.from_live(
                Evaluator(state.model, state.gmm, cfg, device=args.device), calibration=calib)
        report = run_matrix(engine, id_images, id_labels, ood_sets, MatrixConfig(seed=args.seed))

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    gates = report.get("gates") or {}
    print(json.dumps({
        "report": args.out,
        "pairs": {p["pair"]: round(p["auroc"], 4) for p in report.get("pairs", [])},
        "steady_state_recompiles": report.get("steady_state_recompiles"),
        "gates_checked": gates.get("checked"),
        "gates_failed": gates.get("failed"),
    }))
    return 0 if gates.get("ok", False) else 1


# -------------------------------------------------------------------- interp
def interp_main(argv=None) -> int:
    from mgproto_tpu_torch.cli.common import (
        add_train_args,
        check_ported,
        config_from_args,
        maybe_init_distributed,
    )

    p = argparse.ArgumentParser(
        prog="python -m mgproto_tpu_torch.cli.trust interp",
        description="Sharded consistency/stability/purity over a checkpoint and a "
                    "CUB-layout parts tree (trust/interp_sharded.py)")
    add_train_args(p)
    p.add_argument("--cub_root", required=True,
                   help="CUB_200_2011-layout root (images.txt, parts/)")
    p.add_argument("--checkpoint", default="auto")
    p.add_argument("--half_size", type=int, default=36)
    p.add_argument("--purity_half_size", type=int, default=16)
    p.add_argument("--top_k", type=int, default=10)
    p.add_argument("--noise_seed", type=int, default=0)
    p.add_argument("--out", default="trust_interp.json")
    args = p.parse_args(argv)
    check_ported(args)
    cfg = config_from_args(args)
    maybe_init_distributed(args)
    from mgproto_tpu_torch.cli.interpret import build_eval_loader
    from mgproto_tpu_torch.data.cub_parts import CubParts
    from mgproto_tpu_torch.numerics import resolve_device
    from mgproto_tpu_torch.parallel.mesh import leave_process_group
    from mgproto_tpu_torch.parallel.multihost import is_primary_host
    from mgproto_tpu_torch.parallel.trainer import ShardedTrainer
    from mgproto_tpu_torch.trust.interp_sharded import interp_metrics_sharded
    from mgproto_tpu_torch.utils.checkpoint import (
        adopt_checkpoint_train_config,
        latest_checkpoint,
    )

    try:
        if resolve_device(args.device).type == "cuda":
            from mgproto_tpu_torch.ops import _build

            _build.build_all(("bn_epilogue",))  # the trunk's tails; the density is plain
        path = latest_checkpoint(cfg.model_dir) if args.checkpoint == "auto" else args.checkpoint
        if not path:
            raise FileNotFoundError(f"no checkpoint found in {cfg.model_dir}")
        cfg = adopt_checkpoint_train_config(cfg, path, log=print if is_primary_host() else None)
        trainer = ShardedTrainer(cfg, steps_per_epoch=1, device=args.device)
        state = trainer.restore(path)
        loaders = []

        def batches():  # a fresh iterator of global batches per pass, every rank alike
            loaders.append(build_eval_loader(cfg, args.cub_root))
            return iter(loaders[-1])

        try:
            metrics = interp_metrics_sharded(
                trainer, state, batches, CubParts(args.cub_root), cfg.model.num_classes,
                consistency_half_size=args.half_size, purity_half_size=args.purity_half_size,
                top_k=args.top_k, noise_seed=args.noise_seed)
        finally:
            for loader in loaders:
                loader.close()
        record = {"trust_interp": True, "checkpoint": path, **metrics}
        if is_primary_host():
            with open(args.out, "w") as f:
                json.dump(record, f, indent=2, sort_keys=True)
            print(json.dumps(record))
    finally:
        leave_process_group()
    return 0


# -------------------------------------------------------------------- report
def report_main(argv=None) -> int:
    from mgproto_tpu_torch.cli.telemetry import _print_gate_result, trust_gates

    p = argparse.ArgumentParser(
        prog="python -m mgproto_tpu_torch.cli.trust report",
        description="Merge matrix + interp records into one trust report (or render an "
                    "existing one's verdicts)")
    p.add_argument("report", nargs="?", default=None, help="existing report to render")
    p.add_argument("--matrix", default=None, help="matrix record to merge")
    p.add_argument("--interp", default=None, help="interp record to merge into the matrix record")
    p.add_argument("--out", default=None, help="write the merged report here")
    args = p.parse_args(argv)

    if args.report and not (args.matrix or args.interp):
        with open(args.report) as f:
            record = json.load(f)
    elif args.matrix:
        with open(args.matrix) as f:
            record = json.load(f)
        if args.interp:
            with open(args.interp) as f:
                interp = json.load(f)
            record["interp"] = {k: v for k, v in interp.items() if k != "trust_interp"}
            # merged content invalidates the stored self-gate: re-derive it
            record["gates"] = trust_gates(record)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(record, f, indent=2, sort_keys=True)
    else:
        raise SystemExit("pass a report path, or --matrix [--interp]")

    result = trust_gates(record)
    _print_gate_result(result, False)
    if record.get("interp"):
        print("interp: " + " ".join(f"{k}={v}" for k, v in sorted(record["interp"].items())))
    return 0 if result["ok"] else 1


def main(argv: Optional[list] = None) -> Optional[int]:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "matrix":
        return matrix_main(argv[1:])
    if argv and argv[0] == "interp":
        return interp_main(argv[1:])
    if argv and argv[0] == "report":
        return report_main(argv[1:])
    print("usage: python -m mgproto_tpu_torch.cli.trust {matrix|interp|report} [options]\n"
          "  matrix --synthetic --device cpu --out report.json\n"
          "  matrix --artifact M.mgproto --test_dir D --ood_dir O\n"
          "  interp --cub_root CUB --model_dir RUN --device cpu --out interp.json\n"
          "  report report.json")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
