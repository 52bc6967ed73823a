"""Shared command-line plumbing: dataset presets and argparse -> Config
(counterpart of mgproto_tpu/cli/common.py).

Every flag of the JAX package's `add_train_args` parses here under the
same name and default. Each either sets the port's field of the same name
(or, for the run's own settings such as --ckpt_format and
--barrier_timeout_s, is read by `cli/train.py`), or is refused at a value
other than its default by `config_from_args`, naming the ROADMAP item
that will port it (`REFUSED`). `maybe_init_distributed` joins the process
group for --distributed before any device use, with --barrier_timeout_s
as the timeout of every collective. `--telemetry_dir` and
`--no-telemetry` are read by the mains. The port adds
`--device` (default cuda), its device rule: the entry points run on the
card unless the caller names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict

from mgproto_tpu_torch.config import (
    Config,
    DataConfig,
    EMConfig,
    LossConfig,
    MeshConfig,
    ModelConfig,
    OptimConfig,
    ScheduleConfig,
)

# num_classes per dataset and its folder under --data_root
DATASET_PRESETS: Dict[str, Dict] = {
    "CUB": {"num_classes": 200, "sub": "cub200_cropped"},
    "Cars": {"num_classes": 196, "sub": "stanford_cars_cropped"},
    "Dogs": {"num_classes": 120, "sub": "stanford_dogs"},
    "Pets": {"num_classes": 37, "sub": "oxford_pets"},
    "ImageNet": {"num_classes": 1000, "sub": "imagenet"},
}

# flags the port parses but does not implement: (dest, what is accepted,
# the ROADMAP item that ports the rest). What is accepted is a value or a
# tuple of values.
REFUSED = (
    ("straggler_threshold", 0.25, "A9 (obs and telemetry: straggler detection)"),
    ("straggler_patience", 5, "A9 (obs and telemetry: straggler detection)"),
)


# the mains that run one process in both packages (export, serve, trust
# matrix: JAX's parse these flags but never joins a group) refuse the
# distributed flags; cli.train, cli.evaluate, cli.interpret and cli.trust
# interp take them
ONE_PROCESS = "is refused by design: this main runs one process, in the JAX package too"
SINGLE_PROCESS_REFUSED = (
    ("distributed", False, ONE_PROCESS),
    ("mesh_data", -1, ONE_PROCESS),
    ("mesh_model", 1, ONE_PROCESS),
)

# the serve and export mains' own flags that the port parses but does not
# implement, refused the same way (cli/serve.py, cli/export.py check them
# before anything loads)
SERVE_REFUSED = (
    ("aot_cache", "", "A7 (the AOT executable cache)"),
)
EXPORT_REFUSED = (
    ("aot_cache", False, "A7 (the AOT executable cache)"),
    ("aot_buckets", "1,2,4,8", "A7 (the AOT executable cache)"),
)


class NotPortedError(ValueError):
    """A flag set to a value the port does not implement yet."""


def add_train_args(p: argparse.ArgumentParser) -> None:
    """The JAX package's training flags (same names, same defaults) and
    `--device`. The flags of `REFUSED` parse but are refused at another
    value by `config_from_args`."""
    # the reference's main.py flags
    p.add_argument("--dataset", default="CUB", choices=sorted(DATASET_PRESETS))
    p.add_argument("--arch", default="resnet34")
    p.add_argument("--aux_loss", default="proxy_anchor",
                   choices=["proxy_anchor", "proxy_nca", "ms", "contrastive",
                            "triplet", "npair"])
    p.add_argument("--aux_emb_sz", type=int, default=32)
    p.add_argument("--mem_sz", type=int, default=800)
    p.add_argument("--mine_level", type=int, default=20)
    # paths (the reference's settings.py, as flags)
    p.add_argument("--data_root", default="./datasets")
    p.add_argument("--train_dir", default="")
    p.add_argument("--test_dir", default="")
    p.add_argument("--push_dir", default="")
    p.add_argument("--ood_dir", action="append", default=[],
                   help="OoD test set root (repeatable)")
    p.add_argument("--model_dir", default="./saved_models")
    # shapes and schedule
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--num_classes", type=int, default=0, help="0 = dataset preset")
    p.add_argument("--protos_per_class", type=int, default=10)
    p.add_argument("--proto_dim", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=80)
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--warm_epochs", type=int, default=0)
    p.add_argument("--mine_start", type=int, default=40)
    p.add_argument("--gmm_start", type=int, default=35)
    p.add_argument("--push_start", type=int, default=100)
    p.add_argument("--push_every", type=int, default=10)
    p.add_argument("--prune_top_m", type=int, default=8)
    p.add_argument("--prune_renormalize", action="store_true",
                   help="renormalize the kept priors of a class to sum to 1 "
                        "after the prune (recompute OoD thresholds after)")
    p.add_argument("--em_reference_stepping", action="store_true",
                   help="the reference's EM stepping: one Adam step per "
                        "(class, round) in class order (core/em.py)")
    p.add_argument("--no_pretrained", action="store_true",
                   help="start the trunk from seeded random weights, not "
                        "from its local .pth (models/pretrained.py)")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the trunk's dtype (parameters, density and the bank stay f32)")
    p.add_argument("--fused_scoring", action="store_true", default=None,
                   help="force the score_pool kernels on (default: on for "
                        "CUDA, the plain version on the CPU)")
    p.add_argument("--no_fused_scoring", dest="fused_scoring", action="store_false",
                   help="force the plain scoring path")
    p.add_argument("--fused_epilogue", action="store_true", default=None,
                   help="force the BN epilogue kernel on (resnet trunks only; "
                        "default: on for CUDA resnets, off elsewhere)")
    p.add_argument("--no_fused_epilogue", dest="fused_epilogue", action="store_false",
                   help="force the plain block tail")
    p.add_argument("--remat", action="store_true",
                   help="recompute every trunk block in the backward "
                        "(resnet blocks, dense layers): memory for FLOPs")
    p.add_argument("--remat_stages", default="",
                   help="comma-separated stages to recompute ('layer1'.."
                        "'layer4', 'denseblock1'..'denseblock4'); --remat "
                        "overrides")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--worker_backend", default="thread", choices=["thread", "process"],
                   help="train-loader workers: 'process' (a spawn pool) runs "
                        "the augmentation math past the GIL")
    p.add_argument("--device_augment", action="store_true", default=None,
                   help="force the uint8 wire and the augmentation tail on "
                        "the device (default: on for CUDA, off for the CPU)")
    p.add_argument("--no_device_augment", dest="device_augment", action="store_false",
                   help="force the f32 host augmentation")
    p.add_argument("--prefetch-depth", "--prefetch_depth", dest="prefetch_depth", type=int,
                   default=2,
                   help="batches held in flight, so the next copy to the "
                        "device overlaps the current step")
    p.add_argument("--em_max_active", type=int, default=-1,
                   help="compact EM width (core/em.py): -1 auto "
                        "(min(classes, batch)), 0 dense, >0 that width")
    p.add_argument("--fused_estep", action="store_true", default=None,
                   help="force the E-step kernel on (default: on for CUDA)")
    p.add_argument("--no_fused_estep", dest="fused_estep", action="store_false",
                   help="force the plain E-step")
    p.add_argument("--async_bank", action="store_true", default=None,
                   help="the async bank pipeline: batch N's enqueue and EM run on a "
                        "second CUDA stream beside batch N+1's trunk, which scores "
                        "one-step-stale prototypes (default: off)")
    p.add_argument("--no_async_bank", dest="async_bank", action="store_false",
                   help="force the synchronous step")
    p.add_argument("--auto_tune", action="store_true",
                   help="the memory planner (perf/planner.py): step candidate (batch, "
                        "remat, prefetch, augment, async_bank) plans on the card, read "
                        "their peak memory, and run the largest plan that fits the "
                        "device's memory with margin (MGPROTO_HBM_MARGIN, default 0.08; "
                        "budget override MGPROTO_HBM_BUDGET_BYTES). The chosen plan and "
                        "every candidate's peak land in telemetry meta.json and in each "
                        "checkpoint's metadata; --resume adopts the checkpoint's plan")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs the "
                        "plain PyTorch path)")
    # runtime
    p.add_argument("--distributed", action="store_true",
                   help="join the process group the torch launcher describes "
                        "(torchrun --nproc_per_node N): NCCL on CUDA, gloo on the CPU")
    p.add_argument("--mesh_data", type=int, default=-1,
                   help="ranks on the data axis (-1: all not on the model axis)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="ranks on the class axis of the GMM head, the bank and EM")
    p.add_argument("--resume", default="",
                   help="checkpoint path, or 'auto' for the newest checkpoint "
                        "with a valid manifest in model_dir (a preempted run "
                        "resumes mid-epoch, bit for bit)")
    # fault tolerance (resilience/)
    p.add_argument("--max-bad-steps", "--max_bad_steps", dest="max_bad_steps", type=int,
                   default=3,
                   help="consecutive non-finite steps (their updates are "
                        "skipped) before rolling back to the last good "
                        "checkpoint (0 disables the rollback)")
    p.add_argument("--divergence_check_every", type=int, default=8,
                   help="steps between two polls of the non-finite streak")
    p.add_argument("--max_rollbacks", type=int, default=2,
                   help="rollbacks before the run gives up")
    p.add_argument("--keep_last", type=int, default=0,
                   help="keep only the newest N checkpoints (and --keep_best "
                        "by accuracy); 0 keeps everything")
    p.add_argument("--keep_best", type=int, default=1,
                   help="the most accurate checkpoints kept beside --keep_last")
    p.add_argument("--no_preempt_handlers", action="store_true",
                   help="do not install the SIGTERM/SIGINT handlers (default: "
                        "installed; the first signal checkpoints and exits 0, "
                        "a second kills)")
    p.add_argument("--barrier_timeout_s", type=float, default=300.0,
                   help="under --distributed: seconds a guarded barrier, and every "
                        "collective, waits for a peer before the survivors write "
                        "PEER_LOST.json, dump the flight recorder and exit 75 "
                        "(<= 0: no guard, collectives wait 600 s)")
    p.add_argument("--straggler_threshold", type=float, default=0.25,
                   help="not ported (A9): the default only")
    p.add_argument("--straggler_patience", type=int, default=5,
                   help="not ported (A9): the default only")
    p.add_argument("--ckpt_format", default="auto", choices=["auto", "sharded", "replicated"],
                   help="checkpoint format: 'sharded' (every rank writes its own shards, "
                        "a COMMIT marker publishes), 'replicated' (rank 0 writes the "
                        "whole state), 'auto' (sharded under several ranks)")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of the first epoch here "
                        "(utils/log.py profiler_trace)")
    # the observatory (obs/profiler.py): step-scoped capture windows, far
    # cheaper than the epoch-wide --profile_dir trace
    p.add_argument("--profile_steps", default="",
                   help="open a profiler capture window for this step range ('120:130', or "
                        "a bare step for one step); on the CPU (--device cpu) the window "
                        "writes a counted cost report instead of a trace (obs/profiler.py)")
    p.add_argument("--profile_on_anomaly", action="store_true",
                   help="open a capture window on an anomaly: a step-time spike over the "
                        "EMA, a cold path mid-run, or a loader-wait share over the "
                        "threshold; traces land under --profile_out")
    p.add_argument("--profile_out", default="",
                   help="capture-window output dir (default: evidence/trace_<model_dir "
                        "basename>)")
    p.add_argument("--telemetry-dir", "--telemetry_dir", dest="telemetry_dir", default="",
                   help="telemetry output dir (metrics.prom / metrics.jsonl / health.jsonl / "
                        "trace.json / meta.json; default: <model_dir>/telemetry); summarize "
                        "with `python -m mgproto_tpu_torch.cli.telemetry <dir>`")
    p.add_argument("--no-telemetry", "--no_telemetry", dest="no_telemetry",
                   action="store_true", help="disable the telemetry subsystem entirely")
    p.add_argument("--target_accu", type=float, default=0.0,
                   help="save checkpoints only at or above this test accuracy")


def check_ported(args: argparse.Namespace, rows=REFUSED) -> None:
    """Raise NotPortedError for the first flag of `rows` (default `REFUSED`)
    set to a value the port does not implement (or, for
    `SINGLE_PROCESS_REFUSED`, that the main does not take by design)."""
    for dest, accepted, item in rows:
        value = getattr(args, dest)
        ok = value in accepted if isinstance(accepted, tuple) else value == accepted
        if not ok:
            reason = item if item == ONE_PROCESS else f"is not ported; ROADMAP {item}"
            raise NotPortedError(f"--{dest}={value!r} {reason}")


def maybe_init_distributed(args: argparse.Namespace) -> None:
    """Honor --distributed before any device use: join the process group
    from the torch launcher's environment (`torchrun`; strict: a rank that
    cannot join raises rather than train alone) with NCCL for a CUDA
    device and gloo for the CPU, and make a bare `--device cuda` this
    rank's card, `cuda:LOCAL_RANK`. Every collective's timeout is
    --barrier_timeout_s when it is above 0 (a wedged peer then surfaces
    as an error the failure agreement answers, cli/train.py). A group
    the caller joined before is kept as it is."""
    if not args.distributed:
        return
    from mgproto_tpu_torch.parallel.mesh import (
        DEFAULT_TIMEOUT_S,
        initialize_distributed,
        local_device,
    )

    timeout = getattr(args, "barrier_timeout_s", 0.0)
    initialize_distributed(device=local_device(args.device), strict=True,
                           timeout_s=timeout if timeout and timeout > 0 else DEFAULT_TIMEOUT_S)
    args.device = str(local_device(args.device))


def config_from_args(args: argparse.Namespace) -> Config:
    """The run's Config from parsed `add_train_args` flags (refusing the
    flags `check_ported` names)."""
    check_ported(args)
    preset = DATASET_PRESETS[args.dataset]
    num_classes = args.num_classes or preset["num_classes"]
    root = os.path.join(args.data_root, preset["sub"])
    # the reference's folders: train_cropped_augmented, train_cropped
    # (push) and test_cropped
    train_dir = args.train_dir or os.path.join(root, "train_cropped_augmented")
    push_dir = args.push_dir or os.path.join(root, "train_cropped")
    test_dir = args.test_dir or os.path.join(root, "test_cropped")
    return Config(
        model=ModelConfig(
            arch=args.arch,
            img_size=args.img_size,
            num_classes=num_classes,
            prototypes_per_class=args.protos_per_class,
            proto_dim=args.proto_dim,
            sz_embedding=args.aux_emb_sz,
            mine_T=args.mine_level,
            mem_capacity=args.mem_sz,
            pretrained=not args.no_pretrained,
            compute_dtype=args.compute_dtype,
            fused_scoring=args.fused_scoring,
            fused_epilogue=args.fused_epilogue,
            remat=args.remat,
            remat_stages=tuple(s for s in args.remat_stages.split(",") if s),
        ),
        em=EMConfig(
            reference_stepping=args.em_reference_stepping,
            max_active_classes=args.em_max_active,
            fused_estep=args.fused_estep,
            async_bank=args.async_bank,
        ),
        optim=OptimConfig(),
        schedule=ScheduleConfig(
            num_train_epochs=args.epochs,
            num_warm_epochs=args.warm_epochs,
            mine_start=args.mine_start,
            update_gmm_start=args.gmm_start,
            push_start=args.push_start,
            push_every=args.push_every,
            prune_top_m=args.prune_top_m,
            prune_renormalize=args.prune_renormalize,
        ),
        loss=LossConfig(aux_loss=args.aux_loss),
        data=DataConfig(
            train_dir=train_dir,
            test_dir=test_dir,
            train_push_dir=push_dir,
            ood_dirs=tuple(args.ood_dir),
            train_batch_size=args.batch_size,
            test_batch_size=args.batch_size,
            train_push_batch_size=args.batch_size,
            num_workers=args.num_workers,
            worker_backend=args.worker_backend,
            prefetch_depth=args.prefetch_depth,
            device_augment=args.device_augment,
        ),
        mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model),
        seed=args.seed,
        model_dir=args.model_dir,
    )


def describe(cfg: Config) -> str:
    return "\n".join(f"{f.name}: {getattr(cfg, f.name)}" for f in dataclasses.fields(cfg))
