"""The training schedule (counterpart of mgproto_tpu/cli/train.py's
`run_training`, without its argparse `main`).

Per epoch: the warm/joint phase and the mining and EM gates
(`Trainer.epoch_flags`), one training epoch, a test pass (with the OoD sets
when the config names any) and a `nopush` checkpoint; at the push epochs the
prototype projection, `push_provenance.json`, a test pass and a `push`
checkpoint, and (with `render_push`, the default) the pushed prototypes'
pictures under `model_dir/img/epoch-{epoch}`. After the last epoch: the
top-M prune, a test pass and a `prune` checkpoint. Checkpoints carry the
whole train state (utils/checkpoint.py), so `resume` continues where a run
stopped: the loaders are deterministic per (seed, epoch, sample), so a
resumed run trains on the batches the uninterrupted one did. Logs go to
`train.log` and `metrics.jsonl` under `cfg.model_dir`.

Not ported: the JAX run_training's telemetry, multi-host, chaos drills, rollback
and preemption, autotuning and the profiler.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Tuple, Union

import numpy as np
import torch

from mgproto_tpu_torch.config import Config
from mgproto_tpu_torch.core.mgproto import prune_top_m
from mgproto_tpu_torch.core.state import TrainState
from mgproto_tpu_torch.data import build_pipelines
from mgproto_tpu_torch.engine.evaluate import evaluate, evaluate_with_ood
from mgproto_tpu_torch.engine.push import provenance_dict, push_prototypes, render_prototypes
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.utils.checkpoint import (
    apply_retention,
    find_latest_checkpoint,
    latest_checkpoint,
    load_metadata,
    restore_checkpoint,
    save_state_w_condition,
)
from mgproto_tpu_torch.utils.log import Logger, MetricsWriter, timed_span


def _labeled(loader):
    """(images, labels, ids) loader batches -> (images, labels) eval batches;
    the ids are host bookkeeping."""
    for batch in loader:
        yield batch[0], batch[1]


def _test(trainer, state, test_loader, ood_loaders, log):
    if ood_loaders:
        return evaluate_with_ood(trainer, state, _labeled(test_loader),
                                 [_labeled(o) for o in ood_loaders], log=log)
    return evaluate(trainer, state, _labeled(test_loader), log=log)


def run_training(
    cfg: Config,
    resume: str = "",
    keep_last: int = 0,
    device: Union[str, torch.device, None] = None,
    render_push: bool = True,
) -> Tuple[TrainState, float]:
    """Run the whole schedule of `cfg`; returns (final state, last test
    accuracy).

    `resume`: "" starts fresh; "auto" continues from the newest checkpoint
    in `cfg.model_dir` (fresh when there is none); a path continues from
    that checkpoint. Training restarts at the saved epoch + 1, so a `nopush`
    save at a push epoch skips that epoch's push, as in the JAX package; a
    `prune` checkpoint means the run is complete and returns at once.
    Every stage saves a checkpoint (the accuracy target is 0). `keep_last`
    > 0 keeps only the newest `keep_last` checkpoints and the most accurate
    one, after each epoch. `device`: CUDA unless the caller names another.
    `render_push`: draw 3 JPEGs per pushed prototype at each push epoch (the
    JAX default); False skips the pictures."""
    resume_path = None
    if resume == "auto":
        resume_path = find_latest_checkpoint(cfg.model_dir)
    elif resume:
        resume_path = resume
        if not os.path.exists(resume_path):
            raise FileNotFoundError(resume_path)

    os.makedirs(cfg.model_dir, exist_ok=True)
    with contextlib.ExitStack() as stack:  # closes whatever was opened, on every path
        log = Logger(os.path.join(cfg.model_dir, "train.log"))
        stack.callback(log.close)
        metrics = MetricsWriter(os.path.join(cfg.model_dir, "metrics.jsonl"))
        stack.callback(metrics.close)
        train_loader, push_loader, test_loader, ood_loaders = build_pipelines(cfg, device=device)
        for loader in (train_loader, push_loader, test_loader, *ood_loaders):
            stack.callback(loader.close)
        trainer = Trainer(cfg, len(train_loader), device=device)
        log(f"device: {trainer.device}  steps/epoch: {trainer.steps_per_epoch}")
        state = trainer.init_state(cfg.seed)
        start_epoch = 0
        if resume_path:
            meta = load_metadata(resume_path) or {}
            state = restore_checkpoint(resume_path, state)
            if meta.get("stage") == "prune":
                log(f"run already complete ({resume_path}); nothing to resume")
                return state, float(meta.get("accuracy", 0.0))
            start_epoch = int(meta.get("epoch", -1)) + 1
            log(f"resumed {resume_path} -> epoch {start_epoch}")

        run_meta = {"compute_dtype": cfg.model.compute_dtype, "arch": cfg.model.arch}
        img_dir = os.path.join(cfg.model_dir, "img") if render_push else None
        accu = 0.0
        log("start training")
        for epoch in range(start_epoch, cfg.schedule.num_train_epochs):
            state, accu = _run_epoch(cfg, trainer, state, epoch, train_loader, test_loader,
                                     push_loader, ood_loaders, log, metrics, run_meta, img_dir)
            if keep_last > 0:
                apply_retention(cfg.model_dir, keep_last)

        last_epoch = max(cfg.schedule.num_train_epochs - 1, start_epoch)
        top_m = min(cfg.schedule.prune_top_m, cfg.model.prototypes_per_class)
        state.gmm = prune_top_m(state.gmm, top_m, renormalize=cfg.schedule.prune_renormalize)
        with timed_span(log, "prune test") as span:
            accu, test_results = _test(trainer, state, test_loader, ood_loaders, log)
        metrics.write(state.step, {"epoch": last_epoch, "stage": "prune", "test_s": span["s"],
                                   **test_results})
        save_state_w_condition(cfg.model_dir, state, last_epoch, "prune", accu, 0.0,
                               metadata=run_meta)
        log("training done")
        return state, accu


def _run_epoch(cfg, trainer, state, epoch, train_loader, test_loader, push_loader,
               ood_loaders, log, metrics, run_meta, img_dir):
    """One epoch: train, test, the `nopush` save, and at a push epoch the
    push, its provenance, the render into `img_dir` (unless None), a test
    and the `push` save."""
    log(f"epoch: \t{epoch}")
    flags = trainer.epoch_flags(state, epoch)
    log(f"use mining: \t{flags['use_mine']}")
    log(f"update GMM: \t{flags['update_gmm']}")

    train_loader.epoch = epoch  # the (seed, epoch) streams of this epoch
    with timed_span(log, "train") as train_span:
        state, last = trainer.train_epoch(state, train_loader, epoch)
    if last is not None:
        m = {k: (v.item() if isinstance(v, torch.Tensor) else v)
             for k, v in last._asdict().items()}
        if not np.isfinite(m["loss"]):
            last_ckpt = latest_checkpoint(cfg.model_dir)
            hint = (f"resume from {last_ckpt} with resume='auto'" if last_ckpt
                    else "no checkpoint was saved yet; adjust the config")
            raise RuntimeError(f"non-finite loss {m['loss']} at epoch {epoch} "
                               f"(step {state.step}); {hint}")
        log("\tloss: {loss:.4f}  ce: {cross_entropy:.4f}  mine: {mine:.4f}  aux: {aux:.4f}"
            "  acc: {accuracy:.4f}  mem: {full_mem_ratio:.3f}".format(**m))
        metrics.write(state.step, {"epoch": epoch, "train_s": train_span["s"],
                                   **{k: float(v) for k, v in m.items()}})

    with timed_span(log, "test") as span:
        accu, test_results = _test(trainer, state, test_loader, ood_loaders, log)
    metrics.write(state.step, {"epoch": epoch, "test_s": span["s"], **test_results})
    save_state_w_condition(cfg.model_dir, state, epoch, "nopush", accu, 0.0, metadata=run_meta)

    if epoch in cfg.schedule.push_epochs():
        with timed_span(log, "push") as span:
            state, push_result = push_prototypes(trainer, state, push_loader)
        with open(os.path.join(cfg.model_dir, "push_provenance.json"), "w") as f:
            json.dump({"epoch": epoch, **provenance_dict(push_result)}, f)
        log(f"\tpushed: \t{int(push_result.pushed.sum())} of {push_result.pushed.size}")
        render = {}
        if img_dir is not None:
            push_ds = push_loader.dataset
            # push_prototypes(save_dir=img_dir, ...) in one call, split here
            # so the render has its own span
            with timed_span(log, "push render") as render_span:
                render_prototypes(trainer, state, push_result, lambda i: push_ds.load(i)[0],
                                  img_dir, epoch)
            render = {"render_s": render_span["s"]}
        accu, test_results = _test(trainer, state, test_loader, ood_loaders, log)
        metrics.write(state.step, {"epoch": epoch, "stage": "push", "push_s": span["s"],
                                   **render, "pushed": int(push_result.pushed.sum()),
                                   **test_results})
        save_state_w_condition(cfg.model_dir, state, epoch, "push", accu, 0.0,
                               metadata=run_meta)
    return state, accu
