"""The training schedule and its command line (counterpart of
mgproto_tpu/cli/train.py).

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

Fault tolerance (resilience/): each epoch runs under an `EpochGuard`.
`max_bad_steps` consecutive non-finite steps (their updates skipped in the
step) restore the last good checkpoint in place and replay from it, at
most `max_rollbacks` times. SIGTERM/SIGINT (handlers installed by `main`)
or the chaos drill's simulated preemption let the step in flight finish,
save a `preempt` checkpoint with the position in the epoch, write
PREEMPTED.json and return; `resume="auto"` then skips the batches already
applied and continues bit for bit. A fresh flight recorder records the
rollbacks and preemptions and dumps into `model_dir/telemetry` on each of
them and on a crash.

Telemetry (telemetry/session.py) is on by default, into
`model_dir/telemetry` (`telemetry_dir`; `telemetry=False` turns it off):
each step through the session's StepMonitor, each epoch's EM width and
fallbacks, a ModelHealth record and a flush at each epoch's end, the
run's settings and per-rank state bytes in meta.json, and spans of the
epoch and its train / test / push parts in trace.json. `auto_tune` runs
the memory planner (perf/planner.py) before anything sizes itself off the
config: the chosen plan goes into meta.json and into every checkpoint's
metadata as `autotune_plan`, and a resumed `auto_tune` run adopts the
checkpoint's plan instead of planning again. Under several ranks the
plan is one decision for the world (each rank measures its own card, the
planner agrees on the worst), so every rank trains at the same batch.

The observatory (obs/): `profile_dir` traces the first epoch this
invocation trains (utils/log.py `profiler_trace`); `profile_steps` and
`profile_on_anomaly` run an `obs.profiler.ProfilerWindow` over every step,
fed by `Trainer.train_epoch`, its recompile trigger reading the session's
StepMonitor, writing under `profile_out` (default
`evidence/trace_<model_dir basename>`, each other rank under `h<rank>/`).
Only one profiler runs in a process, so while the `profile_dir` trace is
open the window is held: a capture that falls due in the first epoch is
skipped with a logged note (the epoch's trace holds those steps), and
later epochs capture as usual. No window exists without `profile_steps`
or `profile_on_anomaly`: JAX's unarmed window under several ranks is the
straggler trigger's target, and straggler detection is not ported
(`cli/common.py` refuses its flags).

Several ranks (`--distributed` under `torchrun --nproc_per_node N`, the
mesh from --mesh_data/--mesh_model): training always runs through
parallel/trainer.py's ShardedTrainer (one rank: the Trainer's step), each
rank reads its loader shard, and the test pass and the push gather across
the ranks. Checkpoints are sharded by default (`ckpt_format`, each rank
writes its own shards, a COMMIT marker publishes); rank 0 writes the
rest: push_provenance.json, the rendered pictures and the preemption
marker; the other ranks log to host-tagged files (`train.log.h1`,
`metrics.jsonl.h1`). Pod fault tolerance: `barrier_timeout_s` > 0 arms
the guarded barrier over `model_dir` (parallel/multihost.py; its session
from MGPROTO_BARRIER_SESSION or rank 0's clock), and the process group's
collectives time out with it too. A peer that dies (MGPROTO_CHAOS_
KILL_HOST_AT: exit 86) or hangs (_WEDGE_HOST_AT) shows as a barrier
timeout or a collective's error; either way the survivors agree on the
lost ranks, write PEER_LOST.json, dump the flight recorder and `main`
exits 75, so a launcher relaunches every rank with `--resume auto` from
the last committed checkpoint.

    python -m mgproto_tpu_torch.cli.train --train_dir ... --test_dir ... --push_dir ...
    torchrun --nproc_per_node 2 -m mgproto_tpu_torch.cli.train --distributed ...
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
from types import SimpleNamespace
from typing import Optional, Tuple, Union

import numpy as np
import torch

from mgproto_tpu_torch.cli.common import (
    add_train_args,
    config_from_args,
    describe,
    maybe_init_distributed,
)
from mgproto_tpu_torch.config import Config
from mgproto_tpu_torch.core.mgproto import prune_top_m
from mgproto_tpu_torch.core.state import TrainState
from mgproto_tpu_torch.data import build_pipelines
from mgproto_tpu_torch.engine.evaluate import evaluate, evaluate_with_ood
from mgproto_tpu_torch.engine.push import provenance_dict, push_prototypes, render_prototypes
from mgproto_tpu_torch.obs.flightrec import FlightRecorder, set_recorder
from mgproto_tpu_torch.parallel import multihost
from mgproto_tpu_torch.parallel.mesh import leave_process_group, world
from mgproto_tpu_torch.parallel.multihost import is_primary_host
from mgproto_tpu_torch.parallel.trainer import ShardedTrainer
from mgproto_tpu_torch.perf.precision import policy_meta
from mgproto_tpu_torch.resilience import chaos as chaos_mod
from mgproto_tpu_torch.resilience import metrics as res_metrics
from mgproto_tpu_torch.resilience import preemption
from mgproto_tpu_torch.resilience.guard import DivergenceError, EpochGuard
from mgproto_tpu_torch.telemetry import make_session, trace_span
from mgproto_tpu_torch.utils.checkpoint import (
    adopt_checkpoint_train_config,
    apply_retention,
    checkpoint_name,
    find_latest_checkpoint,
    load_metadata,
    save_state_w_condition,
)
from mgproto_tpu_torch.utils.log import Logger, MetricsWriter, profiler_trace, timed_span


def _labeled(loader):
    """(images, labels, ids) loader batches -> (images, labels) eval batches;
    the ids are host bookkeeping."""
    for batch in loader:
        yield batch[0], batch[1]


def _test(trainer, state, test_loader, ood_loaders, log, score_rule="sum"):
    if ood_loaders:
        return evaluate_with_ood(trainer, state, _labeled(test_loader),
                                 [_labeled(o) for o in ood_loaders], score_rule=score_rule,
                                 log=log)
    return evaluate(trainer, state, _labeled(test_loader), log=log)


def _restore(trainer, state, path, log):
    """`state` restored from `path` (`trainer.restore`); returns (state, the
    epoch to run, the batches of it already applied, that epoch's gates or
    None)."""
    meta = load_metadata(path) or {}
    state = trainer.restore(path, state)
    if meta.get("stage") == "preempt":
        # a mid-epoch resume: the same epoch, its applied batches skipped
        # (the loader's order is deterministic), under the gates the epoch
        # began with (the bank may have filled since)
        epoch, skip = int(meta.get("epoch", 0)), int(meta.get("batch_in_epoch", 0))
        log(f"resumed preempted {path} -> epoch {epoch} (skipping {skip} completed batches)")
        return state, epoch, skip, meta.get("epoch_flags")
    epoch = int(meta.get("epoch", -1)) + 1
    log(f"resumed {path} -> epoch {epoch}")
    return state, epoch, 0, None


def run_training(
    cfg: Config,
    resume: str = "",
    keep_last: int = 0,
    device: Union[str, torch.device, None] = None,
    render_push: bool = True,
    target_accu: float = 0.0,
    max_bad_steps: int = 3,
    divergence_check_every: int = 8,
    max_rollbacks: int = 2,
    keep_best: int = 1,
    chaos: Optional[chaos_mod.ChaosState] = None,
    ckpt_format: str = "auto",
    barrier_timeout_s: float = 300.0,
    telemetry_dir: str = "",
    telemetry: bool = True,
    auto_tune: bool = False,
    profile_dir: str = "",
    profile_steps: str = "",
    profile_on_anomaly: bool = False,
    profile_out: str = "",
) -> Tuple[TrainState, float]:
    """Run the whole schedule of `cfg`; returns (final state, last test
    accuracy).

    `resume`: "" starts fresh; "auto" continues from the newest checkpoint
    in `cfg.model_dir` (fresh when there is none); a path continues from
    that checkpoint. The checkpoint's training settings are adopted first
    (`adopt_checkpoint_train_config`). Training restarts at the saved epoch
    + 1, so a `nopush` save at a push epoch skips that epoch's push, as in
    the JAX package; a `preempt` checkpoint re-enters its epoch after the
    batches it applied and clears PREEMPTED.json; a `prune` checkpoint
    means the run is complete and returns at once. A stage checkpoint is
    saved when its accuracy reaches `target_accu`. `keep_last` > 0 keeps
    only the newest `keep_last` checkpoints and the `keep_best` most
    accurate ones, after each epoch. `device`: CUDA unless the caller names
    another. `render_push`: draw 3 JPEGs per pushed prototype at each push
    epoch (the JAX default); False skips the pictures.

    Recovery: `max_bad_steps` consecutive non-finite steps (0 disables),
    polled every `divergence_check_every` steps, roll the run back to the
    newest checkpoint, at most `max_rollbacks` times (then the
    DivergenceError propagates). `chaos` (a `resilience.chaos.ChaosState`)
    injects the drills; its one-shot events do not fire again in a replay.
    A preemption (`resilience.preemption.get_handler()`) returns early
    after the `preempt` save.

    `ckpt_format`: "sharded", "replicated" or "auto" (sharded under
    several ranks). `barrier_timeout_s` > 0 arms the guarded barrier under
    several ranks: a lost peer raises `BarrierTimeoutError` out of here
    after the survivor wrote PEER_LOST.json and dumped the flight
    recorder (`main` exits 75 on it).

    `telemetry_dir` ("" = `model_dir/telemetry`) and `telemetry` (False
    writes none): the run's telemetry session (module docstring).
    `auto_tune`: plan the run's batch, remat, prefetch, augmentation and
    async bank with perf/planner.py `autotune` (on the card; a resume
    adopts the checkpoint's `autotune_plan`).

    `profile_dir`, `profile_steps`, `profile_on_anomaly`, `profile_out`:
    the observatory's trace and capture windows (module docstring)."""
    if ckpt_format not in ("auto", "sharded", "replicated"):
        raise ValueError(f"unknown ckpt_format {ckpt_format!r}")
    resume_path = None
    if resume == "auto":
        resume_path = find_latest_checkpoint(cfg.model_dir)
    elif resume:
        resume_path = resume
        if not os.path.exists(resume_path):
            raise FileNotFoundError(resume_path)
    adoption_notes: list = []
    if resume_path:
        # resume under the checkpoint's own training settings
        cfg = adopt_checkpoint_train_config(cfg, resume_path, log=adoption_notes.append)

    os.makedirs(cfg.model_dir, exist_ok=True)
    handler = preemption.get_handler()
    handler.reset()
    rank, nranks = world()
    primary = is_primary_host()
    if primary:
        # this incarnation owns the last one's failure marker: a stale one
        # would make a relaunching launcher loop
        with contextlib.suppress(OSError):
            os.unlink(os.path.join(cfg.model_dir, multihost.PEER_LOST_FILE))
    # run-wide files are rank 0's; the others log under host-tagged names
    host_tag = "" if primary else f".h{rank}"
    with contextlib.ExitStack() as stack:  # closes whatever was opened, on every path
        recorder = FlightRecorder(dump_dir=os.path.join(cfg.model_dir, "telemetry"))
        stack.callback(set_recorder, set_recorder(recorder))
        if chaos is not None:  # the checkpoint reads the process-active state
            stack.callback(chaos_mod.set_active, chaos_mod.set_active(chaos))
        log = Logger(os.path.join(cfg.model_dir, f"train.log{host_tag}"))
        stack.callback(log.close)
        for note in adoption_notes:
            log(note)
        metrics = MetricsWriter(os.path.join(cfg.model_dir, f"metrics.jsonl{host_tag}"))
        stack.callback(metrics.close)
        cfg, autotune_outcome, autotune_plan_meta = _autotune(cfg, auto_tune, resume_path,
                                                              nranks, device, log)
        log(describe(cfg))
        train_loader, push_loader, test_loader, ood_loaders = build_pipelines(cfg, device=device)
        for loader in (train_loader, push_loader, test_loader, *ood_loaders):
            stack.callback(loader.close)
        trainer = ShardedTrainer(cfg, len(train_loader), device=device)
        trainer.ckpt_sharded = {"auto": None, "sharded": True, "replicated": False}[ckpt_format]
        # before the restore, so restore-time events land in this run's registry
        telem = make_session(telemetry_dir or os.path.join(cfg.model_dir, "telemetry"), telemetry)
        if telem:
            stack.callback(telem.close)
            telem.monitor.watch(trainer.cold_paths.total)
        backend = (torch.distributed.get_backend() if torch.distributed.is_initialized()
                   else "none")
        log(f"device: {trainer.device}  steps/epoch: {trainer.steps_per_epoch}  "
            f"async_bank: {trainer.async_bank}  rank: {rank} of {nranks}  "
            f"mesh: {trainer.mesh.shape}  backend: {backend}")
        # a restore target reads no pretrained trunk
        state = trainer.init_state(cfg.seed, for_restore=bool(resume_path))
        start_epoch, skip, flags = 0, 0, None
        if resume_path:
            meta = load_metadata(resume_path) or {}
            if meta.get("stage") == "prune":
                state = trainer.restore(resume_path, state)
                log(f"run already complete ({resume_path}); nothing to resume")
                return state, float(meta.get("accuracy", 0.0))
            state, start_epoch, skip, flags = _restore(trainer, state, resume_path, log)
            if primary:
                preemption.clear_marker(cfg.model_dir)

        # what a restore must be built with (utils/checkpoint.py
        # `adopt_checkpoint_train_config`): the trunk's numerics, the aux
        # loss (proxies or none) and the EM stepping; beside them the whole
        # precision policy, what ran in which dtype
        run_meta = {"compute_dtype": cfg.model.compute_dtype, "arch": cfg.model.arch,
                    "aux_loss": cfg.loss.aux_loss,
                    "em_reference_stepping": cfg.em.reference_stepping,
                    "precision_policy": policy_meta(trainer.precision),
                    # the async bank pipeline, resolved (one-step-stale EM when on)
                    "async_bank": trainer.async_bank}
        if autotune_plan_meta is not None:
            # a `resume --auto_tune` adopts it instead of planning again
            run_meta["autotune_plan"] = autotune_plan_meta
        if telem:
            _write_telemetry_meta(telem, cfg, trainer, state, run_meta, autotune_outcome)
        window = None
        if profile_steps or profile_on_anomaly:
            from mgproto_tpu_torch.obs.profiler import ProfilerWindow, parse_step_range
            from mgproto_tpu_torch.obs.stall import step_costs

            base_out = profile_out or os.path.join(
                "evidence", f"trace_{os.path.basename(cfg.model_dir.rstrip(os.sep)) or 'run'}")
            window = ProfilerWindow(
                out_dir=base_out if primary else os.path.join(base_out, f"h{rank}"),
                steps=parse_step_range(profile_steps), on_anomaly=profile_on_anomaly,
                monitor=telem.monitor if telem else None,
                # the CPU's capture counts one step of this run's program
                cost_provider=lambda: step_costs(cfg, device=trainer.device),
                log=log, device=trainer.device)
            stack.callback(window.close)
        img_dir = os.path.join(cfg.model_dir, "img") if render_push else None
        if nranks > 1 and barrier_timeout_s and barrier_timeout_s > 0:
            # armed after every fallible set-up step; cleared on every path
            multihost.configure_barrier(cfg.model_dir, barrier_timeout_s)
            stack.callback(multihost.clear_barrier)
        try:
            accu = 0.0
            rollbacks = 0
            log("start training")
            epoch = start_epoch
            while epoch < cfg.schedule.num_train_epochs:
                guard = EpochGuard(max_bad_steps=max_bad_steps, check_every=divergence_check_every,
                                   chaos=chaos, preemption=handler, already_done=skip,
                                   multihost=nranks > 1)
                if flags is None:
                    flags = trainer.epoch_flags(state, epoch)
                try:
                    state, accu = _run_epoch(cfg, trainer, state, epoch, train_loader, test_loader,
                                             push_loader, ood_loaders, log, metrics, run_meta,
                                             img_dir, target_accu, guard, skip, flags, telem,
                                             window=window,
                                             profile_dir=(profile_dir if epoch == start_epoch
                                                          else ""))
                except DivergenceError as e:
                    rollbacks += 1
                    res_metrics.counter(res_metrics.ROLLBACKS).inc()
                    recorder.record("rollback", epoch=epoch, error=str(e))
                    dumped = recorder.maybe_dump("divergence_rollback")
                    if dumped:
                        log(f"flight recorder dumped to {dumped}")
                    if rollbacks > max_rollbacks:
                        log(f"rollback budget exhausted ({max_rollbacks}); giving up")
                        raise
                    last_good = find_latest_checkpoint(cfg.model_dir)
                    if last_good is None:
                        raise RuntimeError(f"{e}; no checkpoint to roll back to: adjust the config "
                                           "(lower lr, check the data) and restart") from e
                    log(f"{e}; rolling back to {last_good} ({rollbacks}/{max_rollbacks})")
                    trainer.reset_bank_pipeline()  # the held bank phase belongs to the lost state
                    state, epoch, skip, flags = _restore(trainer, state, last_good, log)
                    continue
                if guard.preempted:
                    # the step in flight finished in train_epoch: save the whole
                    # state with its position in the epoch, unconditionally
                    meta = {**run_meta, "epoch": epoch, "stage": "preempt", "accuracy": accu,
                            "batch_in_epoch": guard.batches_done, "reason": handler.reason or "",
                            "epoch_flags": flags}
                    path = trainer.save(cfg.model_dir, state,
                                        checkpoint_name(epoch, "preempt", max(accu, 0.0)),
                                        metadata=meta)
                    res_metrics.counter(res_metrics.PREEMPTION_SAVES).inc()
                    if primary:
                        preemption.write_marker(cfg.model_dir, path, reason=handler.reason or "",
                                                extra={"epoch": epoch,
                                                       "batch_in_epoch": guard.batches_done})
                    if telem:
                        telem.flush(step=state.step, extra={"event": "preemption"})
                    recorder.record("preemption", epoch=epoch, batch=guard.batches_done,
                                    reason=handler.reason or "")
                    recorder.maybe_dump("preemption")
                    log(f"preempted ({handler.reason}); saved {path} at epoch {epoch} batch "
                        f"{guard.batches_done}; resume with --resume auto")
                    return state, accu
                skip, flags = 0, None
                if telem:  # collectives under a mesh: every rank
                    telem.end_epoch(_health_view(trainer, state), epoch=epoch, step=state.step)
                if keep_last > 0 and primary:
                    apply_retention(cfg.model_dir, keep_last, keep_best)
                epoch += 1

            last_epoch = max(cfg.schedule.num_train_epochs - 1, start_epoch)
            top_m = min(cfg.schedule.prune_top_m, cfg.model.prototypes_per_class)
            state.gmm = prune_top_m(state.gmm, top_m, renormalize=cfg.schedule.prune_renormalize)
            with timed_span(log, "prune test") as span:
                accu, test_results = _test(trainer, state, test_loader, ood_loaders, log)
            metrics.write(state.step, {"epoch": last_epoch, "stage": "prune", "test_s": span["s"],
                                       **test_results})
            save_state_w_condition(cfg.model_dir, state, last_epoch, "prune", accu, target_accu,
                                   metadata=run_meta, save=trainer.save)
            log("training done")
            return state, accu
        except BaseException as e:
            if isinstance(e, Exception) and not isinstance(e, multihost.BarrierTimeoutError):
                # a collective's error: a lost peer, when the ranks cannot all
                # meet at the failure agreement's barrier
                lost = multihost.agree_on_failure(e)
                if lost is not None:
                    log(f"peer lost: {lost}")
                    raise lost from e
            if not isinstance(e, multihost.BarrierTimeoutError):
                recorder.maybe_dump("crash")
            raise


def _autotune(cfg, auto_tune, resume_path, nranks, device, log):
    """(cfg, PlanOutcome or None, the plan's meta or None): the planner's
    plan applied to `cfg` when `auto_tune`; a resumed run adopts its
    checkpoint's `autotune_plan` verbatim (the budget may have changed
    since, and another batch would move the mid-epoch resume's skip)."""
    if not auto_tune:
        return cfg, None, None
    from mgproto_tpu_torch.perf.planner import PlanCandidate, apply_plan, autotune

    saved = (load_metadata(resume_path) or {}).get("autotune_plan") if resume_path else None
    if saved:
        cand = PlanCandidate(batch=max(int(saved["batch"]) // max(nranks, 1), 1),
                             remat_stages=tuple(saved.get("remat_stages", ())),
                             prefetch_depth=int(saved.get("prefetch_depth", 0)),
                             device_augment=bool(saved.get("device_augment", False)),
                             async_bank=bool(saved.get("async_bank", False)))
        log(f"autotune: resume adopts checkpointed plan {saved.get('name', '?')} "
            "(no re-planning)")
        return apply_plan(cfg, cand), None, saved
    cfg, outcome = autotune(cfg, log=log, device=device)
    if outcome.chosen is None:
        log("autotune: NO candidate plan fits the budget; keeping the hand-set config (see "
            "telemetry meta for the rejections)")
        return cfg, outcome, None
    log(f"autotune: running {outcome.chosen.candidate.name}")
    return cfg, outcome, outcome.chosen.to_meta()


def _write_telemetry_meta(telem, cfg, trainer, state, run_meta, autotune_outcome):
    """meta.json's run context and the per-rank state bytes (shape math)."""
    from mgproto_tpu_torch.perf.planner import state_bytes_per_chip

    per_chip = state_bytes_per_chip(cfg, trainer.mesh.model)
    telem.observe_state_bytes(per_chip)
    telem.write_meta({
        **per_chip, **run_meta,
        "fused_epilogue": any(getattr(m, "fused_epilogue", False)
                              for m in state.model.modules()),
        "prefetch_depth": cfg.data.prefetch_depth,
        "em_max_active_classes": trainer.em_cfg.max_active_classes,
        "remat": cfg.model.remat,
        "remat_stages": list(cfg.model.remat_stages),
        "device_augment": trainer.device_augment,
        "wire_dtype": "uint8" if trainer.device_augment else "float32",
        "worker_backend": cfg.data.worker_backend,
    })
    if autotune_outcome is not None:
        telem.observe_autotune(autotune_outcome)


def _health_view(trainer, state):
    """The GMM and the bank with every class, for ModelHealth (gathers
    under a mesh that splits the classes: every rank calls)."""
    mesh = trainer._class_mesh
    if mesh is None:
        return state
    from mgproto_tpu_torch.core.memory import Memory
    from mgproto_tpu_torch.parallel.sharding import gather_classes, gather_gmm

    c = trainer.cfg.model.num_classes
    return SimpleNamespace(gmm=gather_gmm(state.gmm, mesh, c),
                           memory=Memory(*(gather_classes(t, mesh, c) for t in state.memory)))


def _run_epoch(cfg, trainer, state, epoch, train_loader, test_loader, push_loader,
               ood_loaders, log, metrics, run_meta, img_dir, target_accu, guard, skip, flags,
               telem=None, window=None, profile_dir=""):
    """One epoch, under an `epoch` tracing span: train under the epoch's
    gates `flags` (the first `skip` batches dropped; each step observed by
    `telem`'s monitor and `window`; the training traced into `profile_dir`
    when set), test, the `nopush` save, and at a push epoch the
    push, its provenance, the render into `img_dir` (unless None), a test
    and the `push` save. A preempted epoch returns after training, with no
    test pass: the caller saves it."""
    with trace_span("epoch", epoch=epoch):
        log(f"epoch: \t{epoch}")
        log(f"use mining: \t{flags['use_mine']}")
        log(f"update GMM: \t{flags['update_gmm']}")

        train_loader.epoch = epoch  # the (seed, epoch) streams of this epoch
        batches = train_loader if not skip else itertools.islice(iter(train_loader), skip, None)
        held = (window.held("the --profile_dir trace of the first epoch is open")
                if profile_dir and window is not None else contextlib.nullcontext())
        with timed_span(log, "train") as train_span, \
                profiler_trace(profile_dir, trainer.device), held:
            state, last = trainer.train_epoch(state, batches, epoch, guard=guard, flags=flags,
                                              monitor=telem.monitor if telem else None,
                                              window=window)
        if last is not None:
            m = {k: (v.item() if isinstance(v, torch.Tensor) else v)
                 for k, v in last._asdict().items()}
            if telem:  # the epoch's widest EM call and its fallbacks
                telem.observe_em(float(m["em_active"]), float(m["em_compact_fallback"]))
            if not np.isfinite(m["loss"]):
                # the guard has not rolled back yet (its streak is below the
                # limit): the update was skipped in the step
                log(f"\tnon-finite loss at step {state.step}: update skipped (divergence guard)")
            log("\tloss: {loss:.4f}  ce: {cross_entropy:.4f}  mine: {mine:.4f}  aux: {aux:.4f}"
                "  acc: {accuracy:.4f}  mem: {full_mem_ratio:.3f}".format(**m))
            metrics.write(state.step, {"epoch": epoch, "train_s": train_span["s"],
                                       **{k: float(v) for k, v in m.items()}})
        if guard.preempted:
            return state, 0.0

        with timed_span(log, "test") as span:
            accu, test_results = _test(trainer, state, test_loader, ood_loaders, log)
        metrics.write(state.step, {"epoch": epoch, "test_s": span["s"], **test_results})
        save_state_w_condition(cfg.model_dir, state, epoch, "nopush", accu, target_accu,
                               metadata=run_meta, save=trainer.save)

        if epoch in cfg.schedule.push_epochs():
            with timed_span(log, "push") as span:
                state, push_result = push_prototypes(trainer, state, push_loader)
            primary = is_primary_host()
            if primary:
                with open(os.path.join(cfg.model_dir, "push_provenance.json"), "w") as f:
                    json.dump({"epoch": epoch, **provenance_dict(push_result)}, f)
            log(f"\tpushed: \t{int(push_result.pushed.sum())} of {push_result.pushed.size}")
            render = {}
            if img_dir is not None:
                push_ds = push_loader.dataset
                gmm = trainer.full_gmm(state)  # a collective under a mesh: every rank
                # push_prototypes(save_dir=img_dir, ...) in one call, split here
                # so the render has its own span; rank 0 draws, every rank lends
                # it the whole parameters (a collective too)
                with trainer.full_params(state), timed_span(log, "push render") as render_span:
                    if primary:
                        render_prototypes(trainer, state, push_result,
                                          lambda i: push_ds.load(i)[0], img_dir, epoch, gmm=gmm)
                render = {"render_s": render_span["s"]}
            accu, test_results = _test(trainer, state, test_loader, ood_loaders, log)
            metrics.write(state.step, {"epoch": epoch, "stage": "push", "push_s": span["s"],
                                       **render, "pushed": int(push_result.pushed.sum()),
                                       **test_results})
            save_state_w_condition(cfg.model_dir, state, epoch, "push", accu, target_accu,
                                   metadata=run_meta, save=trainer.save)
        return state, accu


CHAOS_ENV_HELP = """\
chaos drills (environment; all off by default):
  MGPROTO_CHAOS_NAN_AT_STEP     NaN inputs at this global step
  MGPROTO_CHAOS_PREEMPT_AT_STEP a simulated SIGTERM at this global step
  MGPROTO_CHAOS_CKPT_FAILS      fail the first N checkpoint saves (each retried)
  MGPROTO_CHAOS_KILL_HOST_AT    this rank dies hard (exit 86) when the batch of
                                this global step is drawn (the survivors exit 75)
  MGPROTO_CHAOS_WEDGE_HOST_AT   the same, but the rank hangs
  MGPROTO_CHAOS_HOST_INDEX      restrict the kill and the wedge to this rank
                                (-1: any rank whose environment carries them)
  MGPROTO_BARRIER_SESSION       this incarnation's guarded-barrier namespace
                                (default: rank 0's clock, broadcast)
the serving knobs (MGPROTO_CHAOS_SEED, MGPROTO_CHAOS_SERVE_*,
MGPROTO_CHAOS_TENANT_STORM_AT and _BAD_SWAP) are read by cli.serve; the
JAX package's loader knobs and MGPROTO_CHAOS_SLOW_HOST_MS are refused (not
ported)
"""


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(
        description="Train MGProto on PyTorch (the reference main.py)",
        epilog=CHAOS_ENV_HELP, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_train_args(p)
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    maybe_init_distributed(args)
    plan = chaos_mod.plan_from_env()
    # graceful preemption: SIGTERM/SIGINT finish the step in flight,
    # checkpoint, and exit 0
    if not args.no_preempt_handlers:
        preemption.install_handlers()
    try:
        run_training(
            cfg, resume=args.resume, keep_last=args.keep_last, device=args.device,
            target_accu=args.target_accu, max_bad_steps=args.max_bad_steps,
            divergence_check_every=args.divergence_check_every,
            max_rollbacks=args.max_rollbacks, keep_best=args.keep_best,
            chaos=chaos_mod.ChaosState(plan) if plan else None,
            ckpt_format=args.ckpt_format, barrier_timeout_s=args.barrier_timeout_s,
            telemetry_dir=args.telemetry_dir, telemetry=not args.no_telemetry,
            auto_tune=args.auto_tune, profile_dir=args.profile_dir,
            profile_steps=args.profile_steps, profile_on_anomaly=args.profile_on_anomaly,
            profile_out=args.profile_out,
        )
    except multihost.BarrierTimeoutError as e:
        # the marker and the dump are on disk; exit hard with the status a
        # launcher relaunches on: leaving the process group would wait for
        # the peer that is gone
        sys.stderr.write(f"peer lost: {e}\n")
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(multihost.PEER_LOST_EXIT_CODE)
    finally:
        leave_process_group()
    # a preempted run exits 0: the checkpoint and the marker let the next
    # run resume


if __name__ == "__main__":
    main()
