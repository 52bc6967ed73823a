"""Serve an artifact or a checkpoint with calibrated trust gating
(counterpart of mgproto_tpu/cli/serve.py).

Two faces over the `serving` package:

  * BATCH/STDIN (default): answer --images npy/npz batches and --stdin
    JSONL requests ({"id": ..., "image": nested lists} per line), one JSON
    response line each, then a summary line. `--replicas N` serves the
    batch through the replica plane (`drive_batch_plane`); `--swap
    NEW.mgproto` makes a blue/green hot swap halfway through the batch
    (fail-closed: an unverifiable artifact is refused, the old model keeps
    serving; the report prints as its own JSON line).
  * NETWORK (`--listen HOST:PORT`): the asyncio HTTP frontend
    (serving/frontend.py) over `--replicas N` supervised engines:
    POST /v1/predict, /healthz, /readyz, /metrics, POST /admin/swap,
    GET /admin/autoscale. `--autoscale MIN:MAX` lets the autoscaler
    (serving/autoscale.py) grow and shrink the fleet on the frontend's
    pump every `--autoscale_interval_s`; `--replicas` is then the starting
    size, clamped into the bounds.

Both drain gracefully: SIGTERM/SIGINT (resilience/preemption.py
`install_handlers`) stops admission, and every queued or in-flight request
is answered or shed typed before the process exits 0.

    python -m mgproto_tpu_torch.cli.serve --artifact model.mgproto --images batch.npy
    python -m mgproto_tpu_torch.cli.serve --artifact model.mgproto --stdin < requests.jsonl
    python -m mgproto_tpu_torch.cli.serve --artifact model.mgproto --listen 127.0.0.1:8000 \
        --replicas 2
    python -m mgproto_tpu_torch.cli.serve --checkpoint auto --model_dir runs/r1 --calibrate \
        --test_dir ... --images batch.npy

Replicas share one card in one process: the artifact (or the restored
checkpoint and its calibration) loads once, and every engine the factory
builds (each replica, each restart) serves that one model with its own
buckets, queue and breaker.

The summary line keeps the JAX keys. `warmup_compiles` is the count of
buckets warmed (a JAX warmup compiles each bucket once; here each bucket
runs once, paying its first-launch costs), and `steady_state_recompiles`
counts dispatches after warmup at a bucket that was not warmed (first-launch
work on a request's path), which must be 0. The checkpoint face adds
`state_digest` (utils/checkpoint.py), the identity of the state it serves.

Online learning (`--online`, the batch faces of the checkpoint face with
`--calibrate`): the trusted-capture tap (online/capture.py, gated at the
calibration's `--online_capture_percentile`, `--online_capture_capacity`
a class) stages high-p(x) predictions, and a Consolidator (online/
consolidate.py) over the restored state ticks on the pump every
`--online_cadence_s` and once more after the batch drains; the summary
line's `online` block reports both. Refused on `--artifact` (an artifact
holds no bank to consolidate into) and with `--listen` (the network face's
pump does not tick the cadence), as in the JAX package.

`start_split` on the summary line splits the process's start into its
parts, in seconds from `time.perf_counter` marks: `import` (this module,
torch and the port's serving modules), `cuda_context`, `kernel_load` (the
kernel libraries: built by the first process, loaded from
build/torch_kernels/ after), `artifact_read` and `model_build` (the
artifact face; the checkpoint face has `state_build` and `checkpoint_read`),
and `warmup` (every bucket once, cuDNN's algorithm choice included).

Telemetry: `--telemetry_dir DIR` (no default directory: a serve run has
no model_dir of its own) writes a telemetry session there
(telemetry/session.py) with the serving family pre-registered, each
dispatch observed by its engine's StepMonitor, and the flight recorder's
`replica_<dead|wedged>` dumps. `--auto_tune` plans the buckets before
warmup (perf/planner.py `plan_serve_buckets`: one dispatch at each bucket
on the card, plus the artifact's resident weight bytes, its quant_config's
`total_weight_bytes` when it carries one) and fails closed when none
fits; the plane faces also plan every engine a restart or a scale-up
builds (serving/autoscale.py `hbm_bucket_prep`).

The serving chaos drills read the environment (resilience/chaos.py
`plan_from_env`, installed before anything is served): the
MGPROTO_CHAOS_SERVE_* and MGPROTO_CHAOS_TENANT_* knobs, seeded by
MGPROTO_CHAOS_SEED.

The observatory (obs/): `--trace_requests` turns request tracing on
(obs/reqtrace.py, into the telemetry session's tracer when one is open):
frontend, batcher, replica and engine spans per request on the plane's
clock, the `serving_stage_seconds` histogram, and a `timings` block on
every response. `--profile_warmup DIR` captures the warmup
(obs/profiler.py `profile_block`, reason `serve_warmup`): a device trace
on the card; on the CPU (--device cpu) the counted cost of one dispatch a
warmed bucket (`ServingEngine.warmup_costs`) as the capture's
cost_analysis.json.

Refused (cli/common.py `SERVE_REFUSED`, with its ROADMAP item):
`--aot-cache`; the training flags of `REFUSED` too.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()  # the start split's first mark; None after the first main

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional, Tuple  # noqa: E402

import numpy as np  # noqa: E402

from mgproto_tpu_torch.cli.common import (  # noqa: E402
    SERVE_REFUSED,
    SINGLE_PROCESS_REFUSED,
    add_train_args,
    check_ported,
    config_from_args,
)
from mgproto_tpu_torch.serving import metrics as _m  # noqa: E402


class StartSplit:
    """Seconds of a process's start by part, from `time.perf_counter`
    marks: each `mark(part)` closes the interval since the previous one."""

    def __init__(self, t0: float):
        self._last = t0
        self.parts: Dict[str, float] = {}

    def mark(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self._last
        self._last = now


def _weight_bytes(meta, model, proxies) -> int:
    """The served weights' resident bytes for the planner: the artifact's
    quant_config `total_weight_bytes` when it carries one, else the float
    model's (perf/quant.py `resident_weight_bytes`)."""
    qmeta = (meta or {}).get("quant_config") or {}
    if qmeta.get("total_weight_bytes"):
        return int(qmeta["total_weight_bytes"])
    from mgproto_tpu_torch.perf.quant import resident_weight_bytes

    return resident_weight_bytes(model, proxies)


def _start_device(args, split: StartSplit) -> None:
    """Import torch and the port's serving modules, then (on CUDA) create
    the context and load the libraries of the kernels this face launches
    (the missing ones built first, one nvcc each, all at once), each a mark
    of `split`."""
    import torch

    import mgproto_tpu_torch.engine.export  # noqa: F401
    import mgproto_tpu_torch.serving.engine  # noqa: F401
    from mgproto_tpu_torch.numerics import resolve_device

    split.mark("import")
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        return
    torch.cuda.init()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    split.mark("cuda_context")
    from mgproto_tpu_torch.ops import _build

    names = _build.ONLINE_KERNELS if args.online else _build.SERVE_KERNELS
    _build.build_all(names)
    for name in names:
        _build.load(name)
    split.mark("kernel_load")


def _parse_buckets(raw: str):
    return tuple(int(b) for b in raw.split(",") if b.strip())


def _load_payloads(args) -> Tuple[list, List[str]]:
    """(payloads, ids) from --images npy/npz files and --stdin JSONL; a
    line that does not parse becomes a None payload (a typed reject)."""
    payloads, ids = [], []
    for path in args.images:
        arr = np.load(path, allow_pickle=False)
        if isinstance(arr, np.lib.npyio.NpzFile):
            arr = arr[arr.files[0]]
        if arr.ndim == 3:
            arr = arr[None]
        for i, row in enumerate(arr):
            payloads.append(row)
            ids.append(f"{os.path.basename(path)}[{i}]")
    if args.stdin:
        for lineno, line in enumerate(sys.stdin):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                payloads.append(rec["image"])
                ids.append(str(rec.get("id", f"stdin[{lineno}]")))
            except (ValueError, KeyError, TypeError):
                payloads.append(None)
                ids.append(f"stdin[{lineno}]")
    return payloads, ids


def _engine_kw(args):
    return dict(
        buckets=_parse_buckets(args.buckets),
        queue_capacity=args.queue_capacity,
        default_deadline_s=args.deadline_ms / 1000.0 if args.deadline_ms > 0 else None,
    )


def _with_percentile(calibration, percentile: Optional[float]):
    """The calibration at another operating point (`threshold_for`)."""
    if calibration is None or percentile is None:
        return calibration
    import dataclasses

    return dataclasses.replace(calibration, percentile=float(percentile),
                               threshold_log_px=calibration.threshold_for(percentile))


def make_engine_factory(args, split: Optional[StartSplit] = None) -> Callable:
    """An engine factory for the replica supervisor: each call builds an
    independent engine (buckets, queue, breaker) over state loaded exactly
    once here: the artifact, or the restored checkpoint and its calibration.
    The checkpoint face's factory carries `live_context` (trainer, state,
    calibration) for --online. `split` gets the load's marks."""
    from mgproto_tpu_torch.serving.engine import ServingEngine

    split = split or StartSplit(time.perf_counter())
    if args.artifact:
        from mgproto_tpu_torch.engine.export import load_artifact

        art = load_artifact(args.artifact, device=args.device, split=split.mark)
        art = art._replace(calibration=_with_percentile(art.calibration, args.percentile))

        def factory():
            return ServingEngine.from_loaded(art, allow_uncalibrated=args.allow_uncalibrated,
                                             explain=args.explain, source=args.artifact,
                                             **_engine_kw(args))

        factory.program = {}
        factory.weight_bytes = _weight_bytes(art.meta, art.evaluator.model, art.proxies)
        return factory

    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.engine.push import load_push_provenance
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.serving.calibration import calibrate_from_config
    from mgproto_tpu_torch.utils.checkpoint import (
        adopt_checkpoint_train_config,
        latest_checkpoint,
        restore_checkpoint,
        state_digest,
    )

    cfg = config_from_args(args)
    path = latest_checkpoint(cfg.model_dir) if args.checkpoint == "auto" else args.checkpoint
    if not path:
        raise FileNotFoundError(f"no checkpoint found in {cfg.model_dir}")
    cfg = adopt_checkpoint_train_config(cfg, path, log=print)
    trainer = Trainer(cfg, steps_per_epoch=1, device=args.device)
    target = trainer.init_state(cfg.seed, for_restore=True)
    split.mark("state_build")
    state = restore_checkpoint(path, target)
    split.mark("checkpoint_read")
    calib = None
    if args.calibrate:
        calib = calibrate_from_config(
            cfg, trainer, state, device=args.device,
            percentile=5.0 if args.percentile is None else args.percentile)
        split.mark("calibrate")
    elif not args.allow_uncalibrated:
        raise SystemExit("live serving without calibration: pass --calibrate (derives "
                         "thresholds from --test_dir) or --allow-uncalibrated (degraded "
                         "mode, no OoD abstention)")
    provenance = load_push_provenance(cfg.model_dir) if args.explain else None
    digest = state_digest(state)
    ev = Evaluator(state.model, state.gmm, cfg, device=args.device)

    def factory():
        return ServingEngine.from_live(ev, calibration=calib, explain=args.explain,
                                       explain_top=args.explain_top, provenance=provenance,
                                       **_engine_kw(args))

    factory.program = {"state_digest": digest}
    factory.weight_bytes = _weight_bytes(None, state.model, state.proxies)
    factory.live_context = (trainer, state, calib)
    return factory


def _swap_factory(args, path: str) -> Callable:
    """An engine factory for a swap target artifact with the fleet's serve
    knobs, `--percentile` among them. It loads the artifact at its first call, so an unreadable one
    is a typed `stage_failed` refusal, and shares it across the standbys."""
    from mgproto_tpu_torch.engine.export import load_artifact
    from mgproto_tpu_torch.serving.engine import ServingEngine

    loaded = []

    def factory():
        if not loaded:
            art = load_artifact(path, device=args.device)
            # the fleet's operating point holds across a swap, as at start
            loaded.append(art._replace(
                calibration=_with_percentile(art.calibration, args.percentile)))
        # a swap target must match the fleet's response contract: an
        # --explain fleet takes only artifacts with an explanation table
        return ServingEngine.from_loaded(loaded[0], allow_uncalibrated=args.allow_uncalibrated,
                                         explain=args.explain, source=path, **_engine_kw(args))

    return factory


# ----------------------------------------------------------------- online
def _setup_online(args, factory):
    """--online on a batch face: the capture tap installed and a
    Consolidator over the factory's live context (its own copy of the
    mixture, bank and mean-optimizer moments). Returns (capture,
    consolidator), or (None, None) with --online off. The artifact face
    has no live context and is refused, as is a face without a
    calibration (the capture gate is a calibrated percentile)."""
    if not args.online:
        return None, None
    ctx = getattr(factory, "live_context", None)
    if ctx is None:
        raise SystemExit("--online needs the live checkpoint face (--checkpoint + "
                         "--calibrate): an exported artifact carries no trainer or memory "
                         "bank to consolidate into")
    trainer, state, calib = ctx
    if calib is None:
        raise SystemExit("--online needs a calibration (--calibrate): the capture gate is a "
                         "calibrated p(x) percentile")
    from mgproto_tpu_torch.online import capture as capture_mod
    from mgproto_tpu_torch.online.capture import CaptureConfig, TrustedCapture
    from mgproto_tpu_torch.online.consolidate import Consolidator, ConsolidatorConfig
    from mgproto_tpu_torch.online.metrics import register_online_metrics
    from mgproto_tpu_torch.trust.metrics import register_trust_metrics

    register_online_metrics(_m.default_registry())
    register_trust_metrics(_m.default_registry())
    capture = TrustedCapture(calib, trainer.cfg.model.num_classes, CaptureConfig(
        percentile=args.online_capture_percentile,
        capacity_per_class=args.online_capture_capacity))
    capture_mod.install(capture)
    cons = Consolidator(trainer, state, capture,
                        ConsolidatorConfig(cadence_s=args.online_cadence_s))
    return capture, cons


def _online_summary(capture, cons, forced=False):
    """The summary line's online block (None with --online off). A batch
    face consolidates once more after the pump drains (`forced`)."""
    if capture is None:
        return None
    if forced and cons is not None and capture.staged_count():
        cons.ingest(capture.drain())
    block = {"capture": capture.stats()}
    if cons is not None:
        block["consolidation"] = {
            "runs": cons.runs,
            "samples": cons.samples_consolidated,
            "em_active_max": max((r.em_active_max for r in cons.reports), default=0),
        }
    return block


# ------------------------------------------------------------- batch faces
def drive_batch_engine(engine, payloads, ids, handler, on_pump=None) -> List:
    """The single-engine batch driver: `serve_all` with the preemption flag
    as its graceful stop; `on_pump` runs between pump iterations (the
    --online cadence tick)."""
    return engine.serve_all(payloads, request_ids=ids,
                            should_stop=handler.requested if handler is not None else None,
                            on_pump=on_pump)


def drive_batch_plane(replica_set, payloads, ids, handler, swap_at: Optional[int] = None,
                      swap_factory: Optional[Callable] = None,
                      require_calibrated: bool = True,
                      on_pump: Optional[Callable] = None) -> Tuple[List, List]:
    """The replica-plane batch driver: (responses in id order, swap
    reports). The swap fires before request `swap_at` is submitted; on the
    preemption flag the plane drains typed and the rest is shed typed.
    `on_pump` runs after each supervisor poll (the --online cadence tick)."""
    from mgproto_tpu_torch.serving.response import REASON_SHUTDOWN, shed_response
    from mgproto_tpu_torch.serving.swap import hot_swap

    order = {rid: i for i, rid in enumerate(ids)}
    responses, reports = [], []
    unsubmitted: List[str] = []
    for i, (payload, rid) in enumerate(zip(payloads, ids)):
        if handler is not None and handler.requested():
            unsubmitted = list(ids[i:])
            break
        if swap_at is not None and i == swap_at and swap_factory is not None:
            reports.append(hot_swap(replica_set, swap_factory,
                                    require_calibrated=require_calibrated))
        responses.extend(replica_set.submit(payload, request_id=rid))
        responses.extend(replica_set.poll())
        if on_pump is not None:
            on_pump()
    if handler is not None and handler.requested():
        responses.extend(replica_set.drain())
    else:
        responses.extend(replica_set.flush())
        # a replica that went down mid-batch may still hold queued requests
        # its heartbeat never got to reroute: answer them typed
        responses.extend(replica_set.shed_stranded())
    responses.extend(shed_response(rid, REASON_SHUTDOWN) for rid in unsubmitted)
    return sorted(responses, key=lambda r: order.get(r.request_id, len(order))), reports


def _summary_line(responses, compiled, steady, gate, readiness, extra=None):
    counts = {}
    for r in responses:
        counts[r.outcome] = counts.get(r.outcome, 0) + 1
    line = {
        "summary": True,
        "requests": len(responses),
        "outcomes": counts,
        "abstain_rate": gate.abstain_rate if gate is not None else None,
        "degraded": gate.degraded if gate is not None else None,
        "fingerprint_mismatch": gate.fingerprint_mismatch if gate is not None else None,
        "warmup_compiles": compiled,
        "steady_state_recompiles": steady,
        "readiness": readiness,
    }
    if extra:
        line.update(extra)
    print(json.dumps(line), flush=True)


def _apply_auto_tune(args, engine, weight_bytes: int) -> None:
    """--auto_tune: shrink the engine's buckets (and `args.buckets`, which
    later engines read) to what fits the budget, before any warmup; no
    fitting bucket fails closed. The outcome goes into the run's telemetry
    session (`args.telemetry_session`, when there is one)."""
    from mgproto_tpu_torch.perf.planner import plan_serve_buckets

    fitting, outcome = plan_serve_buckets(engine, weight_bytes=weight_bytes)
    print(json.dumps({"autotune": True, "buckets": list(fitting),
                      "rejected": outcome.rejected, "budget_bytes": outcome.budget_bytes}),
          flush=True)
    telem = getattr(args, "telemetry_session", None)
    if telem:
        telem.observe_autotune(outcome)
    if not fitting:
        # warming the rejected set would run the very out-of-memory error
        # the planner predicted; rerun without --auto_tune to override
        raise SystemExit(f"auto_tune: no warmup bucket fits the HBM budget "
                         f"({outcome.budget_bytes} bytes, margin {outcome.margin}); refusing "
                         "to warm an over-budget bucket set")
    if tuple(fitting) != engine.buckets:
        engine.buckets = tuple(fitting)
    args.buckets = ",".join(str(b) for b in fitting)


def _warmup_profile(args):
    """--profile_warmup's capture around the warmup (a no-op context when
    unset): a device trace on the card, the CPU's cost-only capture
    elsewhere (its cost report is written by `_write_warmup_costs` once
    the engines are warm)."""
    from mgproto_tpu_torch.obs.profiler import profile_block

    return profile_block(args.profile_warmup, reason="serve_warmup", device=args.device)


def _write_warmup_costs(capture_dir, engine, device) -> None:
    """The CPU's --profile_warmup capture: the counted cost of one dispatch
    a warmed bucket into the capture dir (on the card the device trace
    holds the warmup)."""
    from mgproto_tpu_torch.obs.profiler import COST_FILE, trace_supported

    if not capture_dir or engine is None or trace_supported(device):
        return
    with open(os.path.join(capture_dir, COST_FILE), "w") as f:
        json.dump(engine.warmup_costs(), f, indent=2, sort_keys=True)


def _first_engine(rs):
    return next((r.engine for r in rs.replicas if r.engine is not None), None)


def _main_batch_engine(args, handler, split: StartSplit) -> None:
    from mgproto_tpu_torch.online import capture as capture_mod
    from mgproto_tpu_torch.serving.health import HealthProbe

    factory = make_engine_factory(args, split)
    capture, cons = _setup_online(args, factory)
    try:
        engine = factory()
        if args.auto_tune:
            _apply_auto_tune(args, engine, factory.weight_bytes)
        with _warmup_profile(args) as capture_dir:
            compiled = len(engine.warmup())
            _write_warmup_costs(capture_dir, engine, args.device)
        split.mark("warmup")
        payloads, ids = _load_payloads(args)
        responses = drive_batch_engine(engine, payloads, ids, handler,
                                       on_pump=cons.tick if cons is not None else None)
        online = _online_summary(capture, cons, forced=True)
        for r in responses:
            print(json.dumps(r.to_dict()))
        extra = {"drained": handler.requested(), **factory.program,
                 "start_split": split.parts}
        if online is not None:
            extra["online"] = online
        _summary_line(responses, compiled, engine.check_cold_dispatches(), engine.gate,
                      HealthProbe(engine).readiness(), extra=extra)
    finally:
        if capture is not None:
            capture_mod.uninstall()


def _build_plane(args, factory):
    """The replica set of the plane faces. With --auto_tune a probe engine
    plans the buckets first, and every engine the set builds later plans
    its own (`hbm_bucket_prep`)."""
    from mgproto_tpu_torch.serving.batcher import BatcherConfig
    from mgproto_tpu_torch.serving.replica import ReplicaSet

    engine_prep = None
    if args.auto_tune:
        from mgproto_tpu_torch.serving.autoscale import hbm_bucket_prep

        _apply_auto_tune(args, factory(), factory.weight_bytes)
        engine_prep = hbm_bucket_prep(weight_bytes=factory.weight_bytes)
    return ReplicaSet(factory, replicas=args.replicas,
                      heartbeat_timeout_s=args.heartbeat_timeout_s,
                      batcher_config=BatcherConfig(max_linger_s=args.linger_ms / 1000.0),
                      engine_prep=engine_prep)


def _main_batch_plane(args, handler, split: StartSplit) -> None:
    from mgproto_tpu_torch.online import capture as capture_mod

    factory = make_engine_factory(args, split)
    capture, cons = _setup_online(args, factory)
    try:
        rs = _build_plane(args, factory)
        with _warmup_profile(args) as capture_dir:
            compiled = rs.start()
            _write_warmup_costs(capture_dir, _first_engine(rs), args.device)
        split.mark("warmup")
        payloads, ids = _load_payloads(args)
        swap_at = len(payloads) // 2 if args.swap else None
        responses, reports = drive_batch_plane(
            rs, payloads, ids, handler, swap_at=swap_at,
            swap_factory=_swap_factory(args, args.swap) if args.swap else None,
            require_calibrated=not args.allow_uncalibrated,
            on_pump=cons.tick if cons is not None else None)
        online = _online_summary(capture, cons, forced=True)
        for r in responses:
            print(json.dumps(r.to_dict()))
        for rep in reports:
            print(json.dumps({"swap": True, **rep.to_dict()}))
        first = next((r for r in rs.replicas if r.engine is not None), None)
        extra = {"replicas": len(rs.replicas), "replicas_ready": len(rs.ready_replicas()),
                 "swaps": [rep.to_dict() for rep in reports], "drained": handler.requested(),
                 **factory.program, "start_split": split.parts}
        if online is not None:
            extra["online"] = online
        _summary_line(
            responses, compiled, rs.steady_recompiles,
            first.engine.gate if first else None,
            first.probe.readiness() if first and first.probe else None, extra=extra)
    finally:
        if capture is not None:
            capture_mod.uninstall()


def _parse_autoscale(raw: str):
    """'MIN:MAX' -> (min, max), or None when unset."""
    if not raw:
        return None
    mn, _, mx = raw.partition(":")
    try:
        bounds = (int(mn), int(mx))
    except ValueError:
        raise SystemExit(f"--autoscale must be MIN:MAX, got {raw!r}") from None
    if bounds[0] < 1 or bounds[1] < bounds[0]:
        raise SystemExit(f"--autoscale needs 1 <= MIN <= MAX, got {raw!r}")
    return bounds


def _main_listen(args, handler, split: StartSplit) -> None:
    import asyncio

    from mgproto_tpu_torch.serving.frontend import Frontend

    host, _, port = args.listen.rpartition(":")
    if not host or not port:
        raise SystemExit(f"--listen must be HOST:PORT, got {args.listen!r}")
    bounds = _parse_autoscale(args.autoscale)
    if bounds is not None:
        # --replicas is the starting size, clamped into the bounds
        args.replicas = min(max(args.replicas, bounds[0]), bounds[1])
    factory = make_engine_factory(args, split)
    rs = _build_plane(args, factory)
    with _warmup_profile(args) as capture_dir:
        compiled = rs.start()
        _write_warmup_costs(capture_dir, _first_engine(rs), args.device)
    split.mark("warmup")
    autoscaler = None
    if bounds is not None:
        from mgproto_tpu_torch.serving.autoscale import Autoscaler, AutoscalerConfig

        autoscaler = Autoscaler(rs, AutoscalerConfig(min_replicas=bounds[0],
                                                     max_replicas=bounds[1],
                                                     interval_s=args.autoscale_interval_s))
    frontend = Frontend(rs, host=host, port=int(port), preemption_handler=handler,
                        swap_factory_builder=lambda path: _swap_factory(args, path),
                        require_calibrated_swap=not args.allow_uncalibrated,
                        autoscaler=autoscaler)

    async def _run():
        await frontend.start()
        print(json.dumps({"listening": True, "host": host, "port": frontend.port,
                          "replicas": args.replicas, "autoscale": args.autoscale or None,
                          "buckets": _parse_buckets(args.buckets),
                          "warmup_compiles": compiled, **factory.program,
                          "start_split": split.parts}), flush=True)
        await frontend.run_until_drained()

    started = time.monotonic()
    asyncio.run(_run())
    first = next((r for r in rs.replicas if r.engine is not None), None)
    decode = sorted(frontend.decode_s)
    print(json.dumps({
        "summary": True,
        "outcomes": frontend.outcomes,
        "requests": sum(frontend.outcomes.values()),
        "steady_state_recompiles": rs.steady_recompiles,
        "uptime_s": time.monotonic() - started,
        "degraded": first.engine.gate.degraded if first else None,
        "drained": True,
        "json_decode_s": {"count": len(decode),
                          "median": decode[len(decode) // 2] if decode else None,
                          "max": decode[-1] if decode else None},
    }), flush=True)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description="Serve an MGProto model with calibrated trust gating")
    add_train_args(p)
    p.add_argument("--artifact", default="",
                   help=".mgproto artifact to serve (else --checkpoint + model flags)")
    p.add_argument("--checkpoint", default="auto",
                   help="checkpoint path ('auto' = the latest in --model_dir); ignored with "
                        "--artifact")
    p.add_argument("--images", action="append", default=[],
                   help="npy/npz of [N,H,W,3] (or [H,W,3]) normalized float images (repeatable)")
    p.add_argument("--stdin", action="store_true",
                   help='also read JSONL requests from stdin: {"id": ..., "image": nested lists}')
    p.add_argument("--buckets", default="1,2,4,8",
                   help="batch-size buckets warmed before traffic (requests are padded up)")
    p.add_argument("--percentile", type=float, default=None,
                   help="abstention operating point (an ID log p(x) percentile the "
                        "calibration holds); default: the calibration's own")
    p.add_argument("--deadline_ms", type=float, default=0.0,
                   help="per-request deadline; expired requests are shed typed (0 = none)")
    p.add_argument("--queue_capacity", type=int, default=64,
                   help="admission queue bound (overflow sheds typed)")
    p.add_argument("--allow-uncalibrated", "--allow_uncalibrated", dest="allow_uncalibrated",
                   action="store_true",
                   help="serve WITHOUT calibration in degraded mode (classification only, "
                        "flagged per response)")
    p.add_argument("--calibrate", action="store_true",
                   help="checkpoint face: derive the calibration from the --test_dir loader "
                        "before serving")
    p.add_argument("--listen", default="",
                   help="HOST:PORT of the HTTP frontend; empty = the batch/stdin face")
    p.add_argument("--replicas", type=int, default=1,
                   help="supervised serving engines behind the frontend (or the batch plane)")
    p.add_argument("--swap", default="",
                   help="batch face: blue/green hot swap to this artifact halfway through the "
                        "batch (the network face swaps through POST /admin/swap)")
    p.add_argument("--linger_ms", type=float, default=20.0,
                   help="micro-batcher: the longest a deadline-less request waits for a "
                        "fuller batch")
    p.add_argument("--heartbeat_timeout_s", type=float, default=2.0,
                   help="replica heartbeat staleness before the supervisor drains and "
                        "restarts it")
    p.add_argument("--explain", action="store_true",
                   help="serve prototype explanations on predict outcomes (the artifact "
                        "face needs an --explain export)")
    p.add_argument("--explain_top", type=int, default=5,
                   help="checkpoint face: prototypes per explanation (the artifact face's "
                        "depth is the export's --explain_top)")
    p.add_argument("--aot-cache", "--aot_cache", dest="aot_cache", default="",
                   help="not ported (A7): refused")
    p.add_argument("--autoscale", default="",
                   help="network face: MIN:MAX replicas the autoscaler keeps the fleet "
                        "within (--replicas is the starting size)")
    p.add_argument("--autoscale_interval_s", type=float, default=0.25,
                   help="the autoscaler's decision cadence")
    p.add_argument("--trace_requests", action="store_true",
                   help="end-to-end request tracing: frontend, batcher, replica and engine "
                        "spans in the telemetry Chrome trace, serving_stage_seconds in "
                        "/metrics, and a 'timings' block on every response (obs/reqtrace.py; "
                        "no per-request cost when off)")
    p.add_argument("--profile_warmup", default="",
                   help="capture a profiler trace of the warmup into this dir (on the CPU: "
                        "the counted cost of one dispatch a bucket; obs/profiler.py)")
    p.add_argument("--online", action="store_true",
                   help="stage trusted high-p(x) predictions (calibrated capture gate) and "
                        "consolidate them into the memory banks via compact EM after the "
                        "batch drains; live-checkpoint batch faces only (online/capture.py, "
                        "online/consolidate.py)")
    p.add_argument("--online_capture_percentile", type=float, default=25.0,
                   help="calibration percentile a prediction's log p(x) must clear to be "
                        "captured")
    p.add_argument("--online_capture_capacity", type=int, default=64,
                   help="per-class staging reservoir bound")
    p.add_argument("--online_cadence_s", type=float, default=1.0,
                   help="consolidation cadence (poll-driven on the pump; never sleeps)")
    args = p.parse_args(argv)
    check_ported(args)
    check_ported(args, SERVE_REFUSED)
    check_ported(args, SINGLE_PROCESS_REFUSED)
    if args.online and args.listen:
        raise SystemExit("--online is wired into the batch faces (and the drift drill: "
                         "python -m mgproto_tpu_torch.cli.online drill); the network face's "
                         "pump does not tick the consolidation cadence yet")
    global _T_START
    # a process's first main counts from this module's import; another
    # call in the same process from its own start
    split = StartSplit(_T_START if _T_START is not None else time.perf_counter())
    _T_START = None
    _start_device(args, split)

    from mgproto_tpu_torch.resilience import chaos as chaos_mod
    from mgproto_tpu_torch.resilience.preemption import get_handler, install_handlers

    chaos_plan = chaos_mod.plan_from_env()
    prev_chaos = chaos_mod.set_active(
        chaos_mod.ChaosState(chaos_plan) if chaos_plan is not None else None)

    # graceful drain (both faces): the first SIGTERM/SIGINT sets the flag,
    # the drivers answer or shed everything typed and return
    uninstall = install_handlers()
    handler = get_handler()
    handler.reset()
    from mgproto_tpu_torch.obs import reqtrace
    from mgproto_tpu_torch.obs.flightrec import FlightRecorder, set_recorder
    from mgproto_tpu_torch.telemetry import make_session

    # no default directory: telemetry is on when --telemetry_dir names one
    telem = args.telemetry_session = make_session(args.telemetry_dir or "",
                                                  not args.no_telemetry)
    _m.register_serving_metrics(_m.default_registry())  # the session's, when there is one
    # a replica's death dumps the recorder where the telemetry goes
    prev_recorder = set_recorder(FlightRecorder(dump_dir=args.telemetry_dir or None))
    if args.trace_requests:
        # on the plane's production clock, into the session's tracer
        reqtrace.enable(tracer=telem.tracer if telem else None, include_timings=True)
    try:
        if args.listen:
            _main_listen(args, handler, split)
        elif args.replicas > 1 or args.swap:
            _main_batch_plane(args, handler, split)
        else:
            _main_batch_engine(args, handler, split)
        if telem:
            telem.flush()
    finally:
        if args.trace_requests:
            reqtrace.disable()
        set_recorder(prev_recorder)
        uninstall()
        chaos_mod.set_active(prev_chaos)
        if telem:
            telem.close()


if __name__ == "__main__":
    main()
