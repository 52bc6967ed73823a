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

The serving chaos drills read the environment (resilience/chaos.py
`plan_from_env`, installed before anything is served): the
MGPROTO_CHAOS_SERVE_* and MGPROTO_CHAOS_TENANT_{STORM_AT, BAD_SWAP} knobs,
seeded by MGPROTO_CHAOS_SEED.

Refused (cli/common.py `SERVE_REFUSED`, with their ROADMAP items):
`--aot-cache`, `--trace_requests`, `--profile_warmup` and `--online*`; the
training flags of `REFUSED` too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from mgproto_tpu_torch.cli.common import (
    SERVE_REFUSED,
    add_train_args,
    check_ported,
    config_from_args,
)
from mgproto_tpu_torch.serving import metrics as _m


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


def make_engine_factory(args) -> Callable:
    """An engine factory for the replica supervisor: each call builds an
    independent engine (buckets, queue, breaker) over state loaded exactly
    once here: the artifact, or the restored checkpoint and its calibration."""
    from mgproto_tpu_torch.serving.engine import ServingEngine

    if args.artifact:
        from mgproto_tpu_torch.engine.export import load_artifact

        art = load_artifact(args.artifact, device=args.device)
        art = art._replace(calibration=_with_percentile(art.calibration, args.percentile))

        def factory():
            return ServingEngine.from_loaded(art, allow_uncalibrated=args.allow_uncalibrated,
                                             explain=args.explain, source=args.artifact,
                                             **_engine_kw(args))

        factory.program = {}
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
    state = restore_checkpoint(path, trainer.init_state(cfg.seed, for_restore=True))
    calib = None
    if args.calibrate:
        calib = calibrate_from_config(
            cfg, trainer, state, device=args.device,
            percentile=5.0 if args.percentile is None else args.percentile)
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


# ------------------------------------------------------------- batch faces
def drive_batch_engine(engine, payloads, ids, handler) -> List:
    """The single-engine batch driver: `serve_all` with the preemption flag
    as its graceful stop."""
    return engine.serve_all(payloads, request_ids=ids,
                            should_stop=handler.requested if handler is not None else None)


def drive_batch_plane(replica_set, payloads, ids, handler, swap_at: Optional[int] = None,
                      swap_factory: Optional[Callable] = None,
                      require_calibrated: bool = True) -> Tuple[List, List]:
    """The replica-plane batch driver: (responses in id order, swap
    reports). The swap fires before request `swap_at` is submitted; on the
    preemption flag the plane drains typed and the rest is shed typed."""
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


def _main_batch_engine(args, handler) -> None:
    from mgproto_tpu_torch.serving.health import HealthProbe

    factory = make_engine_factory(args)
    engine = factory()
    compiled = len(engine.warmup())
    payloads, ids = _load_payloads(args)
    responses = drive_batch_engine(engine, payloads, ids, handler)
    for r in responses:
        print(json.dumps(r.to_dict()))
    _summary_line(responses, compiled, engine.check_cold_dispatches(), engine.gate,
                  HealthProbe(engine).readiness(),
                  extra={"drained": handler.requested(), **factory.program})


def _build_plane(args, factory):
    from mgproto_tpu_torch.serving.batcher import BatcherConfig
    from mgproto_tpu_torch.serving.replica import ReplicaSet

    return ReplicaSet(factory, replicas=args.replicas,
                      heartbeat_timeout_s=args.heartbeat_timeout_s,
                      batcher_config=BatcherConfig(max_linger_s=args.linger_ms / 1000.0))


def _main_batch_plane(args, handler) -> None:
    factory = make_engine_factory(args)
    rs = _build_plane(args, factory)
    compiled = rs.start()
    payloads, ids = _load_payloads(args)
    swap_at = len(payloads) // 2 if args.swap else None
    responses, reports = drive_batch_plane(
        rs, payloads, ids, handler, swap_at=swap_at,
        swap_factory=_swap_factory(args, args.swap) if args.swap else None,
        require_calibrated=not args.allow_uncalibrated)
    for r in responses:
        print(json.dumps(r.to_dict()))
    for rep in reports:
        print(json.dumps({"swap": True, **rep.to_dict()}))
    first = next((r for r in rs.replicas if r.engine is not None), None)
    _summary_line(
        responses, compiled, rs.steady_recompiles,
        first.engine.gate if first else None,
        first.probe.readiness() if first and first.probe else None,
        extra={"replicas": len(rs.replicas), "replicas_ready": len(rs.ready_replicas()),
               "swaps": [rep.to_dict() for rep in reports], "drained": handler.requested(),
               **factory.program})


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


def _main_listen(args, handler) -> None:
    import asyncio

    from mgproto_tpu_torch.serving.frontend import Frontend

    host, _, port = args.listen.rpartition(":")
    if not host or not port:
        raise SystemExit(f"--listen must be HOST:PORT, got {args.listen!r}")
    bounds = _parse_autoscale(args.autoscale)
    if bounds is not None:
        # --replicas is the starting size, clamped into the bounds
        args.replicas = min(max(args.replicas, bounds[0]), bounds[1])
    factory = make_engine_factory(args)
    rs = _build_plane(args, factory)
    compiled = rs.start()
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
                          "warmup_compiles": compiled, **factory.program}), flush=True)
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
    p.add_argument("--trace_requests", action="store_true", help="not ported (A9): refused")
    p.add_argument("--profile_warmup", default="", help="not ported (A9): refused")
    p.add_argument("--online", action="store_true", help="not ported (A9): refused")
    p.add_argument("--online_capture_percentile", type=float, default=25.0,
                   help="not ported (A9): the default only")
    p.add_argument("--online_capture_capacity", type=int, default=64,
                   help="not ported (A9): the default only")
    p.add_argument("--online_cadence_s", type=float, default=1.0,
                   help="not ported (A9): the default only")
    args = p.parse_args(argv)
    check_ported(args)
    check_ported(args, SERVE_REFUSED)

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
    _m.register_serving_metrics(_m.default_registry())
    try:
        if args.listen:
            _main_listen(args, handler)
        elif args.replicas > 1 or args.swap:
            _main_batch_plane(args, handler)
        else:
            _main_batch_engine(args, handler)
    finally:
        uninstall()
        chaos_mod.set_active(prev_chaos)


if __name__ == "__main__":
    main()
