"""The port's serving plane (mgproto_tpu_torch/serving/{batcher,health,
replica,swap,frontend}.py, admission's transfer operations and
cli/serve.py's batch drivers) against the JAX package's, on the CPU.

Every scenario of tests/test_serving_plane.py runs on BOTH packages, each
with its own real ServingEngine over a constant model (logits 0..C-1, log
p(x) 5.0, which a calibration's 5th percentile passes), one injected fake
clock, and a fresh metric registry. A scenario asserts what the JAX test
asserts and returns a trace: the dispatch triggers, and every response's
id, outcome and reason, in order (and counter values, readiness and swap
reports where the JAX test reads them). The two packages' traces must be
equal. The JAX test's chaos-driven kill and wedge are driven here through
the tests' own hooks (a replica's `alive` and `wedged` flags); the port
refuses the chaos environment knobs (resilience/chaos.py). The HTTP
frontend runs over loopback on both: predict, the probes, /metrics, 404,
408 on a stalled body, 400 on an oversized head, the drain on the
preemption flag and the swap endpoint; its statuses and bodies are traced
the same way. Last, the no-blocking-sleep lint's per-module checker
(scripts/check_no_blocking_sleep.py `_offending_calls`, loaded by its path)
runs over every module of mgproto_tpu_torch/serving/.
"""

import asyncio
import importlib.util
import ast
import json
import os
import time
import types

import numpy as np
import pytest

from mgproto_tpu.resilience import chaos as jchaos
from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu_torch.resilience import chaos as tchaos
from mgproto_tpu_torch.serving import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 8
NUM_CLASSES = 4
FINGERPRINT = "fp-test"
PKGS = ("jax", "torch")


def _modules(root):
    names = ("admission", "batcher", "calibration", "engine", "frontend", "health", "metrics",
             "replica", "response", "swap")
    ns = types.SimpleNamespace(name=root)
    for n in names:
        setattr(ns, n, __import__(f"{root}.serving.{n}", fromlist=[n]))
    ns.cli = __import__(f"{root}.cli.serve", fromlist=["serve"])
    return ns


MODS = {"jax": _modules("mgproto_tpu"), "torch": _modules("mgproto_tpu_torch")}


@pytest.fixture(autouse=True)
def fresh_registries():
    prev_t = tmetrics.set_current_registry(None)
    prev_j = jax_set_registry(JaxMetricRegistry())
    prev_c = jchaos.set_active(None)
    yield
    jchaos.set_active(prev_c)
    jax_set_registry(prev_j)
    tmetrics.set_current_registry(prev_t)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FlipHandler:
    """Preemption-handler stand-in whose flag raises after N checks."""

    def __init__(self, after):
        self.checks = 0
        self.after = after

    def requested(self):
        self.checks += 1
        return self.checks > self.after


def make_calibration(P, fingerprint=FINGERPRINT):
    rng = np.random.RandomState(0)
    return P.calibration.Calibration.from_scores(rng.randn(64) * 2.0 + 3.0,
                                                 rng.rand(64, NUM_CLASSES),
                                                 fingerprint=fingerprint)


def make_engine(P, clock, buckets=(1, 2, 4), capacity=8, calibrated=True, expected=FINGERPRINT,
                warm=True, **kw):
    """A real ServingEngine of package P over a constant model."""
    if P.name == "mgproto_tpu":
        import jax.numpy as jnp

        def infer(images):
            b = images.shape[0]
            return {"logits": jnp.tile(jnp.arange(NUM_CLASSES, dtype=jnp.float32), (b, 1)),
                    "log_px": jnp.full((b,), 5.0, jnp.float32)}
    else:
        def infer(images):
            b = images.shape[0]
            return {"logits": np.tile(np.arange(NUM_CLASSES, dtype=np.float32), (b, 1)),
                    "log_px": np.full((b,), 5.0, np.float32)}

    eng = P.engine.ServingEngine(
        infer, img_size=IMG, num_classes=NUM_CLASSES,
        calibration=make_calibration(P) if calibrated else None,
        expected_fingerprint=expected, buckets=buckets, queue_capacity=capacity, clock=clock,
        **kw)
    if warm:
        eng.warmup()
    return eng


def payload(seed=0):
    return np.random.RandomState(seed).rand(IMG, IMG, 3).astype(np.float32)


def typed(resps):
    return [(r.request_id, r.outcome, r.reason) for r in resps]


def make_set(P, clock, replicas=2, factory=None, **kw):
    factory = factory or (lambda: make_engine(P, clock, capacity=8))
    kw.setdefault("heartbeat_timeout_s", 0.5)
    kw.setdefault("restart_base_delay_s", 0.2)
    kw.setdefault("batcher_config", P.batcher.BatcherConfig(max_linger_s=0.01))
    return P.replica.ReplicaSet(factory, replicas=replicas, clock=clock, **kw)


# ------------------------------------------------------------ micro-batcher
def sc_bucket_full(P):
    clock = FakeClock()
    eng = make_engine(P, clock)
    b = P.batcher.MicroBatcher(eng, clock=clock)
    trace = []
    for i in range(3):
        eng.submit(payload(i), request_id=f"a{i}")
        trace.append(b.dispatch_due())
    eng.submit(payload(3), request_id="a3")
    trace.append(b.dispatch_due())
    assert trace[-1] == P.batcher.TRIGGER_BUCKET_FULL
    out = b.poll()
    assert [r.outcome for r in out] == ["predict"] * 4
    assert P.metrics.gauge(P.metrics.BATCH_FILL).value() == 1.0
    return trace + typed(out)


def sc_deadline_slack(P):
    clock = FakeClock()
    eng = make_engine(P, clock)
    b = P.batcher.MicroBatcher(eng, config=P.batcher.BatcherConfig(cost_prior_s=0.010,
                                                                   max_linger_s=10.0),
                               clock=clock)
    eng.submit(payload(), request_id="d0", deadline_s=0.100)
    trace = [b.dispatch_due()]
    clock.advance(0.085)
    trace.append(b.dispatch_due())
    clock.advance(0.006)
    trace.append(b.dispatch_due())
    assert trace == [None, None, P.batcher.TRIGGER_DEADLINE]
    return trace + typed(b.poll())


def sc_linger(P):
    clock = FakeClock()
    eng = make_engine(P, clock)
    b = P.batcher.MicroBatcher(eng, config=P.batcher.BatcherConfig(max_linger_s=0.02),
                               clock=clock)
    eng.submit(payload(), request_id="l0")
    trace = [b.dispatch_due()]
    clock.advance(0.021)
    trace.append(b.dispatch_due())
    assert trace == [None, P.batcher.TRIGGER_LINGER]
    return trace + typed(b.poll())


def sc_cost_ema(P):
    clock = FakeClock()
    eng = make_engine(P, clock, buckets=(1,))
    cfg = P.batcher.BatcherConfig(cost_prior_s=0.005, cost_ema_alpha=0.5, max_linger_s=0.0)
    b = P.batcher.MicroBatcher(eng, config=cfg, clock=clock,
                               pre_dispatch=lambda: clock.advance(0.001))
    eng.submit(payload(), request_id="e0")
    out = b.poll()
    assert b.dispatch_cost_s == pytest.approx(0.003)
    b2 = P.batcher.MicroBatcher(eng, config=cfg, clock=clock)
    eng.submit(payload(), request_id="e1")
    out += b2.poll()
    assert b2.dispatch_cost_s == pytest.approx(0.005)
    return [round(b.dispatch_cost_s, 12), round(b2.dispatch_cost_s, 12)] + typed(out)


def sc_flush(P):
    clock = FakeClock()
    eng = make_engine(P, clock)
    b = P.batcher.MicroBatcher(eng, config=P.batcher.BatcherConfig(max_linger_s=99.0),
                               clock=clock)
    for i in range(3):
        eng.submit(payload(i), request_id=f"f{i}")
    assert b.dispatch_due() is None
    out = b.flush()
    assert sorted(r.request_id for r in out) == ["f0", "f1", "f2"] and len(eng.queue) == 0
    return typed(out) + [P.metrics.counter(P.metrics.DISPATCHES).value(trigger="drain")]


def sc_dispatch_trigger_counter(P):
    clock = FakeClock()
    eng = make_engine(P, clock, buckets=(1, 2))
    b = P.batcher.MicroBatcher(eng, clock=clock)
    eng.submit(payload(0), request_id="t0")
    eng.submit(payload(1), request_id="t1")
    out = b.poll()
    n = P.metrics.counter(P.metrics.DISPATCHES).value(trigger="bucket_full")
    assert n == 1
    return typed(out) + [n]


# --------------------------------------------------- queue transfer, breaker
def sc_peek_drain_all_restore(P):
    clock = FakeClock()
    q = P.admission.AdmissionQueue(capacity=4, clock=clock)
    q.submit("p0", request_id="x0", deadline_s=1.0)
    clock.advance(0.5)
    q.submit("p1", request_id="x1", deadline_s=1.0)
    assert q.peek_oldest().request_id == "x0"
    moved = q.drain_all()
    assert [r.request_id for r in moved] == ["x0", "x1"]
    assert len(q) == 0 and q.peek_oldest() is None
    q2 = P.admission.AdmissionQueue(capacity=2, clock=clock)
    assert q2.restore(moved[0]) and q2.restore(moved[1])
    assert (q2.peek_oldest().enqueued_at, q2.peek_oldest().deadline) == (0.0, 1.0)
    assert not q2.restore(moved[0])
    return [r.request_id for r in moved]


def sc_breaker_open_seconds(P):
    clock = FakeClock()
    A = P.admission
    br = A.CircuitBreaker(failure_threshold=1, base_delay=4.0, clock=clock)
    trace = [br.open_seconds()]
    br.record_failure()
    clock.advance(3.0)
    trace += [br.open_seconds(), br.state]
    clock.advance(2.0)
    trace.append(br.allow())
    br.record_success()
    clock.advance(10.0)
    trace += [br.state, br.open_seconds()]
    assert trace == [0.0, 3.0, A.BREAKER_OPEN, True, A.BREAKER_CLOSED, 5.0]
    return trace


# ---------------------------------------------------------- readiness contract
def sc_readiness_flaps_with_breaker(P):
    clock = FakeClock()
    A = P.admission
    eng = make_engine(P, clock, warm=False,
                      breaker=A.CircuitBreaker(failure_threshold=2, base_delay=5.0, clock=clock))
    probe = P.health.HealthProbe(eng)

    def snap():
        r = probe.readiness()
        assert probe.liveness() == {"alive": True}
        return r["ready"], r["breaker_state"]

    trace = [snap()]
    eng.warmup()
    trace.append(snap())
    eng.breaker.record_failure()
    trace.append(snap())
    eng.breaker.record_failure()
    trace.append(snap())
    clock.advance(6.0)
    assert eng.breaker.allow()
    trace.append(snap())
    eng.breaker.record_success()
    trace.append(snap())
    eng.breaker.record_failure()
    eng.breaker.record_failure()
    clock.advance(6.0)
    eng.breaker.allow()
    eng.breaker.record_failure()
    trace.append(snap())
    assert trace == [(False, "closed"), (True, "closed"), (True, "closed"), (False, "open"),
                     (True, "half_open"), (True, "closed"), (False, "open")]
    return trace


def sc_readiness_false_while_draining(P):
    clock = FakeClock()
    eng = make_engine(P, clock)
    probe = P.health.HealthProbe(eng)
    assert probe.readiness()["ready"]
    eng.submit(payload(), request_id="d0")
    drained = eng.drain()
    r = probe.readiness()
    assert not r["ready"] and r["draining"]
    assert typed(drained) == [("d0", "shed", "shutdown")]
    return typed(drained) + [sorted(r)]


# ---------------------------------------------------------- replica supervisor
def sc_round_robin(P):
    clock = FakeClock()
    rs = make_set(P, clock)
    rs.start()
    for i in range(4):
        rs.submit(payload(i), request_id=f"rr{i}")
    depths = [len(rep.engine.queue) for rep in rs.replicas]
    assert depths == [2, 2]
    return depths


def sc_kill_reroutes_detects_and_restarts(P):
    clock = FakeClock()
    rs = make_set(P, clock)
    rs.start()
    responses = []
    for i in range(6):
        if i == 2:
            rs.replicas[0].alive = False  # the worker dies (the test's hook)
        responses.extend(rs.submit(payload(i), request_id=f"k{i}", deadline_s=5.0))
        responses.extend(rs.poll())
        clock.advance(0.05)
    dead = rs.replicas[0]
    clock.advance(1.0)
    responses.extend(rs.poll())
    trace = [dead.state]
    assert dead.state == P.replica.STATE_BACKOFF
    assert P.metrics.counter(P.metrics.REPLICA_RESTARTS).value(reason="dead") == 1
    clock.advance(0.05)
    responses.extend(rs.submit(payload(9), request_id="k9"))
    responses.extend(rs.poll())
    clock.advance(1.0)
    responses.extend(rs.poll())
    assert dead.state == P.replica.STATE_READY and dead.alive
    trace.append(dead.state)
    responses.extend(rs.flush())
    assert sorted(r.request_id for r in responses) == sorted([f"k{i}" for i in range(6)] + ["k9"])
    return trace + typed(responses)


def sc_wedged_reroutes_to_survivors(P):
    clock = FakeClock()
    rs = make_set(P, clock, batcher_config=P.batcher.BatcherConfig(max_linger_s=99.0))
    rs.start()
    for i in range(4):
        rs.submit(payload(i), request_id=f"w{i}", deadline_s=60.0)
    rs.replicas[0].wedged = True
    assert len(rs.replicas[0].engine.queue) == 2
    clock.advance(1.0)
    out = rs.poll()
    assert rs.replicas[0].state == P.replica.STATE_BACKOFF
    assert P.metrics.counter(P.metrics.REPLICA_RESTARTS).value(reason="wedged") == 1
    out += rs.flush()
    assert sorted(r.request_id for r in out) == [f"w{i}" for i in range(4)]
    assert all(r.outcome == "predict" for r in out)
    return typed(out)


def sc_default_breaker_shares_clock(P):
    clock = FakeClock()
    eng = make_engine(P, clock, warm=False)
    assert eng.breaker.clock is clock
    return [True]


def sc_shed_stranded(P):
    clock = FakeClock()
    rs = make_set(P, clock, batcher_config=P.batcher.BatcherConfig(max_linger_s=99.0))
    rs.start()
    for i in range(4):
        rs.submit(payload(i), request_id=f"s{i}", deadline_s=60.0)
    rs.replicas[0].alive = False
    out = rs.flush() + rs.shed_stranded()
    assert sorted(r.request_id for r in out) == [f"s{i}" for i in range(4)]
    shed = [r for r in out if r.outcome == "shed"]
    assert len(shed) == 2 and all(r.reason == "replica_lost" for r in shed)
    return typed(out)


def sc_all_down_sheds_no_replica(P):
    clock = FakeClock()
    rs = make_set(P, clock, replicas=1)
    rs.start()
    rs.replicas[0].alive = False
    out = rs.submit(payload(), request_id="n0")
    assert typed(out) == [("n0", "shed", P.response.REASON_NO_REPLICA)]
    assert P.metrics.counter(P.metrics.SHED).value(reason="no_replica") == 1
    return typed(out)


def sc_breaker_open_fleet_recovers(P):
    clock = FakeClock()
    rs = make_set(P, clock)
    rs.start()
    for rep in rs.replicas:
        for _ in range(rep.engine.breaker.failure_threshold):
            rep.engine.breaker.record_failure()
    out = rs.submit(payload(), request_id="starved")
    assert [r.reason for r in out] == ["no_replica"]
    rs.poll()
    assert not rs.ready_replicas()
    clock.advance(0.6)
    rs.poll()
    trace = [rep.engine.breaker.state for rep in rs.replicas]
    assert all(rep.routable() for rep in rs.replicas)
    rs.submit(payload(1), request_id="probe", deadline_s=5.0)
    out2 = rs.flush()
    assert typed(out2) == [("probe", "predict", None)]
    trace += [rep.engine.breaker.state for rep in rs.replicas]
    return trace + typed(out + out2)


def sc_failing_factory_backoff(P):
    clock = FakeClock()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("artifact gone")
        return make_engine(P, clock)

    rs = make_set(P, clock, replicas=1, factory=flaky, restart_base_delay_s=0.2)
    rs.start()
    rs.replicas[0].alive = False
    clock.advance(1.0)
    rs.poll()
    first_at = rs.replicas[0].restart_at
    clock.advance(0.3)
    rs.poll()
    rep = rs.replicas[0]
    assert rep.state == P.replica.STATE_BACKOFF
    assert rep.restart_at - clock() >= 0.4 - 1e-9 and rep.restart_at > first_at
    return [round(first_at, 9), round(rep.restart_at, 9), rep.restarts]


def sc_drain_answers_and_sheds(P):
    clock = FakeClock()
    rs = make_set(P, clock, batcher_config=P.batcher.BatcherConfig(max_linger_s=99.0))
    rs.start()
    for i in range(4):
        rs.submit(payload(i), request_id=f"g{i}")
    rs.replicas[0].wedged = True
    out = rs.drain()
    assert sorted(r.request_id for r in out) == [f"g{i}" for i in range(4)]
    assert sum(r.outcome == "shed" and r.reason == "shutdown" for r in out) == 2
    assert sum(r.outcome == "predict" for r in out) == 2
    assert not any(rep.routable() for rep in rs.replicas)
    return typed(out)


# ---------------------------------------------------------------- blue/green
def sc_verify_standby_reasons(P):
    clock = FakeClock()
    S = P.swap
    trace = [S.verify_standby(make_engine(P, clock, warm=False)),
             S.verify_standby(make_engine(P, clock, calibrated=False)),
             S.verify_standby(make_engine(P, clock, calibrated=False), require_calibrated=False),
             S.verify_standby(make_engine(P, clock, expected="other")),
             S.verify_standby(make_engine(P, clock))]
    assert trace == ["not_warmed", "uncalibrated", None, "fingerprint_mismatch", None]
    return trace


def sc_uncalibrated_swap_rejected(P):
    clock = FakeClock()
    rs = make_set(P, clock)
    rs.start()
    old = [rep.engine for rep in rs.replicas]
    report = P.swap.hot_swap(rs, lambda: make_engine(P, clock, calibrated=False))
    assert not report.ok and report.reason == "uncalibrated"
    assert [rep.engine for rep in rs.replicas] == old and all(r.routable() for r in rs.replicas)
    out = rs.submit(payload(), request_id="s0") + rs.flush()
    assert [r.outcome for r in out] == ["predict"]
    assert P.metrics.counter(P.metrics.SWAPS).value(result="rejected",
                                                    reason="uncalibrated") == 1
    return [report.to_dict()] + typed(out)


def sc_factory_error_is_stage_failed(P):
    clock = FakeClock()
    rs = make_set(P, clock)
    rs.start()

    def boom():
        raise OSError("no such artifact")

    report = P.swap.hot_swap(rs, boom)
    assert not report.ok and report.reason == "stage_failed" and "OSError" in report.detail
    return [report.to_dict()]


def sc_uncalibrated_artifact_error(P):
    clock = FakeClock()
    rs = make_set(P, clock)
    rs.start()

    def refuse():
        raise P.engine.UncalibratedArtifactError("no calibration.json")

    report = P.swap.hot_swap(rs, refuse)
    assert not report.ok and report.reason == "uncalibrated"
    return [report.to_dict()]


def sc_committed_swap_transfers(P):
    clock = FakeClock()
    rs = make_set(P, clock, batcher_config=P.batcher.BatcherConfig(max_linger_s=99.0))
    rs.start()
    for i in range(5):
        rs.submit(payload(i), request_id=f"t{i}", deadline_s=60.0)
    assert sum(len(rep.engine.queue) for rep in rs.replicas) == 5
    old = [rep.engine for rep in rs.replicas]
    report = P.swap.hot_swap(rs, lambda: make_engine(P, clock))
    assert report.ok and report.transferred == 5
    assert all(rep.engine is not o for rep, o in zip(rs.replicas, old))
    assert all(len(o.queue) == 0 for o in old)
    out = rs.flush()
    assert sorted(r.request_id for r in out) == [f"t{i}" for i in range(5)]
    assert all(r.outcome == "predict" for r in out)
    assert P.metrics.counter(P.metrics.SWAP_TRANSFERRED).value() == 5
    rs.replicas[0].alive = False
    clock.advance(1.0)
    rs.poll()
    clock.advance(1.0)
    rs.poll()
    assert rs.replicas[0].state == P.replica.STATE_READY
    return [report.to_dict()] + typed(out)


def sc_flip_covers_replica_lost(P):
    clock = FakeClock()
    rs = make_set(P, clock, batcher_config=P.batcher.BatcherConfig(max_linger_s=99.0))
    rs.start()
    green = lambda: make_engine(P, clock, capacity=8)  # noqa: E731
    standbys, rejection = P.swap.stage_fleet(len(rs.replicas), green)
    assert rejection is None and len(standbys) == 2
    r1 = rs.replicas[1]
    r1.engine = r1.batcher = r1.probe = None
    r1.state = P.replica.STATE_BACKOFF
    rs.submit(payload(), request_id="q0", deadline_s=60.0)
    report = P.swap.flip_fleet(rs, green, standbys)
    assert report.ok and report.replicas_swapped == 1 and report.transferred == 1
    out = rs.flush()
    assert typed(out) == [("q0", "predict", None)] and rs.engine_factory is green
    return [report.to_dict()] + typed(out)


def sc_stage_fleet_rejection(P):
    clock = FakeClock()
    standbys, rejection = P.swap.stage_fleet(2, lambda: make_engine(P, clock, calibrated=False))
    assert standbys == [] and not rejection.ok and rejection.reason == "uncalibrated"
    assert P.metrics.counter(P.metrics.SWAPS).value(result="rejected",
                                                    reason="uncalibrated") == 1
    return [rejection.to_dict()]


# ------------------------------------------------------- the batch drivers
def sc_batch_driver_sheds_on_flag(P):
    clock = FakeClock()
    eng = make_engine(P, clock)
    ids = [f"b{i}" for i in range(8)]
    out = P.cli.drive_batch_engine(eng, [payload(i) for i in range(8)], ids, FlipHandler(3))
    assert [r.request_id for r in out] == ids
    shed = [r for r in out if r.outcome == "shed"]
    assert shed and all(r.reason == "shutdown" for r in shed)
    return typed(out)


def sc_batch_driver_without_flag(P):
    clock = FakeClock()
    eng = make_engine(P, clock)
    ids = [f"c{i}" for i in range(5)]
    out = P.cli.drive_batch_engine(eng, [payload(i) for i in range(5)], ids, FlipHandler(10**9))
    assert [r.request_id for r in out] == ids and all(r.outcome == "predict" for r in out)
    return typed(out)


def sc_plane_driver_drains_on_flag(P):
    clock = FakeClock()
    rs = make_set(P, clock, batcher_config=P.batcher.BatcherConfig(max_linger_s=99.0))
    rs.start()
    ids = [f"p{i}" for i in range(6)]
    out, reports = P.cli.drive_batch_plane(rs, [payload(i) for i in range(6)], ids,
                                           FlipHandler(after=2))
    assert sorted(r.request_id for r in out) == ids and reports == []
    assert any(r.outcome == "shed" and r.reason == "shutdown" for r in out)
    return typed(out)


def sc_plane_driver_swaps_midway(P):
    clock = FakeClock()
    rs = make_set(P, clock, batcher_config=P.batcher.BatcherConfig(max_linger_s=99.0))
    rs.start()
    ids = [f"m{i}" for i in range(6)]
    out, reports = P.cli.drive_batch_plane(
        rs, [payload(i) for i in range(6)], ids, FlipHandler(10**9), swap_at=3,
        swap_factory=lambda: make_engine(P, clock))
    assert [r.request_id for r in out] == ids and all(r.outcome == "predict" for r in out)
    assert [rep.reason for rep in reports] == ["committed"] and reports[0].transferred == 3
    return [rep.to_dict() for rep in reports] + typed(out)


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__[3:] for f in SCENARIOS])
def test_scenario_traces_equal_the_jax_package(scenario):
    traces = {}
    for name in PKGS:
        jax_set_registry(JaxMetricRegistry())
        tmetrics.set_current_registry(None)
        traces[name] = scenario(MODS[name])
    assert traces["torch"] == traces["jax"]


# ----------------------------------------------------------- HTTP frontend
async def _http(port, method, path, body=None):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    w.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\nContent-Length: {len(data)}\r\n\r\n"
            .encode() + data)
    await w.drain()
    raw = await r.read()
    w.close()
    head, _, body_ = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body_


def _wire(status, body):
    """A response as (status, its JSON without the latency)."""
    try:
        rec = json.loads(body)
    except ValueError:
        return status, None
    if isinstance(rec, dict):
        rec.pop("latency_s", None)
        rec.pop("trust_score", None)
    return status, rec


def _plane(P, **engine_kw):
    clock = time.monotonic
    rs = P.replica.ReplicaSet(lambda: make_engine(P, clock, **engine_kw), replicas=2,
                              clock=clock,
                              batcher_config=P.batcher.BatcherConfig(max_linger_s=0.005))
    rs.start()
    return rs


def http_predict_probes_metrics(P):
    fe = P.frontend.Frontend(_plane(P), poll_interval_s=0.002)
    img = payload().tolist()
    trace = []

    async def drill():
        await fe.start()
        s, b = await _http(fe.port, "GET", "/healthz")
        trace.append(_wire(s, b))
        s, b = await _http(fe.port, "GET", "/readyz")
        assert s == 200 and json.loads(b)["ready"]
        trace.append(s)
        results = await asyncio.gather(*[
            _http(fe.port, "POST", "/v1/predict", {"id": f"h{i}", "image": img,
                                                   "deadline_ms": 5000}) for i in range(5)])
        trace.extend(sorted(_wire(s, b)[1]["request_id"] + f":{s}" for s, b in results))
        for body in ({"nope": 1}, {"id": "dl", "image": img, "deadline_ms": {}},
                     {"id": "bad", "image": [[0.0, 1.0]]}):
            trace.append(_wire(*await _http(fe.port, "POST", "/v1/predict", body)))
        s, b = await _http(fe.port, "GET", "/metrics")
        assert s == 200 and b"serving_requests_total" in b
        trace.append(s)
        trace.append((await _http(fe.port, "GET", "/nowhere"))[0])
        trace.append((await _http(fe.port, "POST", "/admin/swap", {"artifact": "x"}))[0])
        fe.request_stop()
        await fe.run_until_drained()

    asyncio.run(drill())
    assert fe.outcomes.get("predict", 0) == 5
    return trace + [fe.outcomes]


def http_stalled_body_408(P):
    fe = P.frontend.Frontend(_plane(P), poll_interval_s=0.002, io_timeout_s=0.05)
    trace = []

    async def drill():
        await fe.start()
        r, w = await asyncio.open_connection("127.0.0.1", fe.port)
        w.write(b"POST /v1/predict HTTP/1.1\r\nHost: t\r\nContent-Length: 100\r\n\r\n")
        await w.drain()
        raw = await asyncio.wait_for(r.read(), timeout=5.0)
        w.close()
        trace.append(int(raw.split()[1]))
        trace.append(_wire(*await _http(fe.port, "POST", "/v1/predict",
                                        {"id": "ok", "image": payload().tolist(),
                                         "deadline_ms": 5000})))
        fe.request_stop()
        await fe.run_until_drained()

    asyncio.run(drill())
    assert trace[0] == 408 and trace[1][1]["outcome"] == "predict"
    return trace


def http_oversized_head_400(P):
    fe = P.frontend.Frontend(_plane(P), poll_interval_s=0.002, max_head_bytes=2048)
    trace = []

    async def drill():
        await fe.start()
        r, w = await asyncio.open_connection("127.0.0.1", fe.port)
        w.write(b"GET /healthz HTTP/1.1\r\nHost: t\r\n")
        for i in range(120):
            w.write(b"X-Pad-%d: aaaaaaaaaaaaaaaaaaaaaaaa\r\n" % i)
        await w.drain()
        raw = await asyncio.wait_for(r.read(), timeout=5.0)
        w.close()
        trace.append(int(raw.split()[1]))
        fe.request_stop()
        await fe.run_until_drained()

    asyncio.run(drill())
    assert trace == [400]
    return trace


def http_preemption_flag_drains_inflight(P):
    rs = _plane(P)
    for rep in rs.replicas:
        rep.batcher.config = P.batcher.BatcherConfig(max_linger_s=60.0)
    handler = FlipHandler(after=10**9)
    fe = P.frontend.Frontend(rs, poll_interval_s=0.002, preemption_handler=handler)
    trace = []

    async def drill():
        await fe.start()
        task = asyncio.create_task(_http(fe.port, "POST", "/v1/predict",
                                         {"id": "z0", "image": payload().tolist()}))
        await asyncio.sleep(0.05)  # queued, not dispatched
        handler.after = 0  # SIGTERM arrives
        fe._kick.set()
        trace.append(_wire(*await task))
        await fe.run_until_drained()
        s, b = await _http_refused(fe.port)
        trace.append(s)

    asyncio.run(drill())
    status, rec = trace[0]
    assert rec["request_id"] == "z0" and rec["outcome"] == "predict" and status == 200
    return trace


async def _http_refused(port):
    """After the drain the socket is closed: a connection is refused."""
    try:
        await _http(port, "GET", "/healthz")
    except OSError:
        return "refused", None
    return "open", None


def http_swap_endpoint(P):
    clock = time.monotonic
    rs = P.replica.ReplicaSet(lambda: make_engine(P, clock), replicas=1, clock=clock,
                              batcher_config=P.batcher.BatcherConfig(max_linger_s=0.005))
    rs.start()

    def builder(path):
        if path == "good.mgproto":
            return lambda: make_engine(P, clock)
        return lambda: make_engine(P, clock, calibrated=False)

    fe = P.frontend.Frontend(rs, poll_interval_s=0.002, swap_factory_builder=builder)
    trace = []

    async def drill():
        await fe.start()
        for path in ("bad.mgproto", "good.mgproto"):
            trace.append(_wire(*await _http(fe.port, "POST", "/admin/swap", {"artifact": path})))
        trace.append(_wire(*await _http(fe.port, "POST", "/v1/predict",
                                        {"id": "after", "image": payload().tolist()})))
        trace.append(_wire(*await _http(fe.port, "POST", "/admin/swap", {"nope": 1})))
        fe.request_stop()
        await fe.run_until_drained()

    asyncio.run(drill())
    assert trace[0][0] == 409 and trace[0][1]["reason"] == "uncalibrated"
    assert trace[1][0] == 200 and trace[1][1]["reason"] == "committed"
    assert trace[2][1]["outcome"] == "predict"
    return trace


def http_swap_honors_allow_uncalibrated(P):
    clock = time.monotonic
    rs = P.replica.ReplicaSet(lambda: make_engine(P, clock, calibrated=False), replicas=1,
                              clock=clock,
                              batcher_config=P.batcher.BatcherConfig(max_linger_s=0.005))
    rs.start()
    fe = P.frontend.Frontend(rs, poll_interval_s=0.002,
                             swap_factory_builder=lambda p: (
                                 lambda: make_engine(P, clock, calibrated=False)),
                             require_calibrated_swap=False)
    trace = []

    async def drill():
        await fe.start()
        trace.append(_wire(*await _http(fe.port, "POST", "/admin/swap",
                                        {"artifact": "degraded.mgproto"})))
        trace.append(_wire(*await _http(fe.port, "POST", "/v1/predict",
                                        {"id": "d", "image": payload().tolist()})))
        fe.request_stop()
        await fe.run_until_drained()

    asyncio.run(drill())
    assert trace[0][0] == 200 and trace[0][1]["reason"] == "committed"
    assert trace[1][1]["degraded"] is True
    return trace


HTTP_DRILLS = [http_predict_probes_metrics, http_stalled_body_408, http_oversized_head_400,
               http_preemption_flag_drains_inflight, http_swap_endpoint,
               http_swap_honors_allow_uncalibrated]


@pytest.mark.parametrize("drill", HTTP_DRILLS, ids=[f.__name__[5:] for f in HTTP_DRILLS])
def test_http_frontend_traces_equal_the_jax_package(drill):
    traces = {}
    for name in PKGS:
        jax_set_registry(JaxMetricRegistry())
        tmetrics.set_current_registry(None)
        traces[name] = drill(MODS[name])
    assert traces["torch"] == traces["jax"]


def test_http_status_map_equals_the_jax_package():
    cases = [("predict", None), ("abstain", None), ("reject", "bad_shape"),
             ("reject", "circuit_open"), ("reject", "device_error"), ("shed", "queue_full"),
             ("shed", "deadline"), ("shed", "shutdown"), ("shed", "no_replica"),
             ("shed", "replica_lost")]
    for outcome, reason in cases:
        got = [MODS[n].frontend.http_status_for(MODS[n].response.ServeResponse(
            request_id="x", outcome=outcome, reason=reason)) for n in PKGS]
        assert got[0] == got[1], (outcome, reason)


def test_metric_names_equal_the_jax_package():
    j, t = MODS["jax"].metrics, MODS["torch"].metrics
    for name in ("DISPATCHES", "QUEUE_DEPTH", "REPLICA_RESTARTS", "REPLICAS_READY",
                 "REPLICAS_TOTAL", "BREAKER_OPEN_FRACTION", "UPTIME_SECONDS", "SWAPS",
                 "SWAP_TRANSFERRED", "EXPLANATIONS", "SHED", "REQUESTS"):
        assert getattr(t, name) == getattr(j, name)
    reg = tmetrics.MetricRegistry()
    tmetrics.register_serving_metrics(reg)
    text = reg.to_prometheus()
    for name in t.COUNTER_HELP:
        assert f"# TYPE {name} counter" in text and f"\n{name} 0\n" in text
    assert f"{t.REQUEST_SECONDS}_count" not in text  # no series observed yet


def test_the_port_refuses_the_serving_chaos_knobs():
    """The plane's chaos knobs are read now (they were refused before the
    serving chaos was ported): each parses to the JAX package's value."""
    for knob, field in (("MGPROTO_CHAOS_SERVE_REPLICA_KILL_AT", "serve_replica_kill_at"),
                        ("MGPROTO_CHAOS_SERVE_WEDGE_AT", "serve_wedge_at"),
                        ("MGPROTO_CHAOS_SERVE_SWAP_BAD_ARTIFACT", "serve_swap_bad_artifact")):
        got = getattr(tchaos.plan_from_env({knob: "1"}), field)
        assert got == getattr(jchaos.plan_from_env({knob: "1"}), field) == 1, knob


# ------------------------------------------------------------------- lint
def _lint():
    spec = importlib.util.spec_from_file_location(
        "check_no_blocking_sleep", os.path.join(REPO, "scripts", "check_no_blocking_sleep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_serving_modules_pass_the_no_blocking_sleep_lint():
    lint = _lint()
    pkg = os.path.join(REPO, "mgproto_tpu_torch", "serving")
    files = sorted(f for f in os.listdir(pkg) if f.endswith(".py"))
    assert {"batcher.py", "frontend.py", "replica.py", "swap.py", "health.py"} <= set(files)
    bad = []
    for f in files:
        with open(os.path.join(pkg, f)) as fh:
            tree = ast.parse(fh.read(), f)
        bad += [f"{f}:{line} {why}" for line, why in lint._offending_calls(tree)]
    assert not bad, bad
    # and the checker sees a blocking sleep written the port's way
    tree = ast.parse("import time\ndef f():\n    time.sleep(0.01)\n")
    assert [line for line, _ in lint._offending_calls(tree)] == [3]
