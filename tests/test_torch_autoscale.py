"""The port's autoscaler and replica elasticity (mgproto_tpu_torch/serving/
{autoscale,replica}.py, the frontend's GET /admin/autoscale) against the
JAX package's, on the CPU.

The scenarios of tests/test_autoscale.py run on BOTH packages, each with
its own real ServingEngine over the constant model of
tests/test_torch_serving_plane.py, one injected fake clock (a dispatch
advances it, so latencies and the cost estimate are real on it), a fresh
metric registry and no chaos (the JAX AOT cache is off: the engines are
built without one). The saturation here comes from bursts submitted
between two pump turns, not from the JAX batcher's device-busy window,
which the port does not have. Each scenario returns a trace: every applied
decision's `to_dict()` (time, direction, reason, replica counts and the
whole signal snapshot, floats included), every response's id, outcome and
reason in order, and the counters and statuses the JAX test reads. The two
packages' traces must be equal; exact equality, since both run the same
host arithmetic on the same clock.
"""

import asyncio
import json
import types

import pytest

from mgproto_tpu.resilience import chaos as jchaos
from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu_torch.resilience import chaos as tchaos
from mgproto_tpu_torch.serving import metrics as tmetrics
from test_torch_serving_plane import MODS as PLANE_MODS
from test_torch_serving_plane import PKGS, FakeClock, make_engine, make_set, payload, typed


def _mods(name):
    base = PLANE_MODS[name]
    ns = types.SimpleNamespace(**vars(base))
    for n in ("autoscale", "tenants"):
        setattr(ns, n, __import__(f"{base.name}.serving.{n}", fromlist=[n]))
    ns.chaos = jchaos if name == "jax" else tchaos
    ns.registry = (lambda: __import__("mgproto_tpu.telemetry.registry", fromlist=["x"])
                   .default_registry()) if name == "jax" else tmetrics.default_registry
    return ns


MODS = {name: _mods(name) for name in PKGS}


@pytest.fixture(autouse=True)
def fresh_state():
    prev_t = tmetrics.set_current_registry(None)
    prev_j = jax_set_registry(JaxMetricRegistry())
    prev_jc, prev_tc = jchaos.set_active(None), tchaos.set_active(None)
    yield
    jchaos.set_active(prev_jc)
    tchaos.set_active(prev_tc)
    jax_set_registry(prev_j)
    tmetrics.set_current_registry(prev_t)


DISPATCH_S = 0.0008  # the constant model's dispatch time on the fake clock


def _plane(P, clock, replicas=1, capacity=16):
    return make_set(P, clock, replicas=replicas,
                    factory=lambda: make_engine(P, clock, capacity=capacity),
                    pre_dispatch=lambda: clock.advance(DISPATCH_S))


def _pump(rs, scaler, out):
    out.extend(rs.poll())
    d = scaler.tick() if scaler is not None else None
    if d is not None:
        out.extend(d.responses)


# ------------------------------------------------------ replica elasticity
def sc_add_replica_started_by_next_poll(P):
    clock = FakeClock()
    rs = _plane(P, clock)
    rs.start()
    rep = rs.add_replica()
    trace = [rep.name, rep.engine is None, len(rs.ready_replicas())]
    rs.poll()  # the pump builds and warms it, off any request's path
    trace += [rep.engine is not None, rep.routable(), len(rs.ready_replicas()),
              P.metrics.gauge(P.metrics.REPLICAS_TOTAL).value()]
    assert trace == ["r1", True, 1, True, True, 2, 2.0]
    return trace


def sc_remove_replica_transfers_queue_zero_drops(P):
    clock = FakeClock()
    rs = _plane(P, clock, replicas=2)
    rs.start()
    ids = [f"q{i}" for i in range(6)]
    for i, rid in enumerate(ids):
        assert rs.submit(payload(i), request_id=rid) == []
    victim = rs.ready_replicas()[-1]
    queued = len(victim.engine.queue)
    assert queued > 0
    out = rs.remove_replica(victim)
    assert len(rs.replicas) == 1
    for _ in range(200):
        out.extend(rs.poll())
        if len({r.request_id for r in out}) == len(ids):
            break
        clock.advance(0.02)
    assert sorted(r.request_id for r in out) == ids  # each answered once
    assert all(r.outcome in ("predict", "abstain") for r in out)
    return [queued, victim.name] + typed(out)


def sc_remove_replica_full_survivors_flush_the_victim(P):
    """Survivors without room: the victim answers the rest through its own
    device before it leaves; nothing sheds."""
    clock = FakeClock()
    rs = _plane(P, clock, replicas=2, capacity=4)
    rs.start()
    for i in range(8):
        assert rs.submit(payload(i), request_id=f"f{i}") == []
    out = rs.remove_replica(rs.replicas[-1])
    out += rs.flush()
    assert sorted(r.request_id for r in out) == sorted(f"f{i}" for i in range(8))
    assert {r.outcome for r in out} <= {"predict", "abstain"}
    return typed(out)


def sc_remove_last_replica_refused(P):
    clock = FakeClock()
    rs = _plane(P, clock)
    rs.start()
    with pytest.raises(ValueError):
        rs.remove_replica()
    return [len(rs.replicas)]


def sc_remove_prefers_idle_backoff_replica(P):
    clock = FakeClock()
    rs = _plane(P, clock)
    rs.start()
    rep = rs.add_replica()  # never started: no engine
    out = rs.remove_replica()
    assert out == [] and rep not in rs.replicas and len(rs.replicas) == 1
    return [r.name for r in rs.replicas]


# --------------------------------------------------------------- autoscaler
def sc_scale_up_then_down_zero_drops(P):
    clock = FakeClock()
    rs = _plane(P, clock)
    rs.start()
    A = P.autoscale
    scaler = A.Autoscaler(rs, A.AutoscalerConfig(
        min_replicas=1, max_replicas=3, interval_s=0.1, up_queue_per_replica=4.0,
        up_cooldown_s=0.3, down_patience=3, down_cooldown_s=0.3), clock=clock)
    out, n = [], 0
    # a burst of 20 every 0.1 s against one replica's queue of 16
    for _ in range(8):
        for _ in range(20):
            out.extend(rs.submit(payload(n), request_id=f"q{n}"))
            n += 1
        _pump(rs, scaler, out)
        clock.advance(0.1)
        _pump(rs, scaler, out)
    ups = [d for d in scaler.decisions if d.direction == "up"]
    assert ups and 1 < len(rs.replicas) <= 3
    # calm: a trickle, then silence; the fleet shrinks back
    for _ in range(20):
        out.extend(rs.submit(payload(n), request_id=f"q{n}"))
        n += 1
        _pump(rs, scaler, out)
        clock.advance(0.05)
    for _ in range(60):
        _pump(rs, scaler, out)
        clock.advance(0.05)
    assert [d for d in scaler.decisions if d.direction == "down"] and len(rs.replicas) == 1
    out.extend(rs.drain())
    assert sorted(r.request_id for r in out) == sorted(f"q{i}" for i in range(n))  # zero dropped
    reg = P.registry()
    counts = [reg.counter(P.metrics.AUTOSCALE_EVENTS).value(direction=d) for d in ("up", "down")]
    assert counts == [len(ups), len(scaler.decisions) - len(ups)]
    assert reg.gauge(P.metrics.AUTOSCALE_TARGET).value() == 1.0
    return [d.to_dict() for d in scaler.decisions] + typed(out) + counts + [scaler.status()]


def sc_bounds_respected_at_max(P):
    clock = FakeClock()
    rs = _plane(P, clock)
    rs.start()
    A = P.autoscale
    scaler = A.Autoscaler(rs, A.AutoscalerConfig(
        min_replicas=1, max_replicas=2, interval_s=0.05, up_queue_per_replica=1.0,
        up_cooldown_s=0.0), clock=clock)
    out = []
    for i in range(120):
        out.extend(rs.submit(payload(i), request_id=f"b{i}"))
        if i % 10 == 9:
            _pump(rs, scaler, out)
        clock.advance(1 / 800.0)
    assert len(rs.replicas) <= 2 and all(d.replicas_after <= 2 for d in scaler.decisions)
    return [d.to_dict() for d in scaler.decisions] + typed(out)


def sc_invalid_bounds_rejected(P):
    clock = FakeClock()
    rs = _plane(P, clock)
    A = P.autoscale
    for kw in ({"min_replicas": 3, "max_replicas": 2}, {"min_replicas": 0}):
        with pytest.raises(ValueError):
            A.Autoscaler(rs, A.AutoscalerConfig(**kw), clock=clock)
    return []


def sc_status_surface(P):
    clock = FakeClock()
    rs = _plane(P, clock)
    rs.start()
    scaler = P.autoscale.Autoscaler(rs, P.autoscale.AutoscalerConfig(
        min_replicas=1, max_replicas=4), clock=clock)
    status = scaler.status()
    assert (status["min_replicas"], status["max_replicas"], status["replicas"],
            status["last_decision"]) == (1, 4, 1, None)
    return [status]


def sc_frontend_admin_autoscale_endpoint(P):
    clock = FakeClock()
    rs = _plane(P, clock)
    rs.start()
    scaler = P.autoscale.Autoscaler(rs, P.autoscale.AutoscalerConfig(
        min_replicas=1, max_replicas=4), clock=clock)
    status, body, _ = asyncio.run(P.frontend.Frontend(rs, autoscaler=scaler)._route(
        "GET", "/admin/autoscale", b""))
    none_status, none_body, _ = asyncio.run(P.frontend.Frontend(rs)._route(
        "GET", "/admin/autoscale", b""))
    assert (status, none_status) == (200, 501)
    return [json.loads(body), json.loads(none_body)]


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__[3:] for f in SCENARIOS])
def test_scenario_traces_equal_the_jax_package(scenario):
    traces = {}
    for name in PKGS:
        jax_set_registry(JaxMetricRegistry())
        tmetrics.set_current_registry(None)
        traces[name] = scenario(MODS[name])
    assert traces["torch"] == traces["jax"]


def test_percentile_from_buckets_and_snapshot_equal_jax():
    """The registry snapshot's histogram series and the percentile estimate
    the autoscaler reads, against mgproto_tpu/telemetry/registry.py's."""
    from mgproto_tpu.telemetry import registry as jreg

    jr, tr = jreg.MetricRegistry(), tmetrics.MetricRegistry()
    values = [0.0004, 0.003, 0.003, 0.02, 0.07, 0.2, 0.9, 3.0, 7.5]
    for v in values:
        jr.histogram("h").observe(v, outcome="predict")
        tr.histogram("h").observe(v, outcome="predict")
    jr.counter("c").inc(3.0, reason="x")
    tr.counter("c").inc(3.0, reason="x")
    js, ts = jr.snapshot(), tr.snapshot()
    jh, th = js["h"]["series"][0], ts["h"]["series"][0]
    for k in ("bounds", "bucket_counts", "count", "sum", "min", "max", "labels"):
        assert th[k] == jh[k], k
    assert ts["c"]["series"] == [{"labels": {"reason": "x"}, "value": 3.0}]
    assert js["c"]["series"][0]["value"] == 3.0
    for p in (0.0, 10.0, 50.0, 90.0, 99.0, 100.0):
        assert tmetrics.percentile_from_buckets(th, p) == jreg.percentile_from_buckets(jh, p)
    assert tmetrics.percentile_from_buckets({"count": 0}, 50.0) is None
    with pytest.raises(ValueError):
        tmetrics.percentile_from_buckets(th, 101.0)
