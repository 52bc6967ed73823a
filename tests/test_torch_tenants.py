"""The port's tenant plane (mgproto_tpu_torch/serving/{tenants,admission,
engine,batcher,frontend}.py) against the JAX package's, on the CPU.

The scenarios of tests/test_tenants.py (the lanes and quotas of the
admission queue, the directory's mounts, quotas and fail-closed swaps, the
tenant chaos knobs, per-tenant gating in the engine) and a plane drill of
phase 13 (c)'s shape (three tenants on a two-replica fleet, a fourth
mounted mid-load, a storm redirected at one tenant by
MGPROTO_CHAOS_TENANT_STORM_AT, a head swap sabotaged by
MGPROTO_CHAOS_TENANT_BAD_SWAP) run on BOTH packages, each with its own real
ServingEngine over the constant model of tests/test_torch_serving_plane.py
and one fake clock. Each returns a trace (responses' ids, outcomes,
reasons, trust labels and tenants in order; counters; swap and mount
reports without the fingerprint's hex, which is each package's own sha256
of its own calibration JSON): the traces must be equal, exactly. The
port's own contract beside it: with `tenants=None` a response has no
"tenant" key. A head's online state (a drift monitor, a capture reservoir,
class slots) runs on both packages with equal traces.
"""

import asyncio
import dataclasses
import json
import types

import numpy as np
import pytest

from mgproto_tpu.resilience import chaos as jchaos
from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu_torch.resilience import chaos as tchaos
from mgproto_tpu_torch.serving import metrics as tmetrics
from test_torch_autoscale import MODS
from test_torch_serving_plane import (
    FINGERPRINT,
    IMG,
    PKGS,
    FakeClock,
    _http,
    _wire,
    make_calibration,
    make_engine,
    make_set,
    payload,
)


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


def _lines(resps):
    return [(r.request_id, r.outcome, r.reason, r.trust, r.tenant) for r in resps]


def _calib(P, seed=3, n=200):
    rng = np.random.RandomState(seed)
    return P.calibration.Calibration.from_scores(rng.randn(n) - 2.0, rng.randn(n, 4),
                                                 f"fp-{seed}")


def _injections(P, kind):
    if P.name == "mgproto_tpu":
        from mgproto_tpu.resilience import metrics as rm

        return rm.counter(rm.CHAOS_INJECTIONS).value(kind=kind)
    return tchaos.get_active().injections.get(kind, 0)


# ---------------------------------------------------------- admission lanes
def sc_no_tenant_path_is_plain_fifo(P):
    q = P.admission.AdmissionQueue(capacity=8, clock=FakeClock())
    for i in range(5):
        req, shed = q.submit(i, request_id=f"r{i}")
        assert shed is None and req.tenant is None
    assert q.tenant_depths() == {}
    return [r.request_id for r in q.pop_batch(5)]


def sc_one_lane_pop_is_fifo(P):
    q = P.admission.AdmissionQueue(capacity=8, clock=FakeClock())
    for i in range(4):
        q.submit(i, request_id=f"a{i}", tenant="a", quota=8)
    return [r.request_id for r in q.pop_batch(4)]


def sc_quota_sheds_own_tail_only(P):
    q = P.admission.AdmissionQueue(capacity=16, clock=FakeClock())
    q.submit("b0", request_id="b0", tenant="b", quota=8)
    trace = [q.submit(f"a{i}", request_id=f"a{i}", tenant="a", quota=2)[1] for i in range(3)]
    assert trace == [None, None, P.admission.SHED_TENANT_QUOTA]
    trace += [q.tenant_depths(), q.submit("b1", request_id="b1", tenant="b", quota=8)[1],
              P.metrics.counter(P.metrics.TENANT_SHED).value(tenant="a", reason="tenant_quota")]
    return trace


def sc_quota_deadline_aware_within_share(P):
    clock = FakeClock()
    q = P.admission.AdmissionQueue(capacity=16, clock=clock)
    q.submit("a0", request_id="a0", tenant="a", quota=2, deadline_s=0.5)
    q.submit("a1", request_id="a1", tenant="a", quota=2, deadline_s=10.0)
    clock.advance(1.0)
    _, shed = q.submit("a2", request_id="a2", tenant="a", quota=2, deadline_s=10.0)
    assert shed is None
    return [[r.request_id for r in q.drain_shed()], q.tenant_depths()]


def sc_pop_batch_fair_share_round_robins_lanes(P):
    clock = FakeClock()
    q = P.admission.AdmissionQueue(capacity=16, clock=clock)
    for i in range(4):
        q.submit(f"a{i}", request_id=f"a{i}", tenant="a", quota=8)
    for i in range(2):
        q.submit(f"b{i}", request_id=f"b{i}", tenant="b", quota=8, deadline_s=1.0 if i else None)
    q.submit("n0", request_id="n0")  # the no-tenant lane is a lane too
    first = [r.request_id for r in q.pop_batch(4)]
    assert first == ["a0", "b0", "n0", "a1"]
    clock.advance(2.0)  # b1 expires in its lane: shed at the pop
    rest = [r.request_id for r in q.pop_batch(4)]
    return [first, rest, [r.request_id for r in q.drain_shed()]]


# ------------------------------------------------------- tenant directory
def sc_mount_reports_head_cost(P):
    calib = _calib(P)
    T = P.tenants
    d = T.TenantDirectory()
    rep = d.mount("t0", calib)
    assert rep.head_bytes == T.head_nbytes(calib) > 0
    assert rep.head_fingerprint == T.head_fingerprint(calib) and len(rep.head_fingerprint) == 64
    assert 0.0 <= rep.mount_seconds < 0.2
    with pytest.raises(ValueError, match="already mounted"):
        d.mount("t0", calib)
    return [rep.head_bytes, d.tenants(), len(d),
            P.metrics.gauge(P.metrics.TENANTS_MOUNTED).value(),
            P.metrics.gauge(P.metrics.TENANT_HEAD_BYTES).value(tenant="t0")]


def sc_head_identity_is_the_calibration(P):
    T = P.tenants
    a, b = _calib(P, seed=1), _calib(P, seed=2)
    return [T.head_fingerprint(a) != T.head_fingerprint(b),
            T.head_fingerprint(a) == T.head_fingerprint(_calib(P, seed=1)),
            T.head_fingerprint(None), T.head_nbytes(None)]


def sc_quota_fair_share_math(P):
    d = P.tenants.TenantDirectory()
    d.mount("big", _calib(P, 1), quota_weight=3.0)
    d.mount("small", _calib(P, 2), quota_weight=1.0)
    trace = [d.quota_for("big", 32), d.quota_for("small", 32), d.quota_for("ghost", 32)]
    d.mount("tiny", _calib(P, 3), quota_weight=0.001)
    trace.append(d.quota_for("tiny", 32))
    with pytest.raises(ValueError, match="quota_weight"):
        d.mount("bad", _calib(P, 4), quota_weight=0.0)
    assert trace == [24, 8, None, 1]
    return trace


def sc_unmount(P):
    d = P.tenants.TenantDirectory()
    d.mount("t0", _calib(P))
    return [d.unmount("t0"), d.unmount("t0"), d.tenants(), d.gate_for("t0"),
            P.metrics.counter(P.metrics.TENANT_UNMOUNTS).value(tenant="t0")]


def sc_swap_fails_closed_per_tenant(P):
    d = P.tenants.TenantDirectory()
    d.mount("a", _calib(P, 1))
    d.mount("b", _calib(P, 2))
    old_gate, old_fp = d.gate_for("a"), d.head_for("a").head_fingerprint
    bad = d.swap("a", None)
    assert d.gate_for("a") is old_gate and d.head_for("a").head_fingerprint == old_fp
    new = _calib(P, 9)
    good = d.swap("b", new)
    assert good.head_fingerprint == P.tenants.head_fingerprint(new) == \
        d.head_for("b").head_fingerprint
    stale = d.swap("b", _calib(P, 9), expected_fingerprint="another-gmm")
    ghost = d.swap("ghost", new)
    assert d.gate_for("a") is old_gate
    return [(r.ok, r.tenant, r.reason) for r in (bad, good, stale, ghost)] + [
        P.metrics.counter(P.metrics.TENANT_SWAPS).value(tenant="b", result=res)
        for res in ("committed", "rejected")]


def sc_chaos_bad_swap_knob_strips_the_staged_head(P):
    d = P.tenants.TenantDirectory()
    d.mount("a", _calib(P, 1))
    P.chaos.install(P.chaos.ChaosPlan(tenant_bad_swap=1))
    first, second = d.swap("a", _calib(P, 9)), d.swap("a", _calib(P, 9))
    return [(first.ok, first.reason), (second.ok, second.reason),
            _injections(P, "tenant_bad_swap")]


def sc_tenant_chaos_knobs(P):
    plan = P.chaos.plan_from_env({"MGPROTO_CHAOS_TENANT_STORM_AT": "5",
                                  "MGPROTO_CHAOS_TENANT_BAD_SWAP": "2"})
    state = P.chaos.install(plan)
    trace = [plan.tenant_storm_at, plan.tenant_bad_swap, P.chaos.plan_from_env({}),
             [state.tenant_storm_due(i) for i in (4, 5, 6)],
             [state.tenant_bad_swap_due() for _ in range(3)],
             _injections(P, "tenant_storm")]
    assert trace[3:5] == [[False, True, True], [True, True, False]]
    return trace


# ---------------------------------------------------------- engine gating
def sc_requests_gate_through_their_tenants_head(P):
    clock = FakeClock()
    base = make_calibration(P)
    d = P.tenants.TenantDirectory(clock=clock)
    d.mount("strict", dataclasses.replace(base, threshold_log_px=1e9),
            expected_fingerprint=FINGERPRINT)
    d.mount("lax", dataclasses.replace(base, threshold_log_px=-1e9),
            expected_fingerprint=FINGERPRINT)
    eng = make_engine(P, clock, buckets=(4,), tenants=d)
    eng.submit(payload(0), request_id="s", tenant="strict")
    eng.submit(payload(1), request_id="l", tenant="lax")
    eng.submit(payload(2), request_id="n")  # no tenant: the engine's own gate
    out = eng.process_pending()
    got = {r.request_id: r for r in out}
    assert (got["s"].outcome, got["l"].outcome) == ("abstain", "predict")
    assert "tenant" not in got["n"].to_dict() and got["s"].to_dict()["tenant"] == "strict"
    return _lines(out) + [P.metrics.counter(P.metrics.TENANT_REQUESTS).value(
        tenant="strict", outcome="abstain")]


def sc_unmounted_tenant_rejected_typed(P):
    clock = FakeClock()
    d = P.tenants.TenantDirectory(clock=clock)
    d.mount("real", make_calibration(P), expected_fingerprint=FINGERPRINT)
    eng = make_engine(P, clock, buckets=(2,), tenants=d)
    bare = make_engine(P, clock, buckets=(2,))
    out = eng.submit(payload(), request_id="g", tenant="ghost")
    out += bare.submit(payload(), request_id="b", tenant="real")  # no directory at all
    assert [(r.outcome, r.reason) for r in out] == [("reject", "tenant_unmounted")] * 2
    return _lines(out)


def sc_plane_drill_mount_storm_bad_swap(P):
    """Three tenants (the 5th, 25th and 50th percentile heads of one
    calibration) on a two-replica fleet; a fourth mounts mid-load; from
    request 40 on the storm knob sends every request to one tenant, which
    sheds only its own tail; a sabotaged swap of that tenant's head is
    refused while the others serve on, and the next swap commits."""
    clock = FakeClock()
    d = P.tenants.TenantDirectory(clock=clock)
    base = make_calibration(P)
    for name, pct in (("t5", 5.0), ("t25", 25.0), ("t50", 50.0)):
        d.mount(name, base, percentile=pct, expected_fingerprint=FINGERPRINT)
    rs = make_set(P, clock, replicas=2,
                  factory=lambda: make_engine(P, clock, capacity=16, tenants=d))
    rs.start()
    state = P.chaos.install(P.chaos.ChaosPlan(tenant_storm_at=40, tenant_bad_swap=1))
    names = ["t5", "t25", "t50"]
    out, reports = [], []
    for i in range(72):
        tenant = names[i % len(names)]
        if state.tenant_storm_due(i):
            tenant = "t25"
        out.extend(rs.submit(payload(i % 5), request_id=f"q{i}", tenant=tenant))
        if i == 20:
            reports.append(d.mount("t4", base, expected_fingerprint=FINGERPRINT).head_bytes)
            names.append("t4")
        if i == 50:
            reports += [d.swap("t25", base, expected_fingerprint=FINGERPRINT).reason,
                        d.swap("t25", base, expected_fingerprint=FINGERPRINT,
                               percentile=10.0).reason]
        if i % (12 if i >= 40 else 4) == 3:  # the storm comes in bursts of 12
            out.extend(rs.poll())
            clock.advance(0.011)
    out.extend(rs.flush())
    assert sorted(r.request_id for r in out) == sorted(f"q{i}" for i in range(72))
    sheds = {r.tenant for r in out if r.outcome == "shed"}
    assert sheds == {"t25"} and reports[1:] == ["uncalibrated", "committed"]
    assert rs.steady_recompiles == 0
    depth = [P.metrics.gauge(P.metrics.TENANT_QUEUE_DEPTH).value(tenant=t) for t in names]
    return _lines(out) + reports + depth + [
        P.metrics.counter(P.metrics.TENANT_SHED).value(tenant="t25", reason="tenant_quota")]


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__[3:] for f in SCENARIOS])
def test_scenario_traces_equal_the_jax_package(scenario):
    traces = {}
    for name in PKGS:
        jax_set_registry(JaxMetricRegistry())
        tmetrics.set_current_registry(None)
        MODS[name].chaos.set_active(None)
        traces[name] = scenario(MODS[name])
    assert traces["torch"] == traces["jax"]


def test_the_tenant_field_rides_the_wire_as_in_jax():
    """POST /v1/predict with and without "tenant": the same statuses and
    bodies from both frontends."""
    import time

    traces = {}
    for name in PKGS:
        jax_set_registry(JaxMetricRegistry())
        tmetrics.set_current_registry(None)
        P = MODS[name]
        d = P.tenants.TenantDirectory()
        d.mount("a", make_calibration(P), expected_fingerprint=FINGERPRINT)
        rs = P.replica.ReplicaSet(lambda: make_engine(P, time.monotonic, tenants=d), replicas=1,
                                  clock=time.monotonic,
                                  batcher_config=P.batcher.BatcherConfig(max_linger_s=0.005))
        rs.start()
        fe = P.frontend.Frontend(rs, poll_interval_s=0.002)
        trace = []

        async def drill():
            await fe.start()
            for body in ({"id": "t", "image": payload().tolist(), "tenant": "a"},
                         {"id": "u", "image": payload().tolist(), "tenant": "nobody"},
                         {"id": "n", "image": payload().tolist()}):
                trace.append(_wire(*await asyncio.wait_for(
                    _http(fe.port, "POST", "/v1/predict", body), timeout=60)))
            fe.request_stop()
            await asyncio.wait_for(fe.run_until_drained(), timeout=60)

        asyncio.run(drill())
        traces[name] = trace
    assert traces["torch"] == traces["jax"]
    assert traces["torch"][0][1]["tenant"] == "a" and "tenant" not in traces["torch"][2][1]
    assert traces["torch"][1][1]["reason"] == "tenant_unmounted"


class _Resp:
    """A served response as the taps read it."""

    def __init__(self, rid, log_px, tenant, prediction=1, outcome="predict", trust="in_dist"):
        self.request_id, self.log_px, self.tenant = rid, log_px, tenant
        self.prediction, self.outcome, self.trust, self.degraded = prediction, outcome, trust, False


def _online(P):
    root = P.name
    return types.SimpleNamespace(**{n: __import__(f"{root}.online.{n}", fromlist=[n])
                                    for n in ("capture", "classes", "drift")})


def _online_metric(P, name, **labels):
    if P.name == "mgproto_tpu":
        from mgproto_tpu.telemetry.registry import default_registry

        return default_registry().counter(name).value(**labels)
    return tmetrics.counter(name).value(**labels)


def sc_head_drift_monitor(P):
    """drift_config: the tenant's served scores feed its own monitor, which
    breaches on that tenant's shifted scores only; a swap rebases it."""
    O = _online(P)
    clock = FakeClock()
    d = P.tenants.TenantDirectory(clock=clock)
    cfg = O.drift.DriftConfig(px_window=64, min_px_samples=16, eval_interval_s=0.5,
                              px_divergence_threshold=0.6, mean_shift_threshold=0.0)
    for t in ("calm", "storm"):
        d.mount(t, _calib(P), drift_config=cfg)
    rng = np.random.RandomState(0)
    for i, s in enumerate(rng.randn(48)):
        clock.advance(0.05)
        d.on_response(None, _Resp(f"c{i}", float(s - 2.0), "calm"))
        d.on_response(None, _Resp(f"s{i}", float(s - 5.0), "storm"))
    calm, storm = d.head_for("calm").drift, d.head_for("storm").drift
    trace = [calm.breaches, storm.breaches, storm.first_breach.to_dict()["signals"],
             round(storm.last_report.px_divergence, 6),
             _online_metric(P, "drift_breach_total", signal="px", tenant="storm"),
             _online_metric(P, "drift_breach_total", signal="px", tenant="calm")]
    assert calm.breaches == 0 and storm.breaches > 0
    d.swap("storm", _calib(P, seed=4))
    trace += [storm.first_breach, len(storm._scores)]
    return trace


def sc_head_capture_reservoir(P):
    """capture_config: the tenant's trusted high-p(x) responses stage in its
    own reservoir (tenant-labeled counters); a swap retargets its gate."""
    O = _online(P)
    d = P.tenants.TenantDirectory(clock=FakeClock())
    cap = O.capture.CaptureConfig(percentile=25.0, capacity_per_class=2, seed=0)
    d.mount("a", _calib(P), capture_config=cap, num_classes=4)
    d.mount("b", _calib(P))
    with pytest.raises(ValueError, match="num_classes"):
        d.mount("c", _calib(P), capture_config=cap)
    head = d.head_for("a").capture
    t0 = head.threshold
    for i, s in enumerate(np.linspace(-4.0, 2.0, 12)):
        payload = np.full((IMG, IMG, 3), i, np.float32)
        d.on_response(payload, _Resp(f"a{i}", float(s), "a", prediction=i % 4))
        d.on_response(payload, _Resp(f"b{i}", float(s), "b", prediction=i % 4))
    d.on_response(None, _Resp("x", 9.0, "a", outcome="abstain", trust="abstain"))
    trace = [head.stats(), head.was_captured("a11"), head.was_captured("a0"),
             [(s.class_id, s.request_id) for s in head.drain()],
             _online_metric(P, "online_capture_total", outcome="accepted", tenant="a"),
             _online_metric(P, "online_capture_total", outcome="gate_rejected", tenant="a"),
             _online_metric(P, "online_capture_total", outcome="outcome_skipped", tenant="a"),
             d.head_for("b").capture]
    d.swap("a", _calib(P, seed=4))
    assert head.threshold != t0
    return trace + [round(head.threshold, 9)]


def sc_head_class_slots(P):
    """class_names: a mount claims padded class slots through the class
    directory (an existing name reuses its slot; slots stay claimed after an
    unmount); without a class directory the names are refused."""
    O = _online(P)
    cd = O.classes.ClassDirectory(4, 8)
    d = P.tenants.TenantDirectory(clock=FakeClock(), class_directory=cd)
    r1 = d.mount("a", _calib(P), class_names=("x", "y")).to_dict()
    r2 = d.mount("b", _calib(P), class_names=("y", "z")).to_dict()
    d.unmount("a")
    trace = [r1["class_slots"], r2["class_slots"], cd.active_classes, cd.free_slots,
             cd.slot_of("x"), d.head_for("b").class_slots]
    with pytest.raises(ValueError, match="class-bucket"):
        P.tenants.TenantDirectory().mount("c", _calib(P), class_names=("w",))
    return trace


@pytest.mark.parametrize("scenario", [sc_head_drift_monitor, sc_head_capture_reservoir,
                                      sc_head_class_slots],
                         ids=["drift_config", "capture_config", "class_names"])
def test_online_head_state_mounts_as_in_jax(scenario):
    """A head's online state (drift monitor, capture reservoir, class slots)
    on both packages: the traces must be equal."""
    traces = {}
    for name in PKGS:
        jax_set_registry(JaxMetricRegistry())
        tmetrics.set_current_registry(None)
        traces[name] = scenario(MODS[name])
    assert traces["torch"] == traces["jax"]


def test_a_jax_calibration_mounts_degraded_and_its_swap_is_refused():
    """The port's fingerprint is its own sha256, so a head measured by the
    JAX package under the same weights is refused (fail closed)."""
    tcal = MODS["torch"].calibration
    jcal = _calib(MODS["jax"])
    as_port = tcal.Calibration.from_dict(json.loads(jcal.to_json()))
    d = MODS["torch"].tenants.TenantDirectory()
    d.mount("j", as_port, expected_fingerprint="the-port's-own-fingerprint")
    assert d.gate_for("j").degraded and d.gate_for("j").fingerprint_mismatch
    rep = d.swap("j", as_port, expected_fingerprint="the-port's-own-fingerprint")
    assert (rep.ok, rep.reason) == (False, "fingerprint_mismatch")
