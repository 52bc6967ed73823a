"""The port's serving chaos (mgproto_tpu_torch/resilience/chaos.py's serve
and tenant knobs, and the engine, supervisor and swap hooks that read them)
against the JAX package's, on the CPU.

The scenarios of tests/test_chaos_serve.py (malformed and NaN payloads at
seeded rates, a deadline storm, simulated device errors that trip and heal
the circuit breaker, the per-index determinism of the draws) and the
plane's knobs (a replica killed and one wedged at an admitted-request
index, restarted on backoff; a trust-stripped swap artifact refused) run on
BOTH packages, each with its own real ServingEngine over the constant model
of tests/test_torch_serving_plane.py and one fake clock. The draws are
numpy's `default_rng([seed, tag, index])` in both, so the same requests are
hit. Each scenario returns a trace (every response's id, outcome and
reason in order; breaker edges; injection counts; swap reports): the two
packages' traces must be equal, exactly.
"""

import numpy as np
import pytest

from mgproto_tpu.resilience import chaos as jchaos
from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu_torch.resilience import chaos as tchaos
from mgproto_tpu_torch.serving import metrics as tmetrics
from test_torch_autoscale import MODS
from test_torch_serving_plane import PKGS, FakeClock, make_engine, make_set, payload, typed

KINDS = ("serve_malformed", "serve_nan", "serve_device_error", "serve_deadline_storm",
         "serve_replica_kill", "serve_replica_wedge", "serve_swap_bad_artifact")


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


def _injections(P):
    if P.name == "mgproto_tpu":
        from mgproto_tpu.resilience import metrics as rm

        return {k: int(rm.counter(rm.CHAOS_INJECTIONS).value(kind=k)) for k in KINDS}
    got = P.chaos.get_active().injections
    return {k: int(got.get(k, 0)) for k in KINDS}


def sc_chaos_storm_yields_only_typed_responses_and_recovers(P):
    """~25 % malformed, ~15 % NaN, dispatches 2 and 3 raise (the breaker,
    threshold 2, opens), requests 28-35 arrive expired."""
    clock = FakeClock()
    breaker = P.admission.CircuitBreaker(failure_threshold=2, base_delay=5.0, clock=clock)
    eng = make_engine(P, clock, buckets=(1, 2, 4), breaker=breaker)
    P.chaos.install(P.chaos.ChaosPlan(seed=7, serve_malformed_rate=0.25, serve_nan_rate=0.15,
                                      serve_device_errors=(2, 3), serve_storm_at=28,
                                      serve_storm_len=8))
    rng = np.random.RandomState(3)
    out, opened = [], False
    for i in range(48):
        out.extend(eng.submit(rng.rand(8, 8, 3).astype(np.float32), request_id=f"c{i}"))
        if i % 4 == 3:
            out.extend(eng.process_pending())
        if breaker.state == "open" and not opened:
            opened = True
            out.extend(eng.process_pending())
            clock.advance(6.0)
        clock.advance(0.01)
    while len(eng.queue):
        out.extend(eng.process_pending())
    assert sorted(r.request_id for r in out) == sorted(f"c{i}" for i in range(48))
    reasons = {r.reason for r in out if r.outcome == "reject"}
    assert {"bad_shape", "nonfinite", "device_error"} <= reasons
    assert opened and breaker.state == "closed"
    assert sum(r.outcome == "shed" for r in out) >= 8
    edges = [P.metrics.counter(P.metrics.BREAKER_TRANSITIONS).value(edge=e)
             for e in ("closed->open", "open->half_open", "half_open->closed")]
    assert min(edges) >= 1
    if P.name == "mgproto_tpu_torch":  # every dispatch at a warmed bucket
        assert eng.check_cold_dispatches() == 0
    inj = _injections(P)
    assert inj["serve_device_error"] == 2 and inj["serve_deadline_storm"] == 8
    return typed(out) + edges + [inj, P.metrics.counter(P.metrics.DEVICE_ERRORS).value()]


def sc_serve_chaos_is_deterministic_per_index(P):
    img = np.zeros((4, 4, 3), np.float32)
    a = P.chaos.ChaosState(P.chaos.ChaosPlan(seed=11, serve_malformed_rate=0.3,
                                             serve_nan_rate=0.3))
    c = P.chaos.ChaosState(P.chaos.ChaosPlan(seed=12, serve_malformed_rate=0.3,
                                             serve_nan_rate=0.3))
    kinds = []
    for state in (a, c):
        row = []
        for i in range(64):
            out = state.serve_corrupt_request(i, img)
            row.append("malformed" if out.shape != img.shape else
                       "nan" if np.isnan(out).all() else "clean")
        kinds.append(row)
    assert kinds[0] != kinds[1]  # another seed, another schedule
    return kinds


def sc_nan_injection_passes_through_uncoercible_payloads(P):
    st = P.chaos.ChaosState(P.chaos.ChaosPlan(seed=0, serve_nan_rate=1.0))
    ragged = [[1.0, 2.0], [3.0]]
    assert st.serve_corrupt_request(0, ragged) is ragged
    out = st.serve_corrupt_request(1, np.zeros((2, 2, 3), np.float32))
    assert np.isnan(out).all()
    return [out.shape]


def sc_device_error_fires_once_per_index(P):
    st = P.chaos.ChaosState(P.chaos.ChaosPlan(serve_device_errors=(5,)))
    return [st.serve_device_error_due(4), st.serve_device_error_due(5),
            st.serve_device_error_due(5)]


def sc_serve_plan_from_env(P):
    plan = P.chaos.plan_from_env({
        "MGPROTO_CHAOS_SERVE_MALFORMED_RATE": "0.1", "MGPROTO_CHAOS_SERVE_NAN_RATE": "0.05",
        "MGPROTO_CHAOS_SERVE_DEVICE_ERRORS": "3,9", "MGPROTO_CHAOS_SERVE_STORM_AT": "20",
        "MGPROTO_CHAOS_SERVE_STORM_LEN": "4"})
    st = P.chaos.ChaosState(plan)
    return [plan.any_active(), plan.serve_malformed_rate, plan.serve_nan_rate,
            plan.serve_device_errors, [st.serve_storm_due(i) for i in (19, 20, 23, 24)]]


def sc_replica_kill_and_wedge_restart_typed(P):
    """MGPROTO_CHAOS_SERVE_REPLICA_KILL_AT=3 and _WEDGE_AT=9 on a 3-replica
    plane: each request still answered typed, the two replicas detected by
    their stale heartbeats, drained, and restarted on backoff."""
    clock = FakeClock()
    rs = make_set(P, clock, replicas=3, factory=lambda: make_engine(P, clock, capacity=8))
    rs.start()
    P.chaos.install(P.chaos.plan_from_env({"MGPROTO_CHAOS_SERVE_REPLICA_KILL_AT": "3",
                                           "MGPROTO_CHAOS_SERVE_WEDGE_AT": "9"}))
    out, states = [], []
    for i in range(24):
        out.extend(rs.submit(payload(i), request_id=f"k{i}"))
        out.extend(rs.poll())
        states.append([r.state for r in rs.replicas])
        clock.advance(0.1)
    for _ in range(20):
        out.extend(rs.poll())
        clock.advance(0.1)
    out.extend(rs.flush())
    assert sorted(r.request_id for r in out) == sorted(f"k{i}" for i in range(24))
    assert all(r.state == "ready" and r.alive and not r.wedged for r in rs.replicas)
    restarts = [P.metrics.counter(P.metrics.REPLICA_RESTARTS).value(reason=k)
                for k in ("dead", "wedged")]
    assert restarts == [1, 1]
    return typed(out) + states + restarts + [_injections(P)]


def sc_swap_bad_artifact_refused_then_committed(P):
    clock = FakeClock()
    rs = make_set(P, clock, replicas=2)
    rs.start()
    P.chaos.install(P.chaos.plan_from_env({"MGPROTO_CHAOS_SERVE_SWAP_BAD_ARTIFACT": "1"}))
    factory = lambda: make_engine(P, clock, capacity=8, warm=False)  # noqa: E731
    reports = [P.swap.hot_swap(rs, factory).to_dict() for _ in range(2)]
    assert [r["reason"] for r in reports] == ["uncalibrated", "committed"]
    return reports + [_injections(P)]


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


def test_serve_main_installs_the_environments_plan_and_removes_it(monkeypatch):
    """cli.serve reads the knobs before anything is served (an unported
    one raises there) and leaves no plan active after it returns."""
    from mgproto_tpu_torch.cli import serve as tserve

    monkeypatch.setenv("MGPROTO_CHAOS_LOADER_IO_RATE", "0.5")
    with pytest.raises(ValueError, match="LOADER_IO_RATE.*A9"):
        tserve.main(["--device", "cpu", "--artifact", "/nonexistent.mgproto"])
    monkeypatch.delenv("MGPROTO_CHAOS_LOADER_IO_RATE")
    monkeypatch.setenv("MGPROTO_CHAOS_SERVE_DEVICE_ERRORS", "0")
    with pytest.raises(Exception):
        tserve.main(["--device", "cpu", "--artifact", "/nonexistent.mgproto"])
    assert tchaos.get_active() is None


def test_serve_main_installs_the_poison_knobs(monkeypatch):
    """MGPROTO_CHAOS_TENANT_POISON_RATE and _ONLINE_POISON_RATE (refused
    before the online plane was ported) reach the plan cli.serve installs,
    and leave with it."""
    from mgproto_tpu_torch.cli import serve as tserve

    seen = []
    monkeypatch.setattr(tserve, "_main_batch_engine",
                        lambda args, handler, split: seen.append(tchaos.get_active().plan))
    monkeypatch.setenv("MGPROTO_CHAOS_TENANT_POISON_RATE", "0.5")
    monkeypatch.setenv("MGPROTO_CHAOS_ONLINE_POISON_RATE", "0.25")
    tserve.main(["--device", "cpu", "--artifact", "/nonexistent.mgproto"])
    assert (seen[0].tenant_poison_rate, seen[0].online_poison_rate) == (0.5, 0.25)
    assert tchaos.get_active() is None
