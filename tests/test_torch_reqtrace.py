"""The port's request tracing (mgproto_tpu_torch/obs/reqtrace.py and its 22
hooks in serving/) against the JAX package's, on the CPU.

Each scenario drives both packages' serving planes over the fake model of
tests/test_torch_serving_plane.py on a fake clock, with tracing enabled on
each package's own tracer, and must give the same spans (name, timestamps,
lane, attributes), the same response timings and the same
`serving_stage_seconds` series: a coalesced plane with two replicas,
deadline sheds (frontend span only), the plane's instant events (replica
added, removed, killed by the chaos drill, a swap committed and one
rejected), a context-less dispatch, the stale-context fallback and the
pending-record overflow. Disabled, no response carries timings and no
record is kept; the serve-side summary's stage section renders as JAX's.
"""

import numpy as np
import pytest

from mgproto_tpu.cli import telemetry as jtelemetry
from mgproto_tpu.obs import reqtrace as jreqtrace
from mgproto_tpu.resilience import chaos as jchaos
from mgproto_tpu.telemetry import tracing as jtracing
from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu_torch.cli import telemetry as ttelemetry
from mgproto_tpu_torch.obs import reqtrace as treqtrace
from mgproto_tpu_torch.resilience import chaos as tchaos
from mgproto_tpu_torch.serving import metrics as tmetrics
from mgproto_tpu_torch.telemetry import tracing as ttracing
from test_torch_serving_plane import MODS, FakeClock, make_engine, make_set, payload

CHAOS = {"mgproto_tpu": jchaos, "mgproto_tpu_torch": tchaos}
PACKAGES = {
    "jax": (MODS["jax"], jreqtrace, jtracing),
    "torch": (MODS["torch"], treqtrace, ttracing),
}


@pytest.fixture(autouse=True)
def fresh_state():
    prev_t = tmetrics.set_current_registry(None)
    prev_j = jax_set_registry(JaxMetricRegistry())
    prev_jc, prev_tc = jchaos.set_active(None), tchaos.set_active(None)
    yield
    for rt in (jreqtrace, treqtrace):
        rt.disable()
    jchaos.set_active(prev_jc)
    tchaos.set_active(prev_tc)
    jax_set_registry(prev_j)
    tmetrics.set_current_registry(prev_t)


def _stage_series(P):
    snap = P.metrics.default_registry().snapshot()
    return sorted((tuple(sorted(s["labels"].items())), s.get("count"), s.get("sum"))
                  for s in snap.get(P.metrics.STAGE_SECONDS, {}).get("series", []))


def _spans(tracer):
    return [(s["name"], s["ts"], s["dur"], s["tid"], s["attrs"]) for s in tracer.spans()]


def _both(scenario):
    """Run `scenario(P, rt, clock)` with tracing on for each package;
    returns {name: (result, spans, stage series, pending left)}."""
    out = {}
    for name, (P, rt, tracing) in PACKAGES.items():
        P.metrics.register_serving_metrics(P.metrics.default_registry())
        clock = FakeClock()
        tracer = tracing.Tracer()
        st = rt.enable(clock=clock, tracer=tracer, include_timings=True)
        result = scenario(P, rt, clock)
        out[name] = (result, _spans(tracer), _stage_series(P), dict(st.pending), st.dropped)
        rt.disable()
    return out


def _answers(resps):
    return [(r.request_id, r.outcome, r.reason, r.timings) for r in resps]


def sc_plane(P, rt, clock):
    rs = make_set(P, clock, replicas=2)
    rs.start()
    out = []
    for i in range(6):
        out.extend(rs.submit(payload(i), request_id=f"t{i}"))
        clock.advance(0.004)
        out.extend(rs.poll())
    clock.advance(0.1)
    out.extend(rs.poll())
    out.extend(rs.drain())
    return _answers(out)


def sc_sheds(P, rt, clock):
    rs = make_set(P, clock, replicas=1)
    rs.start()
    out = rs.submit(payload(), request_id="dead", deadline_s=-1.0)
    out += rs.submit(payload(1), request_id="late", deadline_s=0.001)
    clock.advance(0.05)
    out += rs.poll()
    return _answers(out)


def sc_plane_events(P, rt, clock):
    rs = make_set(P, clock, replicas=2)
    rs.start()
    rep = rs.add_replica()
    clock.advance(0.01)
    rs.poll()
    out = rs.remove_replica(rep)
    chaos = CHAOS[P.name]
    chaos.install(chaos.plan_from_env({"MGPROTO_CHAOS_SERVE_REPLICA_KILL_AT": "1"}))
    for i in range(3):
        out += rs.submit(payload(i), request_id=f"k{i}")
        clock.advance(0.02)
        out += rs.poll()
    clock.advance(1.0)  # past the heartbeat timeout: the killed replica fails
    out += rs.poll()
    clock.advance(1.0)
    out += rs.poll()
    out += rs.drain()
    chaos.set_active(None)
    return _answers(out)


def sc_swap(P, rt, clock):
    rs = make_set(P, clock, replicas=2)
    rs.start()
    out = rs.submit(payload(), request_id="s0")
    bad = P.swap.hot_swap(rs, lambda: make_engine(P, clock, calibrated=False, warm=False))
    good = P.swap.hot_swap(rs, lambda: make_engine(P, clock, warm=False))
    clock.advance(0.05)
    out += rs.poll() + rs.drain()
    return _answers(out), (bad.ok, bad.reason), (good.ok, good.reason, good.transferred)


def sc_engine_alone(P, rt, clock):
    """The single-engine batch face: the engine mints at admission and
    dispatches without a batcher's context (its own pop time)."""
    eng = make_engine(P, clock)
    out = []
    for i in range(3):
        out += eng.submit(payload(i), request_id=f"e{i}")
        clock.advance(0.003)
    out += eng.process_pending()
    return _answers(out)


SCENARIOS = [sc_plane, sc_sheds, sc_plane_events, sc_swap, sc_engine_alone]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_spans_timings_and_histograms_equal_jax(scenario):
    runs = _both(scenario)
    assert runs["torch"] == runs["jax"]
    result, spans, series, pending, dropped = runs["torch"]
    assert spans and not pending and dropped == 0


def test_the_plane_traces_every_stage():
    (answers, spans, series, _, _) = _both(sc_plane)["torch"]
    served = [a for a in answers if a[1] in ("predict", "abstain")]
    assert served
    for _, _, _, t in served:
        assert set(t) >= {"total_s", "queue_s", "device_s", "pad_fraction", "replica"}
        assert t["total_s"] >= t["queue_s"] >= 0.0
    names = {s[0] for s in spans}
    assert {"frontend", "batcher", "replica", "engine", "dispatch"} <= names
    assert {dict(k)["stage"] for k, c, _ in series if c} == {"queue", "device", "total"}
    events = {s[0] for s in _both(sc_plane_events)["torch"][1]}
    assert {"replica_added", "replica_removed", "replica_kill", "replica_fail_detected",
            "replica_restart"} <= events
    swap_events = {s[0] for s in _both(sc_swap)["torch"][1]}
    assert {"swap_rejected", "swap_committed"} <= swap_events


def test_a_shed_has_a_frontend_span_only():
    (answers, spans, _, _, _) = _both(sc_sheds)["torch"]
    dead = [s for s in spans if s[4].get("request") == "dead"]
    assert [s[0] for s in dead] == ["frontend"]


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_disabled_is_free(name):
    P, rt, _ = PACKAGES[name]
    clock = FakeClock()
    rs = make_set(P, clock, replicas=1)
    rs.start()
    rs.submit(payload(), request_id="a")
    clock.advance(0.1)
    out = rs.poll()
    assert out and out[0].timings is None and "timings" not in out[0].to_dict()
    assert not rt.enabled() and rt._STATE is None


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_a_cleared_context_uses_the_fallback(name):
    _, rt, tracing = PACKAGES[name]
    clock = FakeClock()
    st = rt.enable(clock=clock, tracer=tracing.Tracer())
    rt.dispatch_context("stale-replica", "bucket_full", 5.0)
    rt.clear_dispatch_context()
    clock.t = 100.0
    rt.mint("r1", now=99.0)
    rt.on_enqueue("r1", 99.0)
    rt.on_dispatch(["r1"], bucket=4, fill=0.25, fallback_t0=99.5)
    rec = st.pending["r1"]
    assert (rec.dispatch, rec.device_s, rec.replica) == (99.5, pytest.approx(0.5), "")


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_pending_overflow_evicts_the_oldest(name, monkeypatch):
    _, rt, _ = PACKAGES[name]
    monkeypatch.setattr(rt, "_MAX_PENDING", 2)
    st = rt.enable(clock=FakeClock())
    for rid in ("a", "b", "c"):
        rt.mint(rid)
    assert set(st.pending) == {"b", "c"} and st.dropped == 1


def test_the_stage_section_renders_as_jax():
    sections = {}
    for name, mod in (("jax", jtelemetry), ("torch", ttelemetry)):
        P, rt, tracing = PACKAGES[name]
        P.metrics.register_serving_metrics(P.metrics.default_registry())
        clock = FakeClock()
        rt.enable(clock=clock, tracer=tracing.Tracer())
        rs = make_set(P, clock, replicas=1)
        rs.start()
        rs.submit(payload(), request_id="a")
        clock.advance(0.1)
        rs.poll()
        rt.disable()
        sections[name] = mod._serving_section(P.metrics.default_registry().snapshot())
    assert sections["torch"] == sections["jax"]
    assert sections["torch"]["stage_seconds"]["total"]["p50"] is not None


def test_the_tracer_lanes_are_per_replica():
    (_, spans, _, _, _) = _both(sc_plane)["torch"]
    lanes = {(s[0], s[3]) for s in spans}
    assert ("frontend", 0) in lanes and ("batcher", 0) in lanes
    replica_tids = {tid for n, tid in lanes if n in ("replica", "engine", "dispatch")}
    assert replica_tids and 0 not in replica_tids
    assert np.all(np.array(sorted(replica_tids)) >= 1)
