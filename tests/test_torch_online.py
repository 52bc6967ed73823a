"""The port's online plane (mgproto_tpu_torch/online/, obs/flightrec.py)
against the JAX package's (mgproto_tpu/online/), on the CPU: the scenarios
of tests/test_online.py on both packages.

  * Trusted capture: every accept/reject/evict decision of one seeded
    stream, the reservoirs' contents and the recalibration holdout equal
    the JAX package's, decision for decision; the unit scenarios of
    test_online.py return equal traces.
  * Class bucket and directory, drift monitor (numpy on both sides): equal.
  * Consolidation: the JAX `booted` fixture (the tiny model with
    class_bucket=8, 20 epochs x 4 classes x 8 labeled samples at width 8)
    and the port's Consolidator from JAX's initial weights (models/
    convert.py `from_jax_train_state`) on the same samples: means within
    1e-4, priors within 1e-5, banks within 1e-4 with equal lengths; then
    the same class addition on both.
  * Recalibration bit-identical on an unchanged bank, thresholds within
    1e-4 of JAX's; a republish that round-trips the TrustGate; served
    logits bit-equal while the candidate moves; a Republisher commit
    through `hot_swap` whose answers equal `ServingEngine.from_live` on the
    candidate; a failed recalibration counted as a refusal, as in JAX.
  * No blocking sleep in mgproto_tpu_torch/online/; the online metric
    family registered under the JAX names and help strings; the flight
    recorder; `cli.online status` refused.
"""

import dataclasses
import importlib.util
import ast
import os
import types

import jax
import numpy as np
import pytest
import torch

from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu_torch.serving import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "torch")
MEANS_ATOL = 1e-4
PRIORS_ATOL = 1e-5
BANK_ATOL = 1e-4
THRESH_ATOL = 1e-4


def _mods(root):
    ns = types.SimpleNamespace(name=root)
    for n in ("capture", "classes", "drift", "metrics", "republish"):
        setattr(ns, n, __import__(f"{root}.online.{n}", fromlist=[n]))
    ns.calibration = __import__(f"{root}.serving.calibration", fromlist=["calibration"])
    ns.flightrec = __import__(f"{root}.obs.flightrec", fromlist=["flightrec"])
    return ns


MODS = {"jax": _mods("mgproto_tpu"), "torch": _mods("mgproto_tpu_torch")}


@pytest.fixture(autouse=True)
def fresh_registries():
    prev_t = tmetrics.set_current_registry(None)
    prev_j = jax_set_registry(JaxMetricRegistry())
    yield
    jax_set_registry(prev_j)
    tmetrics.set_current_registry(prev_t)


def both(scenario):
    out = {}
    for name in PKGS:
        jax_set_registry(JaxMetricRegistry())
        tmetrics.set_current_registry(None)
        out[name] = scenario(MODS[name])
    return out


class _Resp:
    def __init__(self, outcome="predict", trust="in_dist", log_px=1.0, prediction=0,
                 degraded=False, request_id="r0"):
        self.outcome, self.trust, self.log_px = outcome, trust, log_px
        self.prediction, self.degraded, self.request_id = prediction, degraded, request_id


def _calib(P, scores=None, fingerprint="fp0", n_classes=4):
    rng = np.random.RandomState(0)
    scores = rng.randn(256) if scores is None else np.asarray(scores)
    logits = rng.randn(scores.size, n_classes)
    return P.calibration.Calibration.from_scores(scores, logits, fingerprint)


def _capture(P, **kw):
    cfg = P.capture.CaptureConfig(**{"percentile": 25.0, "capacity_per_class": 4, "seed": 0, **kw})
    return P.capture.TrustedCapture(_calib(P), num_classes=4, config=cfg)


# ------------------------------------------------------------------ capture
def test_capture_decisions_equal_jax_on_a_seeded_stream():
    """600 seeded responses (every outcome kind, scores around the gate,
    classes in and out of range, labeled feedback): each decision, the
    queues, the holdout and the counters equal the JAX package's."""

    def run(P):
        cap = _capture(P, capacity_per_class=5, recal_capacity=16, seed=3)
        rng = np.random.RandomState(11)
        kinds = ("predict", "predict", "predict", "abstain", "reject", "shed")
        decisions = []
        for i in range(600):
            if i % 37 == 0:
                decisions.append(cap.submit_labeled(np.full(3, i), int(rng.randint(-1, 6)),
                                                    request_id=f"l{i}"))
                continue
            resp = _Resp(outcome=kinds[rng.randint(len(kinds))],
                         trust="in_dist" if rng.rand() < 0.9 else "abstain",
                         log_px=None if rng.rand() < 0.02 else float(rng.randn()),
                         prediction=int(rng.randint(-1, 6)), degraded=bool(rng.rand() < 0.05),
                         request_id=f"r{i}")
            decisions.append(cap.on_response(np.full(3, i), resp))
        queues = {c: [s.request_id for s in q] for c, q in cap._queues.items()}
        recal = [s.request_id for s in cap.recal_samples()]
        stats = cap.stats()
        drained = [(s.class_id, s.request_id, s.labeled) for s in cap.drain()]
        counts = {o: P.metrics.counter(P.metrics.CAPTURED).value(outcome=o)
                  for o in ("accepted", "gate_rejected", "outcome_skipped", "class_unknown",
                            "labeled")}
        return [decisions, queues, recal, stats, drained, counts, cap.evicted,
                cap.was_captured("r5"), cap.staged_count()]

    traces = both(run)
    assert traces["torch"] == traces["jax"]
    assert sum(traces["torch"][0]) > 20 and traces["torch"][6] > 0


def sc_accepts_trusted_high_px(P):
    cap = _capture(P)
    ok = cap.on_response(np.zeros((2, 2, 3)), _Resp(log_px=cap.threshold + 1.0, request_id="a"))
    assert ok and cap.staged_count() == 1 and cap.was_captured("a")
    return [ok, cap.staged_count()]


def sc_rejects_below_gate_and_at_threshold(P):
    cap = _capture(P)
    out = [cap.on_response(np.zeros(3), _Resp(log_px=cap.threshold - 1.0)),
           cap.on_response(np.zeros(3), _Resp(log_px=cap.threshold))]
    assert out == [False, False] and cap.staged_count() == 0
    return out


def sc_untrusted_outcomes_never_stage(P):
    out = []
    for resp in (_Resp(outcome="abstain", trust="abstain"), _Resp(outcome="reject"),
                 _Resp(outcome="shed"), _Resp(degraded=True), _Resp(trust="ungated"),
                 _Resp(log_px=None)):
        cap = _capture(P)
        out.append([cap.on_response(np.zeros(3), resp), cap.staged_count()])
    assert all(o == [False, 0] for o in out)
    return out


def sc_unknown_class_rejected(P):
    cap = _capture(P)
    return [cap.on_response(np.zeros(3), _Resp(log_px=10.0, prediction=99)),
            P.metrics.counter(P.metrics.CAPTURED).value(outcome="class_unknown")]


def sc_reservoir_bounds_and_counts_evictions(P):
    cap = _capture(P, capacity_per_class=4)
    for i in range(20):
        cap.on_response(np.full(3, i), _Resp(log_px=10.0, request_id=f"r{i}"))
    assert cap.staged_count() == 4 and cap.accepted == 20 and 0 < cap.evicted <= 16
    return [cap.evicted, [s.request_id for s in cap.drain()]]


def sc_labeled_feedback_bypasses_gate(P):
    cap = _capture(P)
    out = [cap.submit_labeled(np.zeros(3), 2, request_id="fb"), cap.staged_count(),
           cap.submit_labeled(np.zeros(3), 99)]
    assert out == [True, 1, False]
    return out


def sc_drain_clears_recal_holdout_persists(P):
    cap = _capture(P)
    for i in range(6):
        cap.on_response(np.full(3, i), _Resp(log_px=10.0, request_id=f"r{i}", prediction=i % 4))
    held = len(cap.recal_samples())
    drained = cap.drain()
    assert cap.staged_count() == 0 and len(cap.recal_samples()) == held > 0
    return [len(drained), held, [b[1].tolist() for b in cap.recal_batches(4)]]


def sc_retarget_moves_gate_threshold(P):
    cap = _capture(P)
    t0 = cap.threshold
    cap.retarget(_calib(P, scores=np.random.RandomState(1).randn(256) + 5))
    assert cap.threshold != t0
    cap.retarget(None)
    return [t0, cap.threshold]


def sc_tap_install_restore(P):
    cap = _capture(P)
    prev = P.capture.install(cap)
    try:
        assert P.capture.get_active() is cap
    finally:
        P.capture.install(prev)
    return [P.capture.get_active() is prev]


CAPTURE_SCENARIOS = [sc_accepts_trusted_high_px, sc_rejects_below_gate_and_at_threshold,
                     sc_untrusted_outcomes_never_stage, sc_unknown_class_rejected,
                     sc_reservoir_bounds_and_counts_evictions, sc_labeled_feedback_bypasses_gate,
                     sc_drain_clears_recal_holdout_persists, sc_retarget_moves_gate_threshold,
                     sc_tap_install_restore]


@pytest.mark.parametrize("scenario", CAPTURE_SCENARIOS,
                         ids=[f.__name__[3:] for f in CAPTURE_SCENARIOS])
def test_capture_scenarios_equal_jax(scenario):
    traces = both(scenario)
    assert traces["torch"] == traces["jax"]


# ------------------------------------------------------------- class bucket
def test_padded_num_classes_and_apply_class_bucket():
    from mgproto_tpu.config import tiny_test_config as jtiny
    from mgproto_tpu_torch.config import tiny_test_config

    for P, tiny in ((MODS["jax"], jtiny), (MODS["torch"], tiny_test_config)):
        f = P.classes.padded_num_classes
        assert [f(4, 0), f(4, 1), f(4, 8), f(8, 8), f(9, 8)] == [4, 4, 8, 8, 16]
        cfg = tiny()
        assert P.classes.apply_class_bucket(cfg) is cfg
        cfg2 = cfg.replace(model=dataclasses.replace(cfg.model, class_bucket=8))
        assert P.classes.apply_class_bucket(cfg2).model.num_classes == 8
    assert tiny_test_config().model.class_bucket == 0


def test_directory_add_until_bucket_full():
    def run(P):
        d = P.classes.ClassDirectory(4, 6)
        out = [d.active_classes, d.free_slots, d.add_class("x"), d.add_class(), d.slot_of("x"),
               d.slot_of("nope"), P.metrics.gauge(P.metrics.ACTIVE_CLASSES).value(),
               P.metrics.counter(P.metrics.CLASS_ADDITIONS).value()]
        with pytest.raises(P.classes.ClassBucketFull):
            d.add_class()
        with pytest.raises(ValueError):
            P.classes.ClassDirectory(4, 3)
        return out

    traces = both(run)
    assert traces["torch"] == traces["jax"] == [[4, 2, 4, 5, 4, None, 6.0, 2.0]][0]


def test_floor_and_claim_priors_equal_jax():
    from mgproto_tpu.config import tiny_test_config as jtiny
    from mgproto_tpu.core.mgproto import init_gmm as jinit
    from mgproto_tpu_torch.core.mgproto import GMMState

    jgmm = jinit(jtiny(num_classes=6).model, jax.random.PRNGKey(0))
    tgmm = GMMState(*(torch.from_numpy(np.array(t)) for t in jgmm))
    J, T = MODS["jax"].classes, MODS["torch"].classes
    jgmm, tgmm = J.floor_padded_priors(jgmm, 4), T.floor_padded_priors(tgmm, 4)
    priors = tgmm.priors.numpy()
    assert (priors[4:] == 0.0).all() and (priors[:4] > 0).all()
    np.testing.assert_array_equal(priors, np.asarray(jgmm.priors))
    jgmm, tgmm2 = J.claim_slot(jgmm, 4), T.claim_slot(tgmm, 4)
    np.testing.assert_array_equal(tgmm2.priors.numpy(), np.asarray(jgmm.priors))
    assert (tgmm.priors[4] == 0).all()  # a claim copies the priors


# -------------------------------------------------------------------- drift
def _monitor(P, **kw):
    clock = {"t": 0.0}
    cfg = P.drift.DriftConfig(**{"px_window": 128, "min_px_samples": 32, "eval_interval_s": 1.0,
                                 "px_divergence_threshold": 0.3, "mean_shift_threshold": 0.5,
                                 **kw})
    return P.drift.DriftMonitor(_calib(P), cfg, clock=lambda: clock["t"]), clock


def sc_matching_scores_do_not_breach(P):
    mon, clock = _monitor(P)
    for s in np.random.RandomState(0).randn(128):
        mon.observe_px(float(s))
    clock["t"] = 2.0
    rep = mon.evaluate()
    assert not rep.breached and rep.px_divergence < 0.3
    return rep.to_dict()


def sc_shifted_scores_breach_px_signal(P):
    mon, clock = _monitor(P)
    for s in np.random.RandomState(0).randn(128) - 2.0:
        mon.observe_px(float(s))
    clock["t"] = 2.0
    rep = mon.evaluate()
    assert rep.breached and "px" in rep.signals and mon.breaches == 1
    return [rep.to_dict(), P.metrics.counter(P.metrics.DRIFT_BREACHES).value(signal="px"),
            P.metrics.gauge(P.metrics.DRIFT_PX_DIVERGENCE).value()]


def sc_cadence_gating_and_min_samples(P):
    mon, clock = _monitor(P)
    mon.observe_px(0.0)
    mon.observe_px(float("nan"))
    clock["t"] = 0.5
    mon._next_eval = 1.0
    assert mon.evaluate() is None
    clock["t"] = 2.0
    rep = mon.evaluate()
    assert rep.px_divergence is None
    return rep.to_dict()


def sc_bank_shift_against_baseline(P):
    mon, clock = _monitor(P, px_divergence_threshold=0.0, mean_shift_threshold=0.5)
    feats = np.random.RandomState(0).randn(3, 8, 4).astype(np.float32)
    length = np.array([8, 8, 0])
    mon.set_bank_baseline(feats, length)
    moved = feats.copy()
    moved[1] += 1.0
    mon.observe_bank(moved, length)
    clock["t"] = 2.0
    rep = mon.evaluate()
    assert rep.breached and rep.class_shifts[1] == pytest.approx(2.0)
    assert 2 not in rep.class_shifts
    return [rep.to_dict(), P.metrics.gauge(P.metrics.DRIFT_CLASS_SHIFT).value(**{"class": "1"})]


def sc_rebase_resets_window_and_breach_latch(P):
    mon, clock = _monitor(P)
    for s in np.random.RandomState(0).randn(128) - 2.0:
        mon.observe_px(float(s))
    clock["t"] = 2.0
    assert mon.evaluate().breached
    mon.rebase(_calib(P))
    assert mon.first_breach is None and len(mon._scores) == 0
    return [mon.breaches, [e["kind"] for e in P.flightrec.get_recorder().events()][-2:]]


DRIFT_SCENARIOS = [sc_matching_scores_do_not_breach, sc_shifted_scores_breach_px_signal,
                   sc_cadence_gating_and_min_samples, sc_bank_shift_against_baseline,
                   sc_rebase_resets_window_and_breach_latch]


@pytest.mark.parametrize("scenario", DRIFT_SCENARIOS, ids=[f.__name__[3:] for f in DRIFT_SCENARIOS])
def test_drift_scenarios_equal_jax(scenario):
    traces = both(scenario)
    assert traces["torch"] == traces["jax"]


# ------------------------------------------------- consolidation (booted)
def _gen(img, rng):
    def gen(cls, n, drift=0.0):
        xx, yy = np.meshgrid(np.arange(img), np.arange(img), indexing="ij")
        ang = (cls * 45.0 + drift * 30.0) * np.pi / 180.0
        wave = np.cos(2 * np.pi * (cls + 1) * (xx * np.cos(ang) + yy * np.sin(ang)) / img)
        base = np.repeat(wave[..., None].astype(np.float32), 3, axis=2)
        base[..., cls % 3] += 1.0
        return [base + rng.randn(img, img, 3).astype(np.float32) * 0.05 for _ in range(n)]
    return gen


def _boot(cons, gen, CapturedSample):
    for _ in range(20):
        for c in range(4):
            cons.ingest([CapturedSample(p, c, None, "boot", True) for p in gen(c, 8)])


@pytest.fixture(scope="module")
def booted():
    """test_online.py's `booted` on both packages: the padded tiny model
    (class_bucket=8, mean_lr 0.05) from JAX's PRNGKey(0) weights, padded
    priors floored, a width-8 consolidator bootstrapped on the same 640
    labeled samples. The port starts from JAX's weights, carried over."""
    from mgproto_tpu.config import tiny_test_config as jtiny
    from mgproto_tpu.engine.train import Trainer as JaxTrainer
    from mgproto_tpu.online import classes as jcl
    from mgproto_tpu.online.capture import CapturedSample as JSample
    from mgproto_tpu.online.consolidate import Consolidator as JCons
    from mgproto_tpu.online.consolidate import ConsolidatorConfig as JConsCfg
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.models.convert import from_jax_train_state
    from mgproto_tpu_torch.online import classes as tcl
    from mgproto_tpu_torch.online.capture import CapturedSample as TSample
    from mgproto_tpu_torch.online.consolidate import Consolidator, ConsolidatorConfig
    from mgproto_tpu_torch.online.drill import drill_config

    jcfg = jtiny()
    jcfg = jcl.apply_class_bucket(jcfg.replace(
        model=dataclasses.replace(jcfg.model, class_bucket=8),
        em=dataclasses.replace(jcfg.em, mean_lr=0.05)))
    jtrainer = JaxTrainer(jcfg, steps_per_epoch=1)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0))
    jstate0 = jax.device_get(jstate)
    jstate = jstate.replace(gmm=jcl.floor_padded_priors(jstate.gmm, 4))
    jcons = JCons(jtrainer, jstate, config=JConsCfg(batch_width=8))
    _boot(jcons, _gen(32, np.random.RandomState(0)), JSample)

    cfg = drill_config(8)
    trainer = Trainer(cfg, steps_per_epoch=1, device="cpu")
    state = from_jax_train_state(jstate0, cfg, device="cpu")
    state.gmm = tcl.floor_padded_priors(state.gmm, 4)
    cons = Consolidator(trainer, state, config=ConsolidatorConfig(batch_width=8))
    _boot(cons, _gen(32, np.random.RandomState(0)), TSample)
    return {"cfg": cfg, "trainer": trainer, "state": state, "cons": cons,
            "snapshot": cons.candidate_state(state), "gen": _gen(32, np.random.RandomState(7)),
            "jtrainer": jtrainer, "jstate": jstate, "jcons": jcons,
            "jsnapshot": jcons.candidate_state(jstate), "JSample": JSample, "TSample": TSample}


def _assert_candidate_matches(cons, jcons):
    np.testing.assert_allclose(cons.gmm.means.detach().numpy(), np.asarray(jcons.gmm.means),
                               rtol=0, atol=MEANS_ATOL)
    np.testing.assert_allclose(cons.gmm.priors.numpy(), np.asarray(jcons.gmm.priors),
                               rtol=0, atol=PRIORS_ATOL)
    feats, length = cons.bank_arrays()
    jfeats, jlength = np.asarray(jcons.memory.feats), np.asarray(jcons.memory.length)
    np.testing.assert_array_equal(length, jlength)
    np.testing.assert_array_equal(cons.memory.cursor.numpy(), np.asarray(jcons.memory.cursor))
    np.testing.assert_allclose(feats, jfeats, rtol=0, atol=BANK_ATOL)


def test_bootstrap_consolidation_matches_jax(booted):
    cons, jcons = booted["cons"], booted["jcons"]
    assert cons.runs == jcons.runs == 80 and cons.samples_consolidated == 640
    assert [r.em_active_max for r in cons.reports] == [r.em_active_max for r in jcons.reports]
    assert [r.compact_fallbacks for r in cons.reports] == \
        [r.compact_fallbacks for r in jcons.reports]
    _assert_candidate_matches(cons, jcons)


def test_bootstrap_fits_a_real_classifier(booted):
    trainer, gen, snap = booted["trainer"], booted["gen"], booted["snapshot"]
    correct = 0
    for c in range(4):
        out = trainer.eval_step(snap, np.stack(gen(c, 8)))
        correct += int((out.logits.argmax(-1) == c).sum())
    assert correct / 32 >= 0.9


def test_consolidation_keeps_one_input_shape(booted):
    """The port's meaning of "compiles exactly once": no batch at another
    shape and no kernel build after the first batch."""
    cons = booted["cons"]
    assert cons.steady_recompiles() == 0 and cons.batches == 80 and cons._shape == (8, 32, 32, 3)


def test_padded_slots_never_win_argmax(booted):
    trainer, gen, snap = booted["trainer"], booted["gen"], booted["snapshot"]
    for c in range(4):
        out = trainer.eval_step(snap, np.stack(gen(c, 8)))
        assert int(out.logits.argmax(-1).max()) < 4
        assert torch.isinf(out.logits[:, 4:]).all()


def test_the_candidate_is_a_copy(booted):
    """The consolidator shares no mixture, bank or optimizer tensor with
    the serving state; the snapshot shares none with the consolidator."""
    state, cons, snap = booted["state"], booted["cons"], booted["snapshot"]
    for a, b in ((state.gmm, cons.gmm), (state.memory, cons.memory), (cons.gmm, snap.gmm),
                 (cons.memory, snap.memory)):
        for x, y in zip(a, b):
            assert x.data_ptr() != y.data_ptr()
    assert cons.mean_opt.param_groups[0]["params"][0] is cons.gmm.means
    st = cons.mean_opt.state[cons.gmm.means]
    assert st["exp_avg"].data_ptr() != snap.mean_opt.state[snap.gmm.means]["exp_avg"].data_ptr()
    assert snap.model is state.model
    assert int(state.memory.length.sum()) == 0  # the serving bank never moved


# ------------------------------------------------------------ recalibration
def _id_batches(gen):
    return [(np.stack(gen(c, 4)), np.full((4,), c, np.int32)) for c in range(4)]


def test_recalibration_bit_identical_and_thresholds_match_jax(booted):
    from mgproto_tpu.serving.calibration import calibrate as jcalibrate
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.serving.calibration import calibrate

    snap = booted["snapshot"]
    batches = _id_batches(_gen(32, np.random.RandomState(5)))
    ev = Evaluator(snap.model, snap.gmm, booted["cfg"], device="cpu")
    a = calibrate(ev, [x for x, _ in batches])
    b = calibrate(ev, [x for x, _ in batches])
    assert a.to_dict() == b.to_dict() and a.gmm_fingerprint == b.gmm_fingerprint
    j = jcalibrate(booted["jtrainer"], booted["jsnapshot"], batches)
    assert set(a.thresholds) == set(j.thresholds)
    for k in j.thresholds:
        assert abs(a.thresholds[k] - j.thresholds[k]) <= THRESH_ATOL
    np.testing.assert_allclose(a.quantile_log_px, j.quantile_log_px, rtol=0, atol=THRESH_ATOL)
    np.testing.assert_allclose(a.per_class_temperature, j.per_class_temperature, rtol=0,
                               atol=THRESH_ATOL)
    assert a.per_class_temperature[4:] == (1.0,) * 4  # the padded slots' -inf columns


def test_from_scores_handles_padded_inf_columns():
    def run(P):
        rng = np.random.RandomState(0)
        logits = rng.randn(64, 6)
        logits[:, 4:] = -np.inf
        temps = P.calibration.Calibration.from_scores(rng.randn(64), logits,
                                                      "fp").per_class_temperature
        assert np.isfinite(temps).all() and temps[4] == temps[5] == 1.0
        return list(temps)

    traces = both(run)
    np.testing.assert_allclose(traces["torch"], traces["jax"], rtol=1e-12)


def test_republished_state_roundtrips_trustgate(booted):
    """A calibration of the candidate gates the candidate, and fails closed
    against the pre-consolidation mixture, on both packages alike."""
    from mgproto_tpu.serving.calibration import calibrate as jcalibrate
    from mgproto_tpu.serving.engine import ServingEngine as JEngine
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.serving.calibration import calibrate
    from mgproto_tpu_torch.serving.engine import ServingEngine

    cfg, snap, state = booted["cfg"], booted["snapshot"], booted["state"]
    batches = _id_batches(_gen(32, np.random.RandomState(5)))
    ev = Evaluator(snap.model, snap.gmm, cfg, device="cpu")
    calib = calibrate(ev, [x for x, _ in batches])
    good = ServingEngine.from_live(ev, calibration=calib, buckets=(4,))
    stale = ServingEngine.from_live(Evaluator(state.model, state.gmm, cfg, device="cpu"),
                                    calibration=calib, buckets=(4,))
    jcalib = jcalibrate(booted["jtrainer"], booted["jsnapshot"], batches)
    jgood = JEngine.from_live(booted["jtrainer"], booted["jsnapshot"], calibration=jcalib,
                              buckets=(4,))
    jstale = JEngine.from_live(booted["jtrainer"], booted["jstate"], calibration=jcalib,
                               buckets=(4,))
    flags = [(e.gate.degraded, e.gate.fingerprint_mismatch) for e in (good, stale)]
    assert flags == [(e.gate.degraded, e.gate.fingerprint_mismatch) for e in (jgood, jstale)]
    assert flags == [(False, False), (True, True)]


# ----------------------------------------- serving while the candidate moves
def test_served_logits_unchanged_while_the_candidate_moves(booted):
    """An engine over the serving state answers bit for bit the same before
    and after a consolidation (its bank and mixture are not the
    candidate's); the candidate's own snapshot does move."""
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.online.capture import CapturedSample
    from mgproto_tpu_torch.online.consolidate import Consolidator, ConsolidatorConfig
    from mgproto_tpu_torch.serving.engine import ServingEngine

    cfg, trainer, snap = booted["cfg"], booted["trainer"], booted["snapshot"]
    serving = dataclasses.replace(snap)
    eng = ServingEngine.from_live(Evaluator(serving.model, serving.gmm, cfg, device="cpu"),
                                  buckets=(4,))
    gen = _gen(32, np.random.RandomState(9))
    x = np.stack(gen(1, 4))
    before = eng.infer_fn(x)
    cons = Consolidator(trainer, serving, config=ConsolidatorConfig(batch_width=8))
    means0 = cons.gmm.means.detach().clone()
    for _ in range(3):
        cons.ingest([CapturedSample(p, 1, None, "m", True) for p in gen(1, 8, drift=0.5)])
    assert not torch.equal(cons.gmm.means.detach(), means0)
    after = eng.infer_fn(x)
    for k in ("logits", "log_px"):
        np.testing.assert_array_equal(after[k], before[k])
    assert torch.equal(serving.gmm.means, snap.gmm.means)


def test_republisher_commits_through_hot_swap_and_serves_the_candidate(booted):
    """Republisher: two breached evaluations confirm, the candidate is
    recalibrated on an Evaluator with its own copy of the trunk, swapped in
    through hot_swap on 2 replicas, and the fleet then answers what
    `ServingEngine.from_live` on the candidate answers; a failing
    recalibration is a counted refusal that leaves serving as it was."""
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.online import metrics as om
    from mgproto_tpu_torch.online.drift import DriftReport
    from mgproto_tpu_torch.online.republish import Republisher
    from mgproto_tpu_torch.serving.batcher import BatcherConfig
    from mgproto_tpu_torch.serving.calibration import calibrate
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.serving.replica import ReplicaSet

    cfg, state, cons = booted["cfg"], booted["state"], booted["cons"]
    clock = {"t": 0.0}
    now = lambda: clock["t"]  # noqa: E731
    serving_ev = Evaluator(state.model, state.gmm, cfg, device="cpu")
    batches = [x for x, _ in _id_batches(_gen(32, np.random.RandomState(5)))]
    rs = ReplicaSet(lambda: ServingEngine.from_live(serving_ev, calibration=calibrate(
        serving_ev, batches), buckets=(1, 4), clock=now), replicas=2, clock=now,
        batcher_config=BatcherConfig(max_linger_s=0.0))
    rs.start()
    pending = {}

    def recalibrate():
        cand = cons.candidate_state(state)
        import copy

        ev = Evaluator(copy.deepcopy(cand.model), cand.gmm, cfg, device="cpu")
        pending["ev"] = ev
        return calibrate(ev, batches)

    def factory_for(calibration):
        return lambda: ServingEngine.from_live(pending["ev"], calibration=calibration,
                                               buckets=(1, 4), clock=now)

    commits = []
    rep = Republisher(rs, recalibrate, factory_for, clock=now, min_interval_s=1.0,
                      on_commit=commits.append)
    breach = DriftReport(t=0.0, px_divergence=1.0, mean_shift_max=0.0, cov_shift_max=0.0,
                         class_shifts={}, breached=True, signals=("px",))
    quiet = dataclasses.replace(breach, breached=False, signals=())
    assert rep.maybe_republish(breach) is None  # 1 of 2 confirmations
    assert rep.maybe_republish(quiet) is None and rep._consecutive == 0
    assert rep.maybe_republish(breach) is None
    rec = rep.maybe_republish(breach)
    assert rec.result == "committed" and rec.swap["reason"] == "committed" and commits
    assert pending["ev"].model is not state.model
    x = np.stack(_gen(32, np.random.RandomState(9))(2, 4))
    want = ServingEngine.from_live(pending["ev"], calibration=commits[0],
                                   buckets=(1, 4)).serve_all(list(x))
    got = []
    for i, row in enumerate(x):
        got.extend(rs.submit(row, request_id=f"req{i}"))
    got.extend(rs.flush())
    got = sorted(got, key=lambda r: r.request_id)
    assert [(r.prediction, r.log_px, r.trust) for r in got] == \
        [(r.prediction, r.log_px, r.trust) for r in want]
    # the minimum interval, then a recalibration failure: a counted refusal
    assert rep.maybe_republish(breach) is None
    clock["t"] = 5.0
    rep.recalibrate = lambda: (_ for _ in ()).throw(RuntimeError("no samples"))
    rec = rep.maybe_republish(breach)
    assert (rec.result, rec.swap["reason"]) == ("rejected", "recalibrate_failed")
    assert om.counter(om.REPUBLISH).value(result="rejected") == 1.0
    assert om.counter(om.REPUBLISH).value(result="committed") == 1.0
    assert rep.committed == 1 and len(rs.ready_replicas()) == 2


def test_class_addition_keeps_the_shapes_and_matches_jax(booted):
    """A new class claims padded slot 4 and fills through the same batch
    shape on both packages (means, priors and banks held as above); the
    port's consolidator and a serving engine over the candidate see no new
    shape, and the new class is learned."""
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.online.classes import ClassDirectory
    from mgproto_tpu_torch.serving.engine import ServingEngine

    cons, jcons, trainer = booted["cons"], booted["jcons"], booted["trainer"]
    assert ClassDirectory(4, booted["cfg"].model.num_classes).add_class("new") == 4
    cand = cons.candidate_state(booted["state"])
    eng = ServingEngine.from_live(Evaluator(cand.model, cand.gmm, booted["cfg"], device="cpu"),
                                  buckets=(8,))
    eng.warmup()
    cons.claim_class(4)
    jcons.claim_class(4)
    rng_t, rng_j = np.random.RandomState(4), np.random.RandomState(4)
    gen_t, gen_j = _gen(32, rng_t), _gen(32, rng_j)
    for _ in range(12):
        cons.ingest([booted["TSample"](p, 4, None, "fb", True) for p in gen_t(4, 8)])
        jcons.ingest([booted["JSample"](p, 4, None, "fb", True) for p in gen_j(4, 8)])
    _assert_candidate_matches(cons, jcons)
    assert cons.steady_recompiles() == 0
    snap = cons.candidate_state(booted["state"])
    out = trainer.eval_step(snap, np.stack(booted["gen"](4, 8)))
    assert (out.logits.argmax(-1) == 4).float().mean() >= 0.75
    eng.serve_all(list(np.stack(booted["gen"](4, 8))))
    assert eng.check_cold_dispatches() == 0


# ------------------------------------------------------------------- misc
def test_no_blocking_sleep_in_the_online_package():
    spec = importlib.util.spec_from_file_location(
        "check_no_blocking_sleep", os.path.join(REPO, "scripts", "check_no_blocking_sleep.py"))
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    root = os.path.join(REPO, "mgproto_tpu_torch", "online")
    bad = []
    for f in sorted(os.listdir(root)):
        if f.endswith(".py"):
            with open(os.path.join(root, f)) as fh:
                tree = ast.parse(fh.read())
            bad += [f"{f}:{line} {why}" for line, why in lint._offending_calls(tree)]
    assert not bad, bad


def test_online_metrics_registered_under_the_jax_names():
    J, T = MODS["jax"].metrics, MODS["torch"].metrics
    assert T.ALL_COUNTERS == J.ALL_COUNTERS and T.ALL_GAUGES == J.ALL_GAUGES
    assert T.COUNTER_HELP == J.COUNTER_HELP and T.GAUGE_HELP == J.GAUGE_HELP
    reg = tmetrics.MetricRegistry()
    T.register_online_metrics(reg)
    snap = reg.snapshot()
    assert set(snap) == set(J.ALL_COUNTERS + J.ALL_GAUGES)
    text = reg.to_prometheus()
    assert f"# HELP drift_px_divergence {J.GAUGE_HELP['drift_px_divergence']}" in text


def test_flight_recorder_matches_jax():
    """The ring (capacity, sequence numbers, JSON-able fields) and the
    process-current recorder, as in the JAX package."""
    def run(P):
        clock = iter(range(100))
        rec = P.flightrec.FlightRecorder(capacity=3, clock=lambda: next(clock), host=0)
        for i in range(5):
            rec.record("step", i=i, v=np.float32(0.5), obj=object)
        events = [{k: v for k, v in e.items() if k != "pid"} for e in rec.events()]
        prev = P.flightrec.set_recorder(rec)
        P.flightrec.record_event("drift_rebase", t=1)
        assert P.flightrec.get_recorder() is rec
        assert P.flightrec.set_recorder(prev) is rec
        return [events, rec.recorded_total, rec.events()[-1]["kind"]]

    traces = both(run)
    assert traces["torch"] == traces["jax"]
    with pytest.raises(ValueError):
        MODS["torch"].flightrec.FlightRecorder(capacity=0)


def test_cli_online_status_is_refused_and_drill_parses():
    from mgproto_tpu_torch.cli import online as tonline

    # status renders a telemetry directory now (tests/test_torch_telemetry.py
    # holds it against JAX's); a path that is not one is refused
    with pytest.raises(SystemExit, match="not a directory"):
        tonline.main(["status", "somewhere"])
    with pytest.raises(SystemExit) as e:
        tonline.main(["drill", "--help"])
    assert e.value.code == 0
    with pytest.raises(SystemExit):
        tonline.main(["drill", "--drift-kind", "nope"])
