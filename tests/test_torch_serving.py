"""The port's serving engine, on the CPU, against the JAX package's.

One tiny JAX model is carried into the port with `from_jax_variables`; the
port serves it through `ServingEngine.from_live(Evaluator(...))` and the
JAX package through its own `ServingEngine.from_live(trainer, state)`.
Tolerance for served log p(x): atol 1e-3, rtol 1e-4 (CPU convolution
summation order, as in tests/test_torch_model.py).
"""

import functools

import jax
import numpy as np
import pytest

from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.engine.train import Trainer
from mgproto_tpu.serving.calibration import gmm_fingerprint as jax_gmm_fingerprint
from mgproto_tpu.serving.engine import ServingEngine as JaxServingEngine
from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.core.mgproto import MGProtoFeatures
from mgproto_tpu_torch.engine.eval import Evaluator
from mgproto_tpu_torch.models.convert import from_jax_variables
from mgproto_tpu_torch.serving import metrics as sm
from mgproto_tpu_torch.serving.admission import CircuitBreaker
from mgproto_tpu_torch.serving.calibration import Calibration, calibrate, gmm_fingerprint
from mgproto_tpu_torch.serving.engine import ServingEngine
from mgproto_tpu_torch.serving.gate import TRUST_ABSTAIN, TRUST_IN_DIST, TRUST_UNGATED
from mgproto_tpu_torch.serving.response import (
    OUTCOME_ABSTAIN,
    OUTCOME_PREDICT,
    OUTCOME_REJECT,
    OUTCOME_SHED,
)

IMG = 32


@pytest.fixture(autouse=True)
def fresh_registries():
    prev = sm.set_current_registry(None)
    prev_j = jax_set_registry(JaxMetricRegistry())
    yield
    sm.set_current_registry(prev)
    jax_set_registry(prev_j)


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = jax_tiny_config()
    trainer = Trainer(cfg, steps_per_epoch=1)
    state = trainer.init_state(jax.random.PRNGKey(0))
    sd, gmm = from_jax_variables(
        {"params": state.params["net"], "batch_stats": state.batch_stats},
        jax.device_get(state.gmm),
    )
    tcfg = tiny_test_config()
    model = MGProtoFeatures(tcfg.model)
    model.load_state_dict(sd, strict=True)
    return trainer, state, Evaluator(model, gmm, tcfg, device="cpu")


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3)).astype(np.float32)


def _engine(**kw):
    return ServingEngine.from_live(_setup()[2], **kw)


def test_every_id_answered_once_with_typed_rejects():
    eng = _engine(buckets=(1, 2, 4))
    eng.warmup()
    payloads = list(_images(5)) + [
        np.zeros((IMG, IMG), np.float32),  # bad shape
        np.full((IMG, IMG, 3), np.nan, np.float32),  # non-finite
        "not an image",  # non-numeric
        np.full((IMG, IMG, 3), 1e6, np.float32),  # out of range
    ]
    resps = eng.serve_all(payloads)
    assert [r.request_id for r in resps] == [f"req{i}" for i in range(9)]
    assert [r.outcome for r in resps[:5]] == [OUTCOME_PREDICT] * 5
    assert [(r.outcome, r.reason) for r in resps[5:]] == [
        (OUTCOME_REJECT, "bad_shape"), (OUTCOME_REJECT, "nonfinite"),
        (OUTCOME_REJECT, "bad_dtype"), (OUTCOME_REJECT, "out_of_range"),
    ]
    assert eng.dispatch_count == 2  # 5 requests: a bucket of 4, then 1
    assert sm.counter(sm.REQUESTS).value(outcome=OUTCOME_REJECT) == 4


def test_bucket_padding_leaves_results_unchanged():
    imgs = list(_images(3, seed=1))
    padded = _engine(buckets=(8,)).serve_all(imgs)
    single = _engine(buckets=(1,)).serve_all(imgs)
    for a, b in zip(padded, single):
        assert a.prediction == b.prediction
        np.testing.assert_allclose(a.log_px, b.log_px, rtol=1e-5, atol=1e-5)


def test_degraded_without_calibration_and_abstains_below_threshold():
    ev = _setup()[2]
    resps = _engine().serve_all(list(_images(2)))
    assert all(r.degraded and r.trust == TRUST_UNGATED for r in resps)
    assert all(r.confidence is None for r in resps)

    cal = calibrate(ev, [_images(8, seed=2)])
    gated = _engine(calibration=cal).serve_all(list(_images(4, seed=3)))
    assert all(not r.degraded and r.trust in (TRUST_IN_DIST, TRUST_ABSTAIN) for r in gated)
    # every served score below the 5th percentile of a shifted ID set
    out = ev(_images(8, seed=2))
    high = Calibration.from_scores(
        out.log_px.numpy() + 100.0, out.logits.numpy(),
        fingerprint=gmm_fingerprint(ev.gmm), compute_dtype="float32",
    )
    abst = _engine(calibration=high).serve_all(list(_images(3, seed=4)))
    assert [r.outcome for r in abst] == [OUTCOME_ABSTAIN] * 3
    assert all(r.trust == TRUST_ABSTAIN and r.trust_score == 0.0 for r in abst)


def test_calibration_json_round_trip_and_fail_closed_across_packages():
    trainer, state, ev = _setup()
    cal = calibrate(ev, [_images(6, seed=5)])
    assert Calibration.from_json(cal.to_json()) == cal
    # the JAX package's fingerprint of the same GMM is a different digest:
    # its calibrations degrade the port's engine instead of gating
    foreign = Calibration.from_dict({
        **cal.to_dict(), "gmm_fingerprint": jax_gmm_fingerprint(state.gmm),
    })
    assert foreign.gmm_fingerprint != gmm_fingerprint(ev.gmm)
    eng = _engine(calibration=foreign)
    assert eng.gate.degraded and eng.gate.fingerprint_mismatch
    assert sm.counter(sm.FINGERPRINT_MISMATCHES).value() == 1


def test_served_results_match_jax_engine():
    trainer, state, _ = _setup()
    payloads = list(_images(6, seed=6))
    ours = _engine(buckets=(1, 2, 4)).serve_all(payloads)
    jeng = JaxServingEngine.from_live(trainer, state, buckets=(1, 2, 4))
    jeng.warmup()
    theirs = jeng.serve_all(payloads)
    for a, b in zip(ours, theirs):
        assert (a.request_id, a.outcome, a.prediction) == (b.request_id, b.outcome, b.prediction)
        np.testing.assert_allclose(a.log_px, b.log_px, rtol=1e-4, atol=1e-3)


def test_deadline_shed_queue_full_and_breaker():
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    eng = _engine(buckets=(2,), queue_capacity=2, clock=clock)
    assert eng.submit(_images(1)[0], "born_dead", deadline_s=0)[0].outcome == OUTCOME_SHED
    assert eng.submit(_images(1)[0], "a", deadline_s=1.0) == []
    assert eng.submit(_images(1)[0], "b") == []
    full = eng.submit(_images(1)[0], "c")
    assert [(r.request_id, r.reason) for r in full] == [("c", "queue_full")]
    now[0] = 2.0  # "a" expires while queued
    resps = eng.process_pending()
    assert sorted((r.request_id, r.outcome) for r in resps) == [
        ("a", OUTCOME_SHED), ("b", OUTCOME_PREDICT),
    ]

    def broken(images):
        raise RuntimeError("device lost")

    eng = ServingEngine(broken, IMG, 4, buckets=(1,), clock=clock,
                        breaker=CircuitBreaker(failure_threshold=2, clock=clock))
    resps = eng.serve_all(list(_images(3)))
    assert [r.reason for r in resps] == ["device_error", "device_error", "circuit_open"]
    assert "device lost" in eng.last_dispatch_error
