"""The hermetic trust drill (`cli/trust.py::run_synthetic_matrix`) of the
port against the JAX package's, on the CPU, at tests/test_trust.py's
reduced size (8 samples a class, 12 bootstrap epochs, monotone_tol 0.30).

Both start from JAX's PRNGKey(0) state of the drill's config, carried into
the port by models/convert.py `from_jax_train_state`; the samples come
from numpy alike. Every cell's outcome counts and correct-on-answered
counts equal JAX's, every gate gives JAX's verdict (JAX's own drill fails
two of its 22 gates at this size: the answered-accuracy floor on contrast
and pixelate), and the stored scores agree within one unit of their fifth
decimal (1e-5: the report rounds them, so a difference far below it can
move the last digit; 1.1e-5 absorbs the float64 representation). The
port's record is deterministic.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax

from mgproto_tpu.cli.trust import run_synthetic_matrix as jax_drill
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu_torch.cli.trust import run_synthetic_matrix, synthetic_config
from mgproto_tpu_torch.models.convert import from_jax_train_state
from mgproto_tpu_torch.serving import metrics as sm

REDUCED = dict(seed=0, per_class=8, bootstrap_epochs=12, config_overrides={"monotone_tol": 0.30})
SCORE_ATOL = 1.1e-5


def jax_initial_state(seed=0):
    jcfg = jax_tiny_config(num_classes=4)
    jcfg = jcfg.replace(em=dataclasses.replace(jcfg.em, mean_lr=0.05))
    jstate = JaxTrainer(jcfg, steps_per_epoch=1).init_state(jax.random.PRNGKey(seed))
    return from_jax_train_state(jax.device_get(jstate), synthetic_config(4), device="cpu")


@pytest.fixture(scope="module")
def drills():
    prev_j = jax_set_registry(JaxMetricRegistry())
    prev_t = sm.set_current_registry(sm.MetricRegistry())
    try:
        jrec = jax_drill(**REDUCED)
        trec = run_synthetic_matrix(state=jax_initial_state(), device="cpu", **REDUCED)
        again = run_synthetic_matrix(state=jax_initial_state(), device="cpu", **REDUCED)
    finally:
        jax_set_registry(prev_j)
        sm.set_current_registry(prev_t)
    return jrec, trec, again


def _cells(rec):
    cells = [("id", rec["id"])] + [(f"ood:{p['pair']}", p) for p in rec["pairs"]]
    cells += [(f"{k}:{c['severity']}", c) for k, rows in sorted(rec["ladder"].items())
              for c in rows]
    return cells


def test_outcomes_and_correct_counts_equal_jax(drills):
    jrec, trec, _ = drills
    want = {name: c for name, c in _cells(jrec)}
    got = {name: c for name, c in _cells(trec)}
    assert list(got) == list(want)
    assert len(got) == 1 + 3 + 20
    for name in want:
        for key in ("n", "submitted", "returned", "outcomes", "answered", "correct_answered"):
            assert got[name][key] == want[name][key], (name, key)


def test_gate_verdicts_equal_jax(drills):
    jrec, trec, _ = drills
    verdicts = [(r["key"], r["ok"]) for r in trec["gates"]["rows"]]
    assert verdicts == [(r["key"], r["ok"]) for r in jrec["gates"]["rows"]]
    assert trec["gates"]["checked"] == 22
    by_key = {r["key"]: r for r in trec["gates"]["rows"]}
    for key in ("trust.zero_dropped", "trust.zero_steady_recompiles",
                "trust.calibration_matches_serving", "trust.not_degraded"):
        assert by_key[key]["ok"], key
    assert trec["steady_state_recompiles"] == 0 and trec["degraded"] is False
    for p in trec["pairs"]:
        assert p["auroc"] >= 0.85, (p["pair"], p["auroc"])


def test_scores_and_thresholds_within_tolerance_of_jax(drills):
    jrec, trec, _ = drills
    for (name, jc), (_, tc) in zip(_cells(jrec), _cells(trec)):
        np.testing.assert_allclose(tc["scores"], jc["scores"], rtol=0, atol=SCORE_ATOL,
                                   err_msg=name)
    assert abs(trec["config"]["threshold_log_px"] - jrec["config"]["threshold_log_px"]) < 1e-5
    for p, jp in zip(trec["pairs"], jrec["pairs"]):
        assert abs(p["auroc"] - jp["auroc"]) <= 1e-3
    assert trec["synthetic_drill"] == jrec["synthetic_drill"]
    assert {k: v for k, v in trec["config"].items() if k != "threshold_log_px"} == \
        {k: v for k, v in jrec["config"].items() if k != "threshold_log_px"}


def test_the_port_drill_is_deterministic(drills):
    _, trec, again = drills
    assert json.dumps(trec, sort_keys=True) == json.dumps(again, sort_keys=True)
