"""The port's drills (mgproto_tpu_torch/online/drill.py, cli/online.py)
against the JAX package's scripts/load_test.py, on the CPU.

Both packages start from the same weights: JAX's PRNGKey(seed) state of the
drill's model, carried into the port by models/convert.py
`from_jax_train_state`; everything else both draw from numpy alike.

  * The drift drill at its own sizes (cli/online.py's defaults: phases
    2x40,4x40,4x40, drift at request 120, magnitude 0.25, capture at the
    10th percentile, 5 % poison): every gate of `drift_drill_gates` gives
    the same verdict on both packages, the same republishes commit, no
    poisoned request is captured on either, the first p(x) breach falls
    within one evaluation interval of JAX's, and the capture decisions,
    the consolidation and the served-accuracy windows agree. The JAX
    package's own drill fails `drill.accuracy_recovered_after_republish`
    at these sizes on this seed (self-labeled consolidation under the
    shift keeps misclassifying); the port reproduces that verdict.
  * The drill at tests/test_online.py's TestDriftDrill sizes: each of its
    assertions holds on the port, and every gate but the recovery gate
    passes (JAX's drill fails that gate there too).
  * The new-class drill (port): a class claims padded slot 4 without a new
    input shape, every gate passes, and the new class is served.
  * The consolidation is off the hot path: per-phase latencies equal the
    storm's without the online plane; the drill is deterministic; the poison
    knob comes from MGPROTO_CHAOS_ONLINE_POISON_RATE; `cli.online drill`
    exits 0 exactly when every gate passes.
  * The tenant drill (three tenants with per-tenant drift and capture, a
    storm, MGPROTO_CHAOS_TENANT_POISON_RATE junk in the storm tenant's lane,
    a mid-storm mount, a sabotaged and a committed head swap): the same
    per-tenant outcomes, sheds, breaches and captures as JAX's.
"""

import dataclasses
import json
import os
import sys

import jax
import pytest

from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

DRILL = dict(seed=0, phases="2x40,4x40,4x40", drift_at=120, drift_magnitude=0.25,
             capture_percentile=10.0, poison_rate=0.05, accuracy_window=40)
SMALL = dict(DRILL, phases="0.5x40,1x40", drift_at=30, accuracy_window=20)
EVAL_INTERVAL_S = 0.5  # the drill's drift cadence (online_cadence_s)
TENANT_PHASES = "2x40,3x40,2x40"


@pytest.fixture(autouse=True)
def fresh_jax_registry():
    prev = jax_set_registry(JaxMetricRegistry())
    yield
    jax_set_registry(prev)


def jax_initial_state(seed, online=True):
    """JAX's initial state of the drill's model, in the port."""
    from mgproto_tpu.config import tiny_test_config as jtiny
    from mgproto_tpu.engine.train import Trainer as JaxTrainer
    from mgproto_tpu.online.classes import apply_class_bucket
    from mgproto_tpu_torch.config import tiny_test_config
    from mgproto_tpu_torch.models.convert import from_jax_train_state
    from mgproto_tpu_torch.online.drill import drill_config

    jcfg = jtiny()
    if online:
        jcfg = apply_class_bucket(jcfg.replace(
            model=dataclasses.replace(jcfg.model, class_bucket=8),
            em=dataclasses.replace(jcfg.em, mean_lr=0.05)))
    jstate = JaxTrainer(jcfg, steps_per_epoch=1).init_state(jax.random.PRNGKey(seed))
    cfg = drill_config(8) if online else tiny_test_config()
    return from_jax_train_state(jax.device_get(jstate), cfg, device="cpu")


def port_drill(**kw):
    from mgproto_tpu_torch.online.drill import run_drill

    kw = {**DRILL, **kw}
    return run_drill(state=jax_initial_state(kw["seed"]), device="cpu", **kw)


@pytest.fixture(scope="module")
def drills():
    from load_test import parse_phases, run_load_test

    from mgproto_tpu.cli.telemetry import drift_drill_gates

    jrec = run_load_test(seed=DRILL["seed"], phases=parse_phases(DRILL["phases"]), online=True,
                         drift_at=DRILL["drift_at"], drift_magnitude=DRILL["drift_magnitude"],
                         capture_percentile=DRILL["capture_percentile"],
                         poison_rate=DRILL["poison_rate"],
                         accuracy_window=DRILL["accuracy_window"])
    jrec["gates"] = drift_drill_gates(jrec)
    return jrec, port_drill()


def _verdicts(rec):
    return [(r["key"], r["ok"]) for r in rec["gates"]["rows"]]


def test_drift_drill_gates_and_record_equal_jax(drills):
    jrec, trec = drills
    jo, to = jrec["online"], trec["online"]
    assert _verdicts(trec) == _verdicts(jrec)
    assert to["republish_by_result"] == jo["republish_by_result"]
    assert to["republish_by_result"].get("committed", 0) >= 1
    assert [r["result"] for r in to["republishes"]] == [r["result"] for r in jo["republishes"]]
    assert to["poison"] == jo["poison"] and to["poison"]["capture_eligible"] == 0
    assert to["poison"]["injected"] > 0
    jfb, tfb = jo["detection"]["first_breach"], to["detection"]["first_breach"]
    assert abs(tfb["t"] - jfb["t"]) <= EVAL_INTERVAL_S and "px" in tfb["signals"]
    assert to["detection"]["detected_before_correction"] is True
    assert to["capture_by_outcome"] == jo["capture_by_outcome"]
    tcons, jcons = to["consolidation"], jo["consolidation"]
    assert (tcons["runs"], tcons["samples"]) == (jcons["runs"], jcons["samples"])
    assert (tcons["compiles"], tcons["steady_recompiles"]) == (1, 0)
    assert trec["overall"] == jrec["overall"] and trec["steady_state_recompiles"] == 0
    assert len(to["accuracy_windows"]) == len(jo["accuracy_windows"])
    for tw, jw in zip(to["accuracy_windows"], jo["accuracy_windows"]):
        # one request's share: a near-threshold decision may go either way
        assert abs(tw["served_accuracy"] - jw["served_accuracy"]) <= 1.0 / jw["answered"] + 1e-9


def test_the_drill_passes_the_gates_the_plane_guarantees(drills):
    """Detection before correction, a committed republish, zero drops and
    recompiles, no captured poison and the dip, on the port; the recovery
    gate's verdict is JAX's (above)."""
    rows = {r["key"]: r["ok"] for r in drills[1]["gates"]["rows"]}
    recovered = rows.pop("drill.accuracy_recovered_after_republish")
    assert all(rows.values()), rows
    assert recovered == {r["key"]: r["ok"] for r in drills[0]["gates"]["rows"]}[
        "drill.accuracy_recovered_after_republish"]


def test_drill_at_the_jax_tests_sizes_passes_what_jax_asserts():
    """tests/test_online.py's TestDriftDrill sizes (1x40,2x40,2x40, drift at
    request 60, load_test.py's magnitude 0.35, windows of 20), from JAX's
    weights: each of its assertions holds on the port. Every gate passes but
    `drill.accuracy_recovered_after_republish` (post within 0.15 of the
    pre-drift accuracy), which JAX's drill fails at these sizes too: its
    TestDriftDrill asserts the weaker last-window rule below."""
    rec = port_drill(phases="1x40,2x40,2x40", drift_at=60, drift_magnitude=0.35,
                     accuracy_window=20)
    o = rec["online"]
    rows = {r["key"]: r["ok"] for r in rec["gates"]["rows"]}
    rows.pop("drill.accuracy_recovered_after_republish")
    assert all(rows.values()), rows
    assert rec["overall"]["zero_dropped"] is True and rec["steady_state_recompiles"] == 0
    assert (o["consolidation"]["compiles"], o["consolidation"]["steady_recompiles"]) == (1, 0)
    det = o["detection"]
    assert "px" in det["first_breach"]["signals"] and det["first_commit_t"] is not None
    assert det["first_breach"]["t"] <= det["first_commit_t"] and det["detected_before_correction"]
    commit = [r for r in o["republishes"] if r["result"] == "committed"][0]
    assert commit["swap"]["reason"] == "committed" and commit["calibration_fingerprint"]
    windows = o["accuracy_windows"]
    pre = [w["served_accuracy"] for w in windows if w["drifted_fraction"] == 0]
    drifted = [w["served_accuracy"] for w in windows if (w["drifted_fraction"] or 0) > 0.5]
    assert pre and drifted
    assert min(drifted) <= sum(pre) / len(pre) - 0.2  # the dip is real
    assert drifted[-1] >= min(drifted) + 0.2  # and corrected
    assert o["poison"]["injected"] > 0 and o["poison"]["capture_eligible"] == 0
    assert o["capture_by_outcome"].get("accepted", 0) > 0 and o["consolidation"]["samples"] > 0


def test_new_class_drill_claims_a_slot_without_a_new_shape():
    rec = port_drill(drift_kind="new_class")
    o = rec["online"]
    assert rec["gates"]["ok"], [r for r in rec["gates"]["rows"] if not r["ok"]]
    assert o["new_class_slot"] == 4 and o["labeled_feedback"] > 0
    assert o["consolidation"]["compiles"] == 1 and o["consolidation"]["steady_recompiles"] == 0
    assert rec["steady_state_recompiles"] == 0 and rec["overall"]["zero_dropped"]
    assert o["republish_by_result"].get("committed", 0) >= 1
    drifted = [w for w in o["accuracy_windows"] if (w["drifted_fraction"] or 0) > 0.5]
    assert drifted and drifted[-1]["served_accuracy"] >= 0.6


def test_consolidation_off_the_hot_path_and_deterministic():
    """The online plane takes no virtual time: per-phase latencies equal the
    storm's without it; two runs give the same record."""
    from mgproto_tpu_torch.online.drill import parse_phases, run_storm

    a, b = port_drill(**SMALL), port_drill(**SMALL)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    offline = run_storm(seed=0, phases=parse_phases(SMALL["phases"]), device="cpu")
    for on, off in zip(a["phases"], offline["phases"]):
        assert (on["p50_ms"], on["p99_ms"]) == (off["p50_ms"], off["p99_ms"])


def test_poison_rate_comes_from_the_chaos_knob(monkeypatch):
    monkeypatch.setenv("MGPROTO_CHAOS_ONLINE_POISON_RATE", "0.2")
    rec = port_drill(**dict(SMALL, poison_rate=None))
    poison = rec["online"]["poison"]
    assert poison["rate"] == 0.2 and poison["injected"] > 0 and poison["capture_eligible"] == 0


def test_cli_drill_exits_by_its_gates(tmp_path, capsys):
    from mgproto_tpu_torch.cli import online as tonline

    out = tmp_path / "drill.json"
    code = tonline.main(["drill", "--device", "cpu", "--phases", SMALL["phases"], "--drift-at",
                         "30", "--accuracy-window", "20", "--poison-rate", "0.05", "--out",
                         str(out)])
    rec = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["drift_drill"] is True and code == (0 if rec["gates"]["ok"] else 1)


def test_tenant_drill_equals_jax():
    from load_test import parse_phases, run_load_test

    from mgproto_tpu_torch.online.drill import run_storm

    phases = parse_phases(TENANT_PHASES)
    jrec = run_load_test(seed=0, phases=phases, tenants=3)
    trec = run_storm(seed=0, phases=phases, tenants=3, state=jax_initial_state(0, online=False),
                     device="cpu")

    def summary(rec):
        t = rec["tenants"]
        per = {k: {f: v[f] for f in ("submitted", "outcomes", "shed_by_reason", "drift_breaches",
                                     "quota", "head_bytes")}
               | {"captured": (v["capture"] or {}).get("accepted")}
               for k, v in t["per_tenant"].items()}
        return [per, [(s["tenant"], s["ok"], s["reason"]) for s in t["swaps"]],
                [(m["tenant"], m["head_bytes"], m["during_storm"]) for m in t["mounts"]],
                t["poison_injected"], t["storm_extras"], rec["overall"],
                rec["steady_state_recompiles"]]

    assert summary(trec) == summary(jrec)
    per = trec["tenants"]["per_tenant"]
    assert per["t0"]["drift_breaches"] > 0 and per["t0"]["shed_by_reason"].get("tenant_quota")
    assert all(not v["shed_by_reason"] for k, v in per.items() if k != "t0")
    assert trec["tenants"]["poison_injected"] > 0
