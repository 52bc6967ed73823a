"""The port's trust plane (mgproto_tpu_torch/trust/, cli/telemetry.py,
cli/trust.py) against the JAX package's, on the CPU.

Both packages serve the same weights: JAX's PRNGKey(0) state of the tiny
config, carried into the port by models/convert.py `from_jax_train_state`,
calibrated on the same seeded batches.

  * `serve_cell` accounts 11 requests (not a bucket multiple) alike on both.
  * The matrix's per-pair AUROC through the serving path equals the port's
    bespoke `evaluate_with_ood` within 1e-3 (tests/test_trust.py's bound:
    the report rounds scores to 5 decimals).
  * `trust_gates` gives JAX's rows on the committed
    evidence/trust_baseline.json (read only) and on each of five tampers.
  * `check --trust` exits 0 and 1 as JAX's does; every other gate and
    `summarize` raise NotPortedError naming "A9 (obs and telemetry)".
  * `report` renders and merges as JAX's does; the trust metric family is
    registered under the JAX names; `matrix` from an artifact and a folder
    tree exits by its gates (`interp`: tests/test_torch_interp_sharded.py).
"""

import contextlib
import copy
import io
import json
import os

import numpy as np
import pytest

import jax

from _torch_jax_states import write_jpeg_tree
from mgproto_tpu.cli import telemetry as jtelemetry
from mgproto_tpu.cli import trust as jtrust_cli
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.serving.calibration import calibrate as jcalibrate
from mgproto_tpu.serving.engine import ServingEngine as JaxEngine
from mgproto_tpu.telemetry.registry import MetricRegistry as JaxMetricRegistry
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu.trust import matrix as jmatrix
from mgproto_tpu.trust import metrics as jmetrics
from mgproto_tpu_torch.cli import telemetry as ttelemetry
from mgproto_tpu_torch.cli import trust as ttrust_cli
from mgproto_tpu_torch.cli.common import NotPortedError
from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.engine import export as texport
from mgproto_tpu_torch.engine.eval import Evaluator
from mgproto_tpu_torch.engine.evaluate import evaluate_with_ood
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models.convert import from_jax_train_state
from mgproto_tpu_torch.serving import metrics as sm
from mgproto_tpu_torch.serving.calibration import calibrate, gmm_fingerprint
from mgproto_tpu_torch.serving.engine import ServingEngine
from mgproto_tpu_torch.trust import matrix as tmatrix
from mgproto_tpu_torch.trust import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "evidence", "trust_baseline.json")
IMG = 32
BUCKETS = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def fresh_registries():
    prev_j = jax_set_registry(JaxMetricRegistry())
    prev_t = sm.set_current_registry(sm.MetricRegistry())
    yield
    jax_set_registry(prev_j)
    sm.set_current_registry(prev_t)


@pytest.fixture(scope="module")
def engines():
    """(JAX trainer, state, engine; port trainer, state, evaluator, engine):
    the same weights, calibrated on the same three seeded batches."""
    jcfg = jax_tiny_config()
    jtrainer = JaxTrainer(jcfg, steps_per_epoch=1)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    batches = [(rng.randn(8, IMG, IMG, 3).astype(np.float32),
                rng.randint(0, jcfg.model.num_classes, 8).astype(np.int32)) for _ in range(3)]
    jeng = JaxEngine.from_live(jtrainer, jstate, calibration=jcalibrate(jtrainer, jstate, batches),
                               buckets=BUCKETS)
    jeng.warmup()
    cfg = tiny_test_config()
    trainer = Trainer(cfg, steps_per_epoch=1, device="cpu")
    state = from_jax_train_state(jax.device_get(jstate), cfg, device="cpu")
    ev = Evaluator(state.model, state.gmm, cfg, device="cpu")
    calib = calibrate(ev, [images for images, _ in batches])
    eng = ServingEngine.from_live(ev, calibration=calib, buckets=BUCKETS)
    eng.warmup()
    return dict(jtrainer=jtrainer, jstate=jstate, jeng=jeng, trainer=trainer, state=state, ev=ev,
                calib=calib, eng=eng)


def _images(n, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(n, IMG, IMG, 3) * scale).astype(np.float32)


def test_serve_cell_raw_accounting_matches_jax(engines):
    n = 11  # not a bucket multiple: the last chunk is ragged
    images = _images(n, 5)
    labels = np.random.RandomState(6).randint(0, 4, n).astype(np.int32)
    cell = tmatrix.serve_cell(engines["eng"], images, labels, request_prefix="t")
    want = jmatrix.serve_cell(engines["jeng"], images, labels, request_prefix="t")
    assert cell["submitted"] == cell["returned"] == cell["n"] == n
    assert sum(cell["outcomes"].values()) == n
    gated = cell["outcomes"].get("predict", 0) + cell["outcomes"].get("abstain", 0)
    assert len(cell["scores"]) == gated
    if cell["answered"]:
        assert cell["answered_accuracy"] == cell["correct_answered"] / cell["answered"]
    for key in ("n", "submitted", "returned", "outcomes", "answered", "correct_answered"):
        assert cell[key] == want[key], key
    np.testing.assert_allclose(cell["scores"], want["scores"], rtol=0, atol=1.1e-5)
    assert engines["eng"].check_cold_dispatches() == 0


def test_request_ids_and_chunks(engines):
    """Requests go in chunks of the largest bucket, ids "<cell>:<row>"."""
    eng = engines["eng"]
    seen = []
    orig = eng.serve_all

    def spy(payloads, deadline_s=None, request_ids=None, **kw):
        seen.append(list(request_ids))
        return orig(payloads, deadline_s=deadline_s, request_ids=request_ids, **kw)

    eng.serve_all = spy
    try:
        tmatrix.serve_cell(eng, _images(11, 7), None, request_prefix="ood:x")
    finally:
        del eng.serve_all
    assert [len(s) for s in seen] == [8, 3]
    assert seen[1] == ["ood:x:8", "ood:x:9", "ood:x:10"]


def test_matrix_pair_auroc_matches_the_bespoke_loop(engines):
    """The matrix's per-pair AUROC through the serving path equals
    `evaluate_with_ood`'s on the same data within 1e-3 (the report's
    5-decimal rounding can at worst tie near-equal scores)."""
    id_images = _images(16, 11)
    id_labels = np.random.RandomState(12).randint(0, 4, 16).astype(np.int32)
    ood = {"a": _images(12, 13, scale=2.0),
           "b": np.random.RandomState(14).rand(12, IMG, IMG, 3).astype(np.float32)}
    _, bespoke = evaluate_with_ood(engines["trainer"], engines["state"], [(id_images, id_labels)],
                                   [[ood["a"]], [ood["b"]]], log=lambda *a, **k: None)
    report = tmatrix.run_matrix(
        engines["eng"], id_images, id_labels, ood,
        tmatrix.MatrixConfig(auroc_floor=0.0, answered_accuracy_floor=0.0, monotone_tol=1.0,
                             kinds=("noise",), severities=(1,)))
    served = {p["pair"]: p["auroc"] for p in report["pairs"]}
    assert abs(served["a"] - bespoke["AUROC_1"]) <= 1e-3
    assert abs(served["b"] - bespoke["AUROC_2"]) <= 1e-3
    assert report["steady_state_recompiles"] == 0 and report["degraded"] is False
    assert report["format"] == jmatrix.TRUST_REPORT_FORMAT
    assert report["gates"] == ttelemetry.trust_gates(report)


def test_px_sketch_divergence_equals_jax(engines):
    scores = np.random.RandomState(3).randn(40) + engines["calib"].threshold_log_px
    assert tmatrix.px_sketch_divergence(scores, engines["calib"]) == \
        jmatrix.px_sketch_divergence(scores, engines["calib"])
    assert tmatrix.px_sketch_divergence(np.zeros(0), engines["calib"]) is None
    assert tmatrix.px_sketch_divergence(scores, None) is None


# ------------------------------------------------------------------- gates
def _baseline():
    with open(BASELINE) as f:
        return json.load(f)


def _flip_abstains(r):
    oc = r["pairs"][0]["outcomes"]
    oc["predict"] = oc.get("predict", 0) + oc.pop("abstain", 0)


TAMPERS = {
    "auroc": lambda r: r["pairs"][0].__setitem__("auroc", 0.51),
    "abstains": _flip_abstains,
    "accuracy": lambda r: r["ladder"]["noise"][1].__setitem__("correct_answered", 0),
    "recompiles": lambda r: r.__setitem__("steady_state_recompiles", 2),
    "dropped": lambda r: r["id"].__setitem__("returned", r["id"]["n"] - 1),
}


def test_trust_gates_equal_jax_on_the_committed_baseline():
    record = _baseline()
    got, want = ttelemetry.trust_gates(record), jtelemetry.trust_gates(record)
    assert got == want
    assert got["ok"] and got["checked"] >= 20


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("tamper", sorted(TAMPERS))
def test_trust_gates_fail_a_tampered_record(tamper, package):
    rec = copy.deepcopy(_baseline())
    TAMPERS[tamper](rec)
    gates = {"jax": jtelemetry.trust_gates, "torch": ttelemetry.trust_gates}[package]
    result = gates(rec)
    assert not result["ok"]
    assert result == jtelemetry.trust_gates(rec)


def test_check_trust_exit_codes(tmp_path):
    assert ttelemetry.check_main(["--trust", BASELINE]) == 0
    rec = _baseline()
    rec["pairs"][0]["auroc"] = 0.2
    bad = tmp_path / "tampered.json"
    bad.write_text(json.dumps(rec))
    assert ttelemetry.check_main(["--trust", str(bad)]) == 1
    assert jtelemetry.check_main(["--trust", str(bad)]) == 1
    assert ttelemetry.main(["check", "--trust", BASELINE]) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttelemetry.check_main(["--trust", str(bad), "--json"])
    assert json.loads(out.getvalue()) == jtelemetry.trust_gates(rec)


@pytest.mark.parametrize("argv", [
    ["check", "--autoscale", BASELINE], ["check", "--tenants", BASELINE],
    ["check", "--weakscale", BASELINE], ["fleet", REPO],
])
def test_other_telemetry_gates_are_refused(argv):
    with pytest.raises(NotPortedError, match=r"A9 \(obs and telemetry\)"):
        ttelemetry.main(argv)


def test_check_stall_report_runs_and_gives_jax_rows():
    """`check --stall-report` (refused before the observatory was ported)
    gates a stall report: JAX's committed one passes, alone and against
    itself, with JAX's rows; a trust report is no stall report."""
    stall = os.path.join(REPO, "evidence", "stall_report_b256_bf16.json")
    for argv in (["--stall-report", stall], ["--stall-report", stall, "--stall-baseline", stall]):
        code, text = _run(ttelemetry.check_main, argv + ["--json"])
        rec = json.load(open(stall))
        base = rec if "--stall-baseline" in argv else None
        assert code == 0 and json.loads(text) == jtelemetry.stall_report_gates(rec, base)
    code, text = _run(ttelemetry.main, ["check", "--stall-report", BASELINE, "--json"])
    assert code == 1
    assert json.loads(text) == jtelemetry.stall_report_gates(json.load(open(BASELINE)))


def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = fn(argv)
    return code, out.getvalue()


def test_report_renders_and_merges_as_jax(tmp_path):
    code, text = _run(ttrust_cli.report_main, [BASELINE])
    jcode, jtext = _run(jtrust_cli.report_main, [BASELINE])
    assert (code, text) == (jcode, jtext) == (0, jtext)
    assert "0 failed" in text
    interp = tmp_path / "interp.json"
    interp.write_text(json.dumps({"trust_interp": True, "consistency": 61.5,
                                  "stability": 72.25, "purity": 40.0}))
    outs = {}
    for name, fn in (("torch", ttrust_cli.report_main), ("jax", jtrust_cli.report_main)):
        path = tmp_path / f"merged_{name}.json"
        outs[name] = _run(fn, ["--matrix", BASELINE, "--interp", str(interp), "--out", str(path)])
        outs[name] += (json.loads(path.read_text()),)
    assert outs["torch"] == outs["jax"]
    merged = outs["torch"][2]
    assert merged["interp"] == {"consistency": 61.5, "stability": 72.25, "purity": 40.0}
    assert merged["gates"] == ttelemetry.trust_gates(merged)
    assert "interp: consistency=61.5 purity=40.0 stability=72.25" in outs["torch"][1]
    with pytest.raises(SystemExit):
        ttrust_cli.report_main([])


def test_trust_metrics_registered_under_the_jax_names():
    T, J = tmetrics, jmetrics
    assert T.ALL_COUNTERS == J.ALL_COUNTERS and T.ALL_GAUGES == J.ALL_GAUGES
    assert T.COUNTER_HELP == J.COUNTER_HELP and T.GAUGE_HELP == J.GAUGE_HELP
    for name in ("MATRIX_CELLS", "PAIR_AUROC", "ABSTENTION_RATE", "ANSWERED_ACCURACY",
                 "PX_DIVERGENCE", "VERDICTS", "INTERP_CONSISTENCY", "INTERP_STABILITY",
                 "INTERP_PURITY"):
        assert getattr(T, name) == getattr(J, name)
    reg = sm.MetricRegistry()
    T.register_trust_metrics(reg)
    snap = reg.snapshot()
    assert set(snap) == set(J.ALL_COUNTERS + J.ALL_GAUGES)
    assert all(s["value"] == 0.0 for m in snap.values() for s in m["series"])
    text = reg.to_prometheus()
    assert f"# HELP trust_pair_auroc {J.GAUGE_HELP['trust_pair_auroc']}" in text


def test_the_drill_preregisters_the_trust_family(monkeypatch):
    """run_storm registers the trust family beside the online family."""
    from mgproto_tpu_torch.online import drill

    seen = []
    real = tmetrics.register_trust_metrics
    monkeypatch.setattr(tmetrics, "register_trust_metrics",
                        lambda reg: (seen.append(reg), real(reg)))
    drill.run_storm(seed=0, phases=drill.parse_phases("0.1x40"), online=True, device="cpu")
    assert len(seen) == 1 and tmetrics.PAIR_AUROC in seen[0].snapshot()


def test_matrix_main_synthetic_exits_by_its_gates(tmp_path):
    out = tmp_path / "r.json"
    code, text = _run(ttrust_cli.main, ["matrix", "--synthetic", "--device", "cpu",
                                        "--per_class", "4", "--out", str(out)])
    line = json.loads(text.strip().splitlines()[-1])
    report = json.loads(out.read_text())
    assert set(line) == {"report", "pairs", "steady_state_recompiles", "gates_checked",
                         "gates_failed"}
    assert code == (0 if report["gates"]["ok"] else 1)
    assert code == ttelemetry.check_main(["--trust", str(out)])
    assert line["steady_state_recompiles"] == 0
    assert report["synthetic_drill"]["per_class"] == 4
    with pytest.raises(NotPortedError, match="by design: this main runs one process"):
        ttrust_cli.main(["matrix", "--synthetic", "--device", "cpu", "--distributed"])


def test_matrix_main_from_an_artifact_and_folders(engines, tmp_path):
    """`matrix --artifact` over a test folder and two OoD folders: every
    cell of the --max_samples cut answered, named by folder, exit by its
    gates; the cells equal run_matrix on the same engine and arrays."""
    test_dir = write_jpeg_tree(str(tmp_path / "test"), 4, 3, seed=1)
    ood_a = write_jpeg_tree(str(tmp_path / "far"), 2, 3, seed=2)
    ood_b = write_jpeg_tree(str(tmp_path / "near"), 1, 4, seed=3)
    state, cfg = engines["state"], engines["trainer"].cfg
    art = str(tmp_path / "m.mgproto")
    texport.save_artifact(art, state.model, state.gmm,
                          texport.artifact_meta(cfg, None, gmm_fingerprint(state.gmm)),
                          calibration=engines["calib"])
    out = tmp_path / "r.json"
    argv = ["matrix", "--artifact", art, "--device", "cpu", "--arch", "tiny", "--img_size", "32",
            "--num_classes", "4", "--batch_size", "4", "--num_workers", "0", "--train_dir",
            test_dir, "--push_dir", test_dir, "--test_dir", test_dir, "--ood_dir", ood_a, "--ood_dir", ood_b, "--max_samples", "10",
            "--out", str(out)]
    code, _ = _run(ttrust_cli.main, argv)
    report = json.loads(out.read_text())
    assert code == (0 if report["gates"]["ok"] else 1)
    assert [p["pair"] for p in report["pairs"]] == ["far", "near"]
    assert report["id"]["n"] == 10 and [p["n"] for p in report["pairs"]] == [6, 4]
    assert all(c["n"] == 10 for rows in report["ladder"].values() for c in rows)
    assert report["steady_state_recompiles"] == 0
    tcfg = tiny_test_config().replace(data=_data_config(test_dir, (ood_a, ood_b)))
    id_images, id_labels, ood_sets = ttrust_cli._matrix_sets(tcfg, 10, "cpu")
    want = tmatrix.run_matrix(engines["eng"], id_images, id_labels, ood_sets)
    assert json.dumps(report, sort_keys=True) == json.dumps(
        json.loads(json.dumps(want)), sort_keys=True)


def _data_config(test_dir, ood_dirs):
    from mgproto_tpu_torch.config import DataConfig

    return DataConfig(train_dir=test_dir, test_dir=test_dir, train_push_dir=test_dir,
                      ood_dirs=tuple(ood_dirs), test_batch_size=4, num_workers=0)
