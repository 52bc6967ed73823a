"""The port's telemetry plane (mgproto_tpu_torch/telemetry, cli/telemetry.py,
cli/online.py status) against the JAX package's, on the CPU.

  * The registry: the same series give JAX's Prometheus text and snapshot
    byte for byte; JsonlWriter's batched fsync and closed guard; the
    snapshot line; the tracer's Chrome trace; StepMonitor's series.
  * `em_health_diagnostics` within 1e-6 of JAX's on a carried state, and
    ModelHealth's record.
  * Telemetry directories: the same values written through each package's
    registry give equal `summarize` dicts (the directory aside); a
    directory the port's `cli.train` wrote (with a rank-1 sidecar and a
    torn last line) gives the same summary and table from both packages;
    `cli.online status` renders as JAX's.
  * The gates: `build_baseline` / `check` and their exit codes, the quant
    gates on the committed record and on tampered copies, the drift drill
    gate, as JAX's.
  * The port's wiring: `train_epoch(monitor=)` (counts, cold paths, the
    state bit-equal with the monitor off; ShardedTrainer passes it), the
    serving engine's monitor, the session's sidecars and meta, cli.evaluate
    and cli.serve directories, the replica-death dump, `hbm_bucket_prep`.
"""

import contextlib
import copy
import dataclasses
import io
import json
import os
import types

import jax
import numpy as np
import pytest

from _torch_jax_states import write_jpeg_tree
from mgproto_tpu.cli import online as jonline
from mgproto_tpu.cli import telemetry as jtelemetry
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.core import em as jem
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.telemetry import health as jhealth
from mgproto_tpu.telemetry import monitor as jmonitor
from mgproto_tpu.telemetry import registry as jreg
from mgproto_tpu.telemetry import tracing as jtracing
from mgproto_tpu.telemetry.registry import set_current_registry as jax_set_registry
from mgproto_tpu_torch.cli import evaluate as tevaluate
from mgproto_tpu_torch.cli import export as texport
from mgproto_tpu_torch.cli import online as tonline
from mgproto_tpu_torch.cli import serve as tserve
from mgproto_tpu_torch.cli import telemetry as ttelemetry
from mgproto_tpu_torch.cli import train as ttrain
from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.core import em as tem
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models.convert import from_jax_train_state
from mgproto_tpu_torch.obs import flightrec
from mgproto_tpu_torch.serving import metrics as tmetrics
from mgproto_tpu_torch.telemetry import health as thealth
from mgproto_tpu_torch.telemetry import monitor as tmonitor
from mgproto_tpu_torch.telemetry import registry as treg
from mgproto_tpu_torch.telemetry import session as tsession
from mgproto_tpu_torch.telemetry import tracing as ttracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUANT_RECORD = os.path.join(REPO, "evidence", "quant_bench.json")
DRILL_RECORD = os.path.join(REPO, "evidence", "drift_drill.json")
REGS = {"jax": jreg, "torch": treg}
TINY = ["--dataset", "CUB", "--arch", "tiny", "--num_classes", "4", "--protos_per_class", "3",
        "--proto_dim", "8", "--aux_emb_sz", "8", "--mine_level", "4", "--mem_sz", "16",
        "--no_pretrained", "--batch_size", "6", "--num_workers", "0", "--device", "cpu",
        "--img_size", "32"]


@pytest.fixture(autouse=True)
def fresh_registries():
    prev_t = tmetrics.set_current_registry(None)
    prev_j = jax_set_registry(jreg.MetricRegistry())
    yield
    jax_set_registry(prev_j)
    tmetrics.set_current_registry(prev_t)


def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = fn(argv)
    return code, out.getvalue()


# ------------------------------------------------------------------ registry
def _fill(reg):
    c = reg.counter("requests_total", "requests by outcome")
    c.inc()
    c.inc(2.5, outcome="predict")
    c.inc(1, outcome='a"b\\c')
    g = reg.gauge("queue_depth", "depth")
    g.set(3)
    g.set(0.25, replica="r0")
    h = reg.histogram("latency_seconds", "latency")
    for v in (0.0004, 0.003, 0.02, 0.7, 3.0, 400.0):
        h.observe(v, outcome="predict")
    reg.histogram("fill", "", buckets=(0.5, 1.0)).observe(0.3)
    reg.gauge("declared_only", "never set")
    return reg


def test_registry_text_and_snapshot_equal_jax_byte_for_byte():
    j, t = _fill(jreg.MetricRegistry()), _fill(treg.MetricRegistry())
    assert t.to_prometheus() == j.to_prometheus()
    assert t.snapshot() == j.snapshot()
    assert t.histogram("latency_seconds").percentile(99, outcome="predict") == \
        j.histogram("latency_seconds").percentile(99, outcome="predict")
    with pytest.raises(TypeError):
        t.gauge("requests_total")
    with pytest.raises(ValueError):
        t.counter("bad name")


def test_jsonl_writer_and_snapshot_line_equal_jax(tmp_path, monkeypatch):
    fsyncs = []
    monkeypatch.setattr(os, "fsync", lambda fd: fsyncs.append(fd))
    lines = {}
    for name, mod in REGS.items():
        path = str(tmp_path / name / "m.jsonl")
        w = mod.JsonlWriter(path, flush_every=10)
        for i in range(25):
            w.write({"i": i})
        reg = _fill(mod.MetricRegistry())
        mod.write_jsonl_snapshot(reg, w, step=7, extra={"host": 0, "epoch": 1})
        w.close()
        w.write({"late": True})
        assert w.closed and w.dropped == 1
        with open(path) as f:
            recs = [json.loads(ln) for ln in f]
        assert len(recs) == 26 and "time" in recs[-1]
        lines[name] = [{k: v for k, v in r.items() if k != "time"} for r in recs]
    assert lines["torch"] == lines["jax"]
    assert len(fsyncs) == 2 * 3  # lines 10, 20 and the close, per package


def test_tracer_chrome_trace_equals_jax():
    def record(mod):
        tr = mod.Tracer()
        with tr.span("epoch", epoch=0):
            with tr.span("train") as a:
                a["steps"] = np.float32(3)
        tr.add_span("stage", ts=1.5, dur=0.25, tid=7, what="x")
        ev = tr.to_chrome_trace()
        return [{k: e[k] for k in ("name", "ph", "args")} for e in ev["traceEvents"]], \
            [(s["name"], s["depth"], s["parent"]) for s in tr.spans()], ev["displayTimeUnit"]

    assert record(ttracing) == record(jtracing)
    prev = ttracing.set_current_tracer(ttracing.Tracer())
    with ttracing.trace_span("x"):
        pass
    assert [s["name"] for s in ttracing.default_tracer().spans()] == ["x"]
    ttracing.set_current_tracer(prev)


def _cold_count(pkg, n):
    """What each package's StepMonitor watches, reading `n` compiled
    variants: a jitted function's cache size in JAX, a cumulative count in
    the port."""
    if pkg == "jax":
        return types.SimpleNamespace(_cache_size=lambda: n)
    return lambda: n


def test_step_monitor_series_equal_jax():
    snaps = {}
    for name, (reg_mod, mon_mod) in {"jax": (jreg, jmonitor), "torch": (treg, tmonitor)}.items():
        reg = reg_mod.MetricRegistry()
        mon = mon_mod.StepMonitor(registry=reg)
        for i in range(5):
            mon.observe_step(8, 0.05 * (i + 1), transfer_bytes=1000, wait_seconds=0.01,
                             check_recompiles=False)
        mon.watch(_cold_count(name, 2))
        mon.check_recompiles()
        snaps[name] = (reg.snapshot(), mon.epoch_images, mon.epoch_seconds, mon.ema_seconds,
                       mon.recompile_count)
    (js, *jrest), (ts, *trest) = snaps["jax"], snaps["torch"]
    assert trest == jrest
    assert {k: v for k, v in js.items() if k in ts} == ts
    # XLA's cost analysis; the async bank's overlap gauge is in both
    assert set(js) - set(ts) == {"step_flops", "step_bytes_accessed"}
    assert ts["bank_dispatch_overlap_fraction"] == js["bank_dispatch_overlap_fraction"]


def test_step_monitor_watches_cumulative_cold_path_counts():
    reg = treg.MetricRegistry()
    mon = tmonitor.StepMonitor(registry=reg, phase="serve")
    count = [0]
    mon.watch(lambda: count[0])
    assert mon.check_recompiles() == 0
    count[0] = 3
    assert mon.check_recompiles() == 3 and mon.check_recompiles() == 0
    assert mon.recompile_count == 3
    assert reg.gauge("jit_cache_size").value(phase="serve") == 3
    cold = tmonitor.ColdPaths()
    for shape in ((4, 8), (4, 8), (2, 8)):
        cold.note(shape)
    assert cold.total() == 2 and cold.shapes == 2


# -------------------------------------------------------------------- health
def _carried_state():
    """A JAX state with a GMM and bank that every diagnostic sees (a
    collapsed pair, sigmas at the floor, skewed priors, a half-filled,
    partly updated bank) and the same state carried into the port."""
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    jstate = jax.jit(JaxTrainer(jcfg, steps_per_epoch=4).init_state)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    m = jcfg.model
    c, k, d = m.num_classes, m.prototypes_per_class, m.proto_dim
    means = rng.normal(size=(c, k, d)).astype(np.float32)
    means[1, 1] = means[1, 0] + 1e-5
    sigmas = np.asarray(jstate.gmm.sigmas).copy()
    sigmas[0, :, :2] = 5e-4
    priors = rng.dirichlet(np.ones(k), size=c).astype(np.float32)
    priors[2] = [1.0, 0.0, 0.0]
    gmm = jstate.gmm.replace(means=means, sigmas=sigmas, priors=priors) \
        if hasattr(jstate.gmm, "replace") else jstate.gmm._replace(
            means=means, sigmas=sigmas, priors=priors)
    mem = jstate.memory
    length = np.array([m.mem_capacity, 3, 0, m.mem_capacity // 2], np.int32)
    mem = mem._replace(length=length, updated=np.array([True, False, True, False]))
    jstate = jstate.replace(gmm=gmm, memory=mem)
    return jstate, from_jax_train_state(jax.device_get(jstate), tcfg, device="cpu")


def test_health_diagnostics_equal_jax_on_a_carried_state(tmp_path):
    jstate, tstate = _carried_state()
    want = {k: float(v) for k, v in jax.device_get(
        jem.em_health_diagnostics(jstate.gmm, jstate.memory)).items()}
    got = {k: float(v) for k, v in tem.em_health_diagnostics(tstate.gmm, tstate.memory).items()}
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    assert want["collapse_frac"] > 0 and want["sigma_floor_frac"] > 0
    recs = {}
    for name, (reg_mod, h_mod, state) in {"jax": (jreg, jhealth, jstate),
                                          "torch": (treg, thealth, tstate)}.items():
        reg = reg_mod.MetricRegistry()
        w = reg_mod.JsonlWriter(str(tmp_path / f"{name}.jsonl"))
        out = h_mod.ModelHealth(registry=reg, writer=w).record(state, epoch=3, stage="x")
        w.close()
        recs[name] = (sorted(out), sorted(reg.snapshot()),
                      sorted(json.loads(open(tmp_path / f"{name}.jsonl").read())))
    assert recs["torch"] == recs["jax"]


# --------------------------------------------------- telemetry directories
def _write_dir(d, pkg):
    """The same values through each package's own registry, writer and
    tracer (no session: JAX's pre-registers a fleet family the port does
    not measure)."""
    reg_mod, tr_mod = (jreg, jtracing) if pkg == "jax" else (treg, ttracing)
    if pkg == "jax":
        from mgproto_tpu.online.metrics import register_online_metrics
        from mgproto_tpu.resilience.metrics import register_resilience_metrics
        from mgproto_tpu.trust.metrics import register_trust_metrics
        mon_mod = jmonitor
    else:
        from mgproto_tpu_torch.online.metrics import register_online_metrics
        from mgproto_tpu_torch.resilience.metrics import register_resilience_metrics
        from mgproto_tpu_torch.trust.metrics import register_trust_metrics
        mon_mod = tmonitor
    os.makedirs(d, exist_ok=True)
    reg = reg_mod.MetricRegistry()
    for fn in (register_resilience_metrics, register_online_metrics, register_trust_metrics):
        fn(reg)
    mon = mon_mod.StepMonitor(registry=reg)
    for i in range(6):
        mon.observe_step(6, 0.01 * (i + 2), transfer_bytes=512, wait_seconds=0.002,
                         check_recompiles=False)
    mon.watch(_cold_count(pkg, 1))
    mon.check_recompiles()
    reg.gauge("em_active_classes", "").set(4.0)
    reg.counter("em_compact_fallback_total", "").inc(1.0)
    reg.counter("autotune_plan_rejected_total", "").inc(2.0)
    reg.gauge("epoch_images_per_sec_global", "").set(123.5)
    reg.counter("serving_requests_total", "").inc(5, outcome="predict")
    reg.counter("serving_requests_total", "").inc(2, outcome="abstain")
    reg.counter("serving_shed_total", "").inc(1, reason="queue_full")
    for v in (0.002, 0.004, 0.03):
        reg.histogram("serving_request_seconds", "").observe(v, outcome="predict")
    reg.histogram("serving_batch_fill_fraction", "", buckets=(0.5, 1.0)).observe(0.75)
    reg.gauge("drift_class_mean_shift", "").set(0.4, **{"class": "2"})
    reg.counter("drift_breach_total", "").inc(1, signal="px")
    reg.counter("tenant_requests_total", "").inc(3, tenant="a", outcome="predict")
    reg.gauge("trust_pair_auroc", "").set(0.75, pair="noise")
    reg.counter("train_rollbacks_total", "").inc(1)
    w = reg_mod.JsonlWriter(os.path.join(d, "metrics.jsonl"))
    reg_mod.write_jsonl_snapshot(reg, w, step=3, extra={"host": 0, "epoch": 0})
    reg_mod.write_jsonl_snapshot(reg, w, step=6, extra={"host": 0, "epoch": 1})
    w.close()
    reg.write_prometheus(os.path.join(d, "metrics.prom"))
    hw = reg_mod.JsonlWriter(os.path.join(d, "health.jsonl"))
    for e, occ in ((0, 0.5), (1, 1.0)):
        hw.write({"time": 1.0, "epoch": e, "prior_entropy_mean": 1.09, "min_interproto_dist":
                  0.3 + e, "collapse_frac": 0.0, "memory_occupancy": occ})
    hw.close()
    tr = tr_mod.Tracer()
    with tr.span("epoch"):
        with tr.span("train"):
            pass
    tr.export_chrome_trace(os.path.join(d, "trace.json"))
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"autotune": {"plan": {"name": "b80_pf2", "peak_bytes": 1e9},
                                "budget_bytes": 8e10, "margin": 0.08, "rejected": 2},
                   "async_bank": False}, f)


def _no_dir(summary):
    return {k: v for k, v in summary.items() if k not in ("telemetry_dir", "spans")}


def test_the_same_values_summarize_equal(tmp_path):
    _write_dir(str(tmp_path / "t"), "torch")
    _write_dir(str(tmp_path / "j"), "jax")
    port = ttelemetry.summarize(str(tmp_path / "t"))
    jax_summary = _no_dir(jtelemetry.summarize(str(tmp_path / "j")))
    # both StepMonitors hold the async bank's overlap gauge at 0.0 in a
    # sync run
    assert port["em"]["bank_dispatch_overlap_fraction"] == 0.0
    assert _no_dir(port) == jax_summary
    assert set(port["spans"]) == {"epoch", "train"}
    # a port directory read by the JAX command gives the same
    assert jtelemetry.summarize(str(tmp_path / "t")) == port
    assert ttelemetry.render_table(port) == jtelemetry.render_table(port)
    for section in ("steps", "em", "data", "meta", "resilience", "serving", "tenants", "drift",
                    "trust", "health"):
        assert section in port, section


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """cli.train's directory (telemetry on by default), then cli.evaluate
    and cli.export of its checkpoint, a rank-1 sidecar session beside it,
    and a torn last line, as a killed rank leaves."""
    root = tmp_path_factory.mktemp("telemetry")
    imgs = write_jpeg_tree(str(root / "imgs"), 4, 5, seed=0)
    data = ["--train_dir", imgs, "--test_dir", imgs, "--push_dir", imgs]
    run = str(root / "run")
    prev = tmetrics.set_current_registry(None)
    try:
        ttrain.main(TINY + data + ["--model_dir", run, "--epochs", "2", "--mine_start", "0",
                                   "--gmm_start", "0", "--push_start", "1", "--push_every", "1",
                                   "--prune_top_m", "2"])
        with contextlib.redirect_stdout(io.StringIO()):
            tevaluate.main(TINY + data + ["--model_dir", run])
        art = str(root / "m.mgproto")
        texport.main(TINY + data + ["--model_dir", run, "--out", art, "--calibrate"])
        side = tsession.TelemetrySession(os.path.join(run, "telemetry"), host=1)
        side.monitor.observe_step(6, 0.5)
        side.flush(step=1)
        side.close()
        with open(os.path.join(run, "telemetry", "metrics.jsonl.h1"), "a") as f:
            f.write('{"time": 1.0, "metr')
    finally:
        tmetrics.set_current_registry(prev)
    return dict(root=str(root), run=run, imgs=imgs, data=data, art=art)


def test_cli_train_writes_a_directory_both_packages_summarize_alike(run_dir):
    d = os.path.join(run_dir["run"], "telemetry")
    assert {"metrics.jsonl", "metrics.prom", "health.jsonl", "trace.json", "meta.json",
            "metrics.jsonl.h1", "metrics.prom.h1", "trace.json.h1"} <= set(os.listdir(d))
    port = ttelemetry.summarize(run_dir["run"])
    assert port == jtelemetry.summarize(run_dir["run"])
    assert ttelemetry.render_table(port) == jtelemetry.render_table(port)
    assert port["steps"]["steps_total"] == 6 and port["steps"]["images_total"] == 36
    assert port["recompiles"]["jit_recompiles_total"] >= 1
    assert port["health"]["records"] == 2 and port["health"]["last_epoch"] == 1
    assert {"epoch", "train", "test", "push"} <= set(port["spans"])
    meta = port["meta"]
    assert meta["arch"] == "tiny" and meta["wire_dtype"] == "float32"
    assert meta["bank_bytes_per_chip"] == 2084
    for fn in (ttelemetry.main, jtelemetry.main):
        code, text = _run(fn, ["summarize", run_dir["run"]])
        assert code is None and "model health (2 records" in text
    code, text = _run(ttelemetry.main, [d, "--json"])
    assert json.loads(text) == port


def test_cli_evaluate_writes_telemetry_eval(run_dir):
    d = os.path.join(run_dir["run"], "telemetry_eval")
    s = ttelemetry.summarize(d)
    assert s == jtelemetry.summarize(d)
    assert s["health"]["records"] == 1 and "evaluate" in s["spans"]
    assert s["recompiles"]["jit_recompiles_total"] >= 1


def test_online_status_renders_as_jax(run_dir):
    for argv in ([run_dir["run"]], [run_dir["run"], "--json"]):
        assert _run(tonline.main, ["status"] + argv) == _run(jonline.main, ["status"] + argv)
    code, text = _run(tonline.main, ["status", run_dir["run"]])
    assert code == 0 and text.startswith("px_divergence")


# --------------------------------------------------------------------- gates
def test_baseline_check_and_exit_codes_equal_jax(run_dir, tmp_path):
    d = run_dir["run"]
    base = {n: str(tmp_path / f"{n}.json") for n in ("jax", "torch")}
    for name, fn in (("jax", jtelemetry.check_main), ("torch", ttelemetry.check_main)):
        code, text = _run(fn, [d, "--baseline", base[name], "--write-baseline"])
        assert code == 0 and "gate entries" in text
    tb, jb = (json.load(open(base[n])) for n in ("torch", "jax"))
    assert tb == jb and tb["entries"]
    summary = ttelemetry.summarize(d)
    assert ttelemetry.check(summary, tb) == jtelemetry.check(summary, tb)
    for fn in (ttelemetry.check_main, jtelemetry.check_main):
        assert _run(fn, [d, "--baseline", base["torch"]])[0] == 0
    bad = copy.deepcopy(tb)
    for e in bad["entries"]:
        if e["key"] == "steps.images_per_sec":
            e["value"] *= 100.0
    bad["entries"].append({"key": "serving.request_p99_seconds", "value": 1.0,
                           "direction": "lower", "rel_tol": 0.3, "abs_tol": 0.0})
    bad_path = str(tmp_path / "bad.json")
    json.dump(bad, open(bad_path, "w"))
    outs = [_run(fn, [d, "--baseline", bad_path, "--json"])
            for fn in (ttelemetry.check_main, jtelemetry.check_main)]
    assert outs[0] == outs[1] and outs[0][0] == 1
    assert json.loads(outs[0][1])["failed"] == 2
    assert ttelemetry.build_baseline(summary) == jtelemetry.build_baseline(summary)


def _tamper(rec, what):
    rec = copy.deepcopy(rec)
    if what == "weight_rows":
        rec["weights"]["f32_total"] += 1
    elif what == "parity":
        rec["parity"]["max_logit_delta"] += 1e-3
    elif what == "ladder":
        rec["planner"]["int8_buckets_fit"] = rec["planner"]["f32_buckets_fit"]
    elif what == "hbm_drop":
        rec["planner"]["per_replica_hbm_drop_bytes"] += 1
    elif what == "drill":
        rec["drill"]["swap_reject"] = "fingerprint_mismatch"
    elif what == "auroc":
        pair = rec["trust"]["int8"]["pairs"][0]
        pair["auroc"] = pair["auroc"] + 0.01
    return rec


@pytest.mark.parametrize("what", ["clean", "weight_rows", "parity", "ladder", "hbm_drop",
                                  "drill", "auroc"])
def test_quant_gates_equal_jax(what, tmp_path):
    rec = json.load(open(QUANT_RECORD))
    rec = rec if what == "clean" else _tamper(rec, what)
    got, want = ttelemetry.quant_gates(rec), jtelemetry.quant_gates(rec)
    assert got == want
    assert got["ok"] is (what == "clean")
    assert got["failed"] == (0 if what == "clean" else 1)
    path = str(tmp_path / "q.json")
    json.dump(rec, open(path, "w"))
    assert _run(ttelemetry.main, ["check", "--quant", path])[0] == \
        _run(jtelemetry.main, ["check", "--quant", path])[0] == (0 if what == "clean" else 1)


def test_drift_drill_gate_equals_jax(tmp_path):
    for rec in (json.load(open(DRILL_RECORD)), {"online": {}}):
        path = str(tmp_path / "d.json")
        json.dump(rec, open(path, "w"))
        t = _run(ttelemetry.check_main, ["--drift-drill", path, "--json"])
        assert t == _run(jtelemetry.check_main, ["--drift-drill", path, "--json"])
    assert _run(ttelemetry.check_main, ["--drift-drill", DRILL_RECORD])[0] == \
        _run(jtelemetry.check_main, ["--drift-drill", DRILL_RECORD])[0]


# ------------------------------------------------------------------- wiring
def _batches(n, b=6, last=None, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [b] * n + ([last] if last else [])
    return [(rng.normal(size=(s, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 4, size=s)) for s in sizes]


@pytest.mark.parametrize("sharded", [False, True])
def test_train_epoch_monitor_counts_and_leaves_the_state_unchanged(sharded):
    """The monitor reads the step log (no device read of its own): the
    state after an epoch is bit-equal with it on and off; steps, images,
    host-to-device bytes and cold paths (one per batch shape) counted."""
    import torch

    from mgproto_tpu_torch.parallel.trainer import ShardedTrainer

    cfg = tiny_test_config()
    make = (lambda: ShardedTrainer(cfg, 4, device="cpu")) if sharded else \
        (lambda: Trainer(cfg, 4, device="cpu"))
    states = []
    for on in (False, True):
        tr = make()
        st = tr.init_state(0)
        reg = treg.MetricRegistry()
        mon = tmonitor.StepMonitor(registry=reg).watch(tr.cold_paths.total) if on else None
        st, _ = tr.train_epoch(st, _batches(3, last=4), 0, monitor=mon)
        states.append(st)
        if on:
            snap = reg.snapshot()
            value = {k: snap[k]["series"][0]["value"] for k in
                     ("steps_total", "images_total", "host_transfer_bytes_total",
                      "jit_recompiles_total")}
            assert value == {"steps_total": 4, "images_total": 22,
                             "host_transfer_bytes_total": sum(r.h2d_bytes for r in tr.step_log),
                             "jit_recompiles_total": 2}
            assert mon.epoch_images == 22
            assert abs(mon.epoch_seconds - sum(r.step_s for r in tr.step_log)) < 1e-9
    a, b = states
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    for x, y in zip((*a.gmm, *a.memory), (*b.gmm, *b.memory)):
        assert torch.equal(x, y)


def test_the_serving_engine_monitor_counts_dispatches_and_cold_buckets(tmp_path):
    """An engine or a consolidator built while a telemetry session is open
    observes into the session's registry; built without one, it keeps no
    monitor and records no step series."""
    from test_torch_serving_plane import MODS, FakeClock, make_engine, payload

    from mgproto_tpu_torch.online.consolidate import Consolidator, ConsolidatorConfig

    reg = treg.MetricRegistry()
    prev = tmetrics.set_current_registry(reg)
    try:
        bare = make_engine(MODS["torch"], FakeClock(), buckets=(1, 2))
        bare.serve_all([payload(0)])
    finally:
        tmetrics.set_current_registry(prev)
    assert bare.monitor is None and "steps_total" not in reg.snapshot()
    trainer = Trainer(tiny_test_config(), steps_per_epoch=1, device="cpu")
    state = trainer.init_state(0)
    assert Consolidator(trainer, state, config=ConsolidatorConfig(batch_width=8)).monitor is None
    telem = tsession.TelemetrySession(str(tmp_path / "t"))
    try:
        eng = make_engine(MODS["torch"], FakeClock(), buckets=(1, 2))
        eng.buckets = (1, 2, 4)  # bucket 4 was never warmed
        eng.serve_all([payload(i) for i in range(4)])
        cons = Consolidator(trainer, state, config=ConsolidatorConfig(batch_width=8))
    finally:
        telem.close()
    assert tsession.current_session() is None
    assert cons.monitor.registry is telem.registry and cons.monitor.phase == "online"
    assert eng.check_cold_dispatches() == 1
    snap = telem.registry.snapshot()
    assert snap["steps_total"]["series"] == [{"labels": {"phase": "serve"}, "value": 1.0}]
    assert snap["jit_recompiles_total"]["series"][0]["value"] == 3.0  # 2 warmed + 1 cold


def test_the_session_writes_sidecars_and_meta_on_rank_0_only(tmp_path):
    d = str(tmp_path / "t")
    prev = treg.default_registry()
    sessions = [tsession.TelemetrySession(d, host=h) for h in (0, 2)]
    assert treg.default_registry() is sessions[1].registry
    for s in sessions:
        s.observe_state_bytes({"bank_bytes_per_chip": 7, "opt_bytes_per_chip": 9})
        s.observe_em(3, 1)
        s.write_meta({"x": 1})
        s.flush(step=1)
    for s in reversed(sessions):
        s.close()
    assert treg.default_registry() is prev
    files = set(os.listdir(d))
    assert {"metrics.jsonl", "metrics.prom", "trace.json", "meta.json", "health.jsonl",
            "metrics.jsonl.h2", "metrics.prom.h2", "trace.json.h2", "health.jsonl.h2"} == files
    rec = [json.loads(ln) for ln in open(os.path.join(d, "metrics.jsonl.h2"))]
    assert rec[0]["host"] == 2 and rec[0]["metrics"]["bank_bytes_per_chip"]["series"][0][
        "value"] == 7
    assert tsession.make_session(d, enabled=False) is None
    assert tsession.make_session("", enabled=True) is None


def test_cli_serve_telemetry_dir_and_auto_tune_fails_closed_on_the_cpu(run_dir, tmp_path,
                                                                        monkeypatch):
    x = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
    npy = str(tmp_path / "x.npy")
    np.save(npy, x)
    d = str(tmp_path / "serve_tel")
    with contextlib.redirect_stdout(io.StringIO()):
        tserve.main(["--device", "cpu", "--artifact", run_dir["art"], "--images", npy,
                     "--telemetry_dir", d])
    s = ttelemetry.summarize(d)
    assert s == jtelemetry.summarize(d)
    assert sum(s["serving"]["requests_by_outcome"].values()) == 3
    assert s["steps"]["steps_total"] >= 1 and s["recompiles"]["jit_recompiles_total"] == 4
    # --auto_tune on the CPU: the measure refuses, every bucket is rejected
    # with that reason, and the main fails closed before any warmup
    monkeypatch.setenv("MGPROTO_HBM_BUDGET_BYTES", str(1 << 34))
    d2 = str(tmp_path / "tuned")
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(SystemExit, match="no warmup bucket fits"):
        tserve.main(["--device", "cpu", "--artifact", run_dir["art"], "--images", npy,
                     "--telemetry_dir", d2, "--auto_tune"])
    meta = json.load(open(os.path.join(d2, "meta.json")))["autotune"]
    assert meta["rejected"] == 4 and all("CUDA" in c["error"] for c in meta["candidates"])


def test_a_replica_death_dumps_the_flight_recorder_as_jax(tmp_path):
    from test_torch_serving_plane import MODS, FakeClock, make_set, payload

    from mgproto_tpu.obs import flightrec as jflightrec

    out = {}
    for name, rec_mod in (("jax", jflightrec), ("torch", flightrec)):
        d = str(tmp_path / name)
        prev = rec_mod.set_recorder(rec_mod.FlightRecorder(dump_dir=d))
        try:
            clock = FakeClock()
            rs = make_set(MODS[name], clock)
            rs.start()
            rs.replicas[0].alive = False
            rs.submit(payload(0), request_id="a")
            clock.advance(1.0)
            rs.poll()
        finally:
            rec_mod.set_recorder(prev)
        files = sorted(os.listdir(d))
        events = [json.loads(ln) for ln in open(os.path.join(d, files[0]))]
        out[name] = (files, [(e.get("kind"), e.get("replica"), e.get("reason"))
                             for e in events[1:] if e.get("kind") == "replica_failure"])
    assert out["torch"] == out["jax"] == (["flightrec_replica_dead_000.jsonl"],
                                          [("replica_failure", "r0", "dead")])


def test_hbm_bucket_prep_plans_each_new_engine(monkeypatch):
    from test_torch_serving_plane import MODS, FakeClock, make_engine, make_set

    from mgproto_tpu_torch.perf import planner as tp
    from mgproto_tpu_torch.serving.autoscale import hbm_bucket_prep

    monkeypatch.setattr(tp, "serve_bucket_measure",
                        lambda engine: (lambda cand: (cand.batch * 1000, {})))
    clock = FakeClock()
    factory = lambda: make_engine(MODS["torch"], clock, buckets=(1, 2, 4), warm=False)  # noqa
    rs = make_set(MODS["torch"], clock, factory=factory,
                  engine_prep=hbm_bucket_prep(budget_bytes=4_500, margin=0.0, weight_bytes=2_000))
    assert rs.start() == 4  # buckets 1 and 2 on each of two replicas
    assert [r.engine.buckets for r in rs.replicas] == [(1, 2), (1, 2)]
    with pytest.raises(RuntimeError, match="no warmup bucket fits"):
        hbm_bucket_prep(budget_bytes=10, margin=0.0)(factory())
    rep = rs.add_replica()
    rs.poll()
    assert rep.engine.buckets == (1, 2)


def test_timed_span_records_a_trace_span():
    from mgproto_tpu_torch.utils.log import Logger, timed_span

    tr = ttracing.Tracer()
    prev = ttracing.set_current_tracer(tr)
    try:
        with contextlib.redirect_stdout(io.StringIO()), timed_span(Logger(None), "push") as sp:
            pass
    finally:
        ttracing.set_current_tracer(prev)
    assert "s" in sp and [s["name"] for s in tr.spans()] == ["push"]


def test_unported_gates_stay_refused_under_their_label(run_dir):
    from mgproto_tpu_torch.cli.common import NotPortedError

    for argv in (["check", "--autoscale", QUANT_RECORD], ["fleet", run_dir["run"]],
                 ["check", run_dir["run"], "--baseline", "b.json", "--write-baseline",
                  "--fleet-gates"]):
        with pytest.raises(NotPortedError, match=r"A9 \(obs and telemetry\)"):
            ttelemetry.main(argv)


def test_the_plan_outcome_meta_is_json():
    from mgproto_tpu_torch.perf.planner import PlanCandidate, PlanOutcome, PlanReport

    rep = PlanReport(PlanCandidate(batch=8), 10, True, {"bank_bytes_per_chip": 5})
    out = PlanOutcome(rep, (rep, dataclasses.replace(rep, fits=False, error="E")), 100, 0.1)
    meta = json.loads(json.dumps(out.to_meta()))
    assert meta["rejected"] == 1 and meta["plan"]["bank_bytes_per_chip"] == 5
    assert meta["candidates"][1]["error"] == "E"
