"""The port's memory planner (mgproto_tpu_torch/perf/planner.py) against the
JAX package's (mgproto_tpu/perf/planner.py), on the CPU.

  * The candidate ladder's names are equal, for the tiny config, the
    flagship and the opt-in dtype axis.
  * Under the same simulated measure `HBMPlanner.plan` and `autotune` give
    equal outcomes (`to_meta`): a 16 GiB budget with and without the remat
    variant, the margin environment and no fit, a failing measure, and the
    prefetch rescue through `make_cached_measure` (one measured program per
    prefetch ladder).
  * `state_bytes_per_chip` equals JAX's exactly at the tiny and flagship
    shapes, model axis 1 and 2, with and without the quantized parameters,
    and for an aux loss without proxies.
  * `plan_serve_buckets` with the weight term gives JAX's ladders.
  * The port's own design: the default measure and the default budget
    raise without a CUDA device (they do not estimate), a failed default
    measure is a rejection naming the reason, and the throwaway state's
    clone steps on the CPU under another remat plan.
  * `cli.train --auto_tune` on the CPU with an injected measure: the plan
    in meta.json and in the checkpoint, and `--resume auto --auto_tune`
    adopting it.
  * Two gloo ranks whose injected measures disagree (each rank its own
    peaks and budget, one rank failing a candidate the other fits) plan
    one batch for the world through `cli.train`'s planning step.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from _torch_jax_states import write_jpeg_tree
from mgproto_tpu.config import Config as JaxConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.perf import planner as jp
from mgproto_tpu_torch.config import Config, DataConfig, tiny_test_config
from mgproto_tpu_torch.perf import planner as tp

SIXTEEN_GB = 16 * 1024 ** 3
PKGS = {"jax": jp, "torch": tp}


def _fake_measure(peaks):
    def measure(cand):
        return peaks[cand.name], {"simulated": True}
    return measure


def _both(fn):
    return {name: fn(mod) for name, mod in PKGS.items()}


# --------------------------------------------------------------- candidates
@pytest.mark.parametrize("which", ["tiny", "flagship", "flagship_bf16", "densenet_async"])
def test_candidate_names_equal_jax(which, monkeypatch):
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    kw = {}
    if which.startswith("flagship"):
        jcfg, tcfg = JaxConfig(), Config()
    if which == "flagship_bf16":
        monkeypatch.setenv("MGPROTO_AUTOTUNE_DTYPES", "bfloat16")
    if which == "densenet_async":
        jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, arch="densenet121"))
        tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, arch="densenet121"))
        kw = {"async_bank": True, "batches": [6, 12]}
    jnames = [c.name for c in jp.candidate_plans(jcfg, **kw)]
    tnames = [c.name for c in tp.candidate_plans(tcfg, device="cpu", **kw)]
    assert tnames == jnames and jnames


# --------------------------------------------------------------- decisions
def _plan(mod, peaks, cands, **kw):
    planner = mod.HBMPlanner(measure=_fake_measure(peaks), **kw)
    return planner.plan(None, [mod.PlanCandidate(**c) for c in cands]).to_meta()


def test_plan_16gb_budget_matches_jax():
    b256, b512, l1 = dict(batch=256), dict(batch=512), dict(batch=512, remat_stages=("layer1",))
    peaks = {"b256_pf2": int(10.0e9), "b512_pf2": int(20.0e9),
             "b512_remat_layer1_pf2": int(13.0e9)}
    for cands, batch in (([b256, b512], 256), ([b256, b512, l1], 512)):
        out = _both(lambda m: _plan(m, peaks, cands, budget_bytes=SIXTEEN_GB, margin=0.08))
        assert out["torch"] == out["jax"]
        assert out["torch"]["plan"]["batch"] == batch and out["torch"]["rejected"] == 1


def test_plan_margin_env_and_no_fit_matches_jax(monkeypatch):
    monkeypatch.setenv("MGPROTO_HBM_MARGIN", "0.5")
    peaks = {"b256_pf2": int(15.0e9)}
    out = _both(lambda m: _plan(m, peaks, [dict(batch=256)], budget_bytes=SIXTEEN_GB))
    assert out["torch"] == out["jax"]
    assert out["torch"]["plan"] is None and out["torch"]["margin"] == 0.5
    # autotune then keeps the base config
    for mod, cfg in ((jp, jax_tiny_config()), (tp, tiny_test_config())):
        cfg2, outcome = mod.autotune(cfg, budget_bytes=SIXTEEN_GB,
                                     candidates=[mod.PlanCandidate(batch=256)],
                                     measure=_fake_measure(peaks))
        assert outcome.chosen is None and cfg2 == cfg


def test_a_failing_measure_is_a_rejection_as_in_jax():
    def measure(cand):
        if cand.batch == 512:
            raise RuntimeError("simulated blowup")
        return int(1e9), {}

    out = _both(lambda m: m.HBMPlanner(budget_bytes=SIXTEEN_GB, margin=0.0, measure=measure)
                .plan(None, [m.PlanCandidate(batch=256), m.PlanCandidate(batch=512)]).to_meta())
    assert out["torch"] == out["jax"]
    bad = out["torch"]["candidates"][1]
    assert not bad["fits"] and "simulated blowup" in bad["error"]


def test_prefetch_rescue_matches_jax(monkeypatch):
    """`make_cached_measure` measures one program per prefetch ladder and
    adds the headroom by arithmetic; a budget between the pf0 and pf2
    peaks picks pf0 in both packages."""
    calls = {"jax": [], "torch": []}

    def fake(name):
        def measure_candidate(base_cfg, cand, *a, **k):
            calls[name].append(cand)
            peak = 1_000_000 * cand.batch
            return peak, {"per_chip_batch": cand.batch, "program_peak_bytes": peak}
        return measure_candidate

    monkeypatch.setattr(jp, "measure_candidate", fake("jax"))
    monkeypatch.setattr(tp, "measure_candidate", fake("torch"))
    cfgs = {"jax": jax_tiny_config(), "torch": tiny_test_config()}

    def run(name):
        mod, cfg = PKGS[name], cfgs[name]
        cands = [c for c in (jp.candidate_plans(cfg, batches=[8]) if name == "jax"
                             else tp.candidate_plans(cfg, batches=[8], device="cpu"))]
        measure = mod.make_cached_measure(cfg)
        peaks = {c.prefetch_depth: measure(c)[0] for c in cands}
        headroom = peaks[2] - peaks[0]
        planner = mod.HBMPlanner(budget_bytes=peaks[0] + headroom // 2, margin=0.0,
                                 measure=measure)
        return peaks, planner.plan(cfg, cands).to_meta()

    out = {name: run(name) for name in PKGS}
    assert out["torch"] == out["jax"]
    peaks, meta = out["torch"]
    assert peaks[2] - peaks[0] == 2 * tp.batch_bytes(8, 32, False)
    assert meta["plan"]["prefetch_depth"] == 0 and meta["rejected"] == 1
    assert len(calls["torch"]) == len(calls["jax"]) == 1


def test_plan_serve_buckets_ladders_match_jax():
    eng = types.SimpleNamespace(buckets=(1, 2, 4, 8), img_size=8)

    def measure(cand):
        return cand.batch * 1000, {}

    for weight in (8_000, 2_000, 0):
        out = _both(lambda m: (lambda r: (r[0], r[1].to_meta()))(m.plan_serve_buckets(
            eng, budget_bytes=12_000, margin=0.0, measure=measure, weight_bytes=weight)))
        assert out["torch"] == out["jax"]
    fit_f32 = tp.plan_serve_buckets(eng, budget_bytes=12_000, margin=0.0, measure=measure,
                                    weight_bytes=8_000)[0]
    fit_q = tp.plan_serve_buckets(eng, budget_bytes=12_000, margin=0.0, measure=measure,
                                  weight_bytes=2_000)[0]
    assert fit_f32 == [1, 2, 4] and fit_q == [1, 2, 4, 8]


# --------------------------------------------------------------- byte counts
@pytest.mark.parametrize("quant", ["", "int8"])
@pytest.mark.parametrize("model", [1, 2])
@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_state_bytes_per_chip_equals_jax(which, model, quant):
    jcfg, tcfg = (jax_tiny_config(), tiny_test_config()) if which == "tiny" else (JaxConfig(),
                                                                                  Config())
    got = tp.state_bytes_per_chip(tcfg, model, quant_mode=quant)
    assert got == jp.state_bytes_per_chip(jcfg, model, quant_mode=quant)
    if quant:
        assert got["param_bytes_per_chip"] < got["param_bytes_per_chip_f32"]


def test_state_bytes_without_proxies_equal_jax():
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    jcfg = jcfg.replace(loss=dataclasses.replace(jcfg.loss, aux_loss="ms"))
    tcfg = tcfg.replace(loss=dataclasses.replace(tcfg.loss, aux_loss="ms"))
    assert tp.state_bytes_per_chip(tcfg) == jp.state_bytes_per_chip(jcfg)
    # a mesh's model axis from the config
    tcfg2 = tcfg.replace(mesh=dataclasses.replace(tcfg.mesh, model=2))
    assert tp.state_bytes_per_chip(tcfg2) == tp.state_bytes_per_chip(tcfg, 2)


# ------------------------------------------------------- the port's measure
def test_the_default_measure_and_budget_raise_without_cuda(monkeypatch):
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.measure_candidate(cfg, tp.PlanCandidate(batch=8), device="cpu")
    monkeypatch.delenv(tp.BUDGET_ENV, raising=False)
    with pytest.raises(RuntimeError, match=tp.BUDGET_ENV):
        tp.default_budget_bytes("cpu")
    monkeypatch.setenv(tp.BUDGET_ENV, "1234")
    assert tp.default_budget_bytes("cpu") == (1234, "env")
    # through the planner: a rejection carrying the reason, never an estimate
    out = tp.HBMPlanner(margin=0.0, device="cpu").plan(cfg, [tp.PlanCandidate(batch=8)])
    assert out.chosen is None and "CUDA" in out.reports[0].error
    eng = types.SimpleNamespace(buckets=(1, 2), img_size=8, device="cpu")
    fitting, outcome = tp.plan_serve_buckets(eng, budget_bytes=SIXTEEN_GB)
    assert fitting == [] and all("CUDA" in r.error for r in outcome.reports)


def test_the_throwaway_state_clones_for_a_candidate_and_steps():
    """The measure's state, built once and cloned per candidate config
    (here on the CPU, where the measure itself refuses): the clone holds
    the base weights, a full bank marked updated, fresh optimizers, and
    the candidate's remat; a step on it runs the widest EM."""
    import torch

    from mgproto_tpu_torch.engine.train import Trainer

    cfg = tiny_test_config()
    base = tp.ThrowawayState(cfg, "cpu", seed=0)
    cand = tp.PlanCandidate(batch=4, remat_stages=("layer1",), prefetch_depth=0)
    ccfg = tp.plan_config(cfg.replace(model=dataclasses.replace(cfg.model, arch="resnet18")),
                          cand)
    with pytest.raises(RuntimeError):  # weights of another trunk
        tp.ThrowawayState(cfg, "cpu").clone(ccfg)
    state = base.clone(tp.plan_config(cfg, tp.PlanCandidate(batch=4)))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, base.weights[k]), k
    assert bool((state.memory.length == cfg.model.mem_capacity).all())
    assert bool(state.memory.updated.all()) and not state.opt.state
    trainer = Trainer(tp.plan_config(cfg, tp.PlanCandidate(batch=4)), 100, device="cpu")
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32)
    state, met = trainer.train_step(state, x, np.arange(4) % 4, use_mine=True, update_gmm=True)
    assert not met.nonfinite and met.em_active == cfg.model.num_classes
    # the base is untouched by the clone's step
    assert bool(base.memory.updated.all())
    rcfg = cfg.replace(model=dataclasses.replace(cfg.model, arch="resnet18"))
    rbase = tp.ThrowawayState(rcfg, "cpu")
    rstate = rbase.clone(tp.plan_config(rcfg, cand))
    assert rstate.model.cfg.remat_stages == ("layer1",)
    meta = tp.meta_state(rcfg)
    assert next(meta.model.parameters()).device.type == "meta"


# ---------------------------------------------------------- cli.train e2e
def test_cli_train_auto_tune_records_and_resume_adopts_the_plan(tmp_path, monkeypatch):
    """The counterpart of JAX's `test_autotune_cli_e2e_records_plan`, with
    the measure injected (the port's measure runs on the card)."""
    from mgproto_tpu_torch.cli import telemetry as ttelemetry
    from mgproto_tpu_torch.cli.train import run_training
    from mgproto_tpu_torch.utils.checkpoint import find_latest_checkpoint, load_metadata

    def fake(base_cfg, cand, *a, **k):
        peak = 1_000 * cand.batch
        return peak, {"per_chip_batch": cand.batch, "program_peak_bytes": peak,
                      **tp.state_bytes_per_chip(tp.plan_config(base_cfg, cand))}

    monkeypatch.setattr(tp, "measure_candidate", fake)
    monkeypatch.setenv(tp.BUDGET_ENV, str(SIXTEEN_GB))
    root = write_jpeg_tree(str(tmp_path / "train"), 4, 6, seed=0)
    cfg = tiny_test_config()
    cfg = cfg.replace(
        schedule=dataclasses.replace(cfg.schedule, num_train_epochs=1, push_start=5),
        data=DataConfig(train_dir=root, test_dir=root, train_push_dir=root, train_batch_size=4,
                        test_batch_size=4, train_push_batch_size=4, num_workers=0),
        model_dir=str(tmp_path / "run"))
    state, _ = run_training(cfg, auto_tune=True, device="cpu")
    meta = json.loads((tmp_path / "run" / "telemetry" / "meta.json").read_text())
    plan = meta["autotune"]["plan"]
    # {4, 8, 16} x prefetch {2, 0}, all fit: the largest batch at the deeper prefetch
    assert plan["batch"] == 16 and plan["prefetch_depth"] == 2 and plan["fits"]
    assert len(meta["autotune"]["candidates"]) == 6
    assert plan["bank_bytes_per_chip"] == meta["bank_bytes_per_chip"]
    summary = ttelemetry.summarize(str(tmp_path / "run"))
    assert summary["meta"]["autotune"]["plan"]["batch"] == 16
    assert "plan=b16_pf2" in ttelemetry.render_table(summary)
    assert summary["em"]["autotune_plan_rejected_total"] == 0
    ckpt = find_latest_checkpoint(str(tmp_path / "run"))
    assert (load_metadata(ckpt) or {})["autotune_plan"]["batch"] == 16
    assert state.step >= 1
    # a resumed run adopts the checkpoint's plan: no measure runs
    monkeypatch.setattr(tp, "measure_candidate", None)
    run_training(cfg, resume="auto", auto_tune=True, device="cpu")
    log = (tmp_path / "run" / "train.log").read_text()
    assert "adopts checkpointed plan b16_pf2" in log
    assert os.path.isfile(tmp_path / "run" / "telemetry" / "metrics.prom")


# --------------------------------------------------------- several ranks
RANK_PLANNER = r"""
import json, os, sys
import torch.distributed as dist
from mgproto_tpu_torch.cli import train
from mgproto_tpu_torch.config import DataConfig, tiny_test_config
from mgproto_tpu_torch.perf import planner as tp

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
GIB = 1024 ** 3
# rank 0 alone would run b16; rank 1 alone b4 (its b8 fails, its b16 is
# over its own budget)
PEAKS = {0: {4: 1, 8: 2, 16: 12}, 1: {4: 1, 8: None, 16: 13}}
os.environ[tp.BUDGET_ENV] = str((16 if rank == 0 else 12) * GIB)


def measure(base_cfg, cand, *a, **k):
    peak = PEAKS[rank][cand.batch]
    if peak is None:
        raise RuntimeError("simulated out of memory")
    return peak * GIB, {"per_chip_batch": cand.batch // 2, "program_peak_bytes": peak * GIB}


tp.measure_candidate = measure
cfg = tiny_test_config()
cfg = cfg.replace(data=DataConfig(train_batch_size=2))
cfg, outcome, plan = train._autotune(cfg, True, None, 2, "cpu", lambda s: None)
with open(out, "w") as f:
    json.dump({"batch": cfg.data.train_batch_size, "plan": plan,
               "outcome": outcome.to_meta()}, f)
dist.destroy_process_group()
"""


def test_ranks_agree_on_one_plan_when_their_measures_differ(tmp_path):
    """Each rank measures its own card, so peaks, failures and budgets
    differ between ranks; the world still runs one plan: the smallest
    budget, each candidate's largest peak, a failure on one rank rejecting
    the candidate on both."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_PLANNER, str(r), str(port),
                               str(tmp_path / f"rank{r}.json")],
                              cwd=repo, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    deadline, errors = time.monotonic() + 90, []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
        if p.returncode:
            errors.append(f"rank {r}: exit {p.returncode}\n{err[-3000:]}")
    assert not errors, "\n".join(errors)
    got = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert got[0]["plan"] == got[1]["plan"] and got[0]["plan"]["name"] == "b4_pf2"
    assert got[0]["batch"] == got[1]["batch"] == 2  # the global b4 over two ranks
    for rank in got:
        out = rank["outcome"]
        assert out["budget_bytes"] == 12 * 1024 ** 3
        by_name = {c["name"]: c for c in out["candidates"]}
        assert by_name["b16_pf0"]["peak_bytes"] == 13 * 1024 ** 3  # rank 1's
        assert not by_name["b16_pf2"]["fits"] and not by_name["b8_pf2"]["fits"]
        assert by_name["b8_pf2"]["error"]
    assert "simulated out of memory" in got[1]["outcome"]["candidates"][2]["error"]
    assert got[0]["outcome"]["candidates"][2]["error"] == "the measure failed on another rank"
