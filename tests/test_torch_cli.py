"""The port's command line (mgproto_tpu_torch/cli/{common,train,evaluate,
interpret}.py) against the JAX package's, on the CPU.

  * Every action of the JAX `add_train_args` parser exists in the port's
    under the same option strings, with the same default (and choices);
    the port adds `--device` only.
  * For a set of argvs (the defaults, each dataset preset, remat stages,
    bf16, each aux loss, the EM and input flags), every field of the
    port's Config equals the JAX Config's field of the same name.
  * The flags the port does not implement parse, and are refused at any
    other value than their default with the ROADMAP item that ports them;
    the profiler flags, refused before, reach run_training.
  * The mains end to end on the tiny config with `--device cpu` (the
    counterparts of tests/test_cli.py and tests/test_cli_eval_drivers.py):
    `cli.train.main` runs the schedule (stage checkpoints, logs, metrics);
    `cli.evaluate.main` on its prune checkpoint prints the accuracy the
    run's last test pass wrote; `cli.interpret.main` prints the metrics
    `run_interpret` returns on the same checkpoint and mini-CUB.
  * `python -m mgproto_tpu_torch.cli.{train,evaluate,interpret,prep}
    --help` runs with JAX and the JAX package blocked from import.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from _torch_jax_states import write_jpeg_tree
from mgproto_tpu.cli import common as jcommon
from mgproto_tpu_torch.cli import common as tcommon
from mgproto_tpu_torch.cli import evaluate as tevaluate
from mgproto_tpu_torch.cli import interpret as tinterpret
from mgproto_tpu_torch.cli import train as ttrain
from mgproto_tpu_torch.utils import checkpoint as tck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parser(module):
    p = argparse.ArgumentParser()
    module.add_train_args(p)
    return p


def _actions(p):
    return {a.dest: a for a in p._actions if a.dest != "help"}


JAX_ACTIONS = _actions(_parser(jcommon))
PORT_ACTIONS = _actions(_parser(tcommon))


@pytest.mark.parametrize("dest", sorted(JAX_ACTIONS))
def test_every_jax_flag_parses_with_its_default(dest):
    ja, pa = JAX_ACTIONS[dest], PORT_ACTIONS[dest]
    assert set(ja.option_strings) <= set(pa.option_strings)
    assert pa.default == ja.default
    assert pa.choices == ja.choices
    assert type(pa) is type(ja)


def test_the_port_adds_only_device():
    assert set(PORT_ACTIONS) - set(JAX_ACTIONS) == {"device"}
    assert PORT_ACTIONS["device"].default == "cuda"
    # both negative forms of the tri-state flags share their dest
    p = _parser(tcommon)
    for flag, dest in (("--no_fused_scoring", "fused_scoring"), ("--no_fused_epilogue",
                       "fused_epilogue"), ("--no_fused_estep", "fused_estep"),
                       ("--no_device_augment", "device_augment")):
        assert getattr(p.parse_args([flag]), dest) is False


ARGVS = {
    "defaults": [],
    **{f"preset_{d}": ["--dataset", d] for d in sorted(jcommon.DATASET_PRESETS)},
    "paths": ["--data_root", "/d", "--train_dir", "/t", "--ood_dir", "/o1", "--ood_dir", "/o2",
              "--model_dir", "/m", "--num_classes", "7"],
    "remat_stages": ["--remat_stages", "layer1,layer3", "--arch", "resnet18"],
    "remat": ["--remat", "--arch", "densenet121", "--remat_stages", "denseblock1"],
    "bf16": ["--compute_dtype", "bfloat16", "--no_fused_epilogue"],
    **{f"aux_{a}": ["--aux_loss", a] for a in ("proxy_anchor", "proxy_nca", "ms",
                                              "contrastive", "triplet", "npair")},
    "em": ["--em_reference_stepping", "--em_max_active", "0", "--no_fused_estep",
           "--fused_scoring"],
    "schedule": ["--epochs", "3", "--warm_epochs", "1", "--mine_start", "2", "--gmm_start", "1",
                 "--push_start", "1", "--push_every", "2", "--prune_top_m", "4",
                 "--prune_renormalize", "--no_pretrained", "--seed", "5"],
    "input": ["--batch_size", "16", "--num_workers", "3", "--worker_backend", "process",
              "--device_augment", "--prefetch-depth", "4", "--img_size", "64",
              "--protos_per_class", "5", "--proto_dim", "32", "--aux_emb_sz", "16",
              "--mem_sz", "100", "--mine_level", "7"],
    "accepted": ["--no_async_bank", "--ckpt_format", "replicated", "--no-telemetry",
                 "--keep_last", "2", "--target_accu", "0.5"],
    # refused until the async bank pipeline was ported; now it sets the field
    "async_bank": ["--async_bank"],
    # refused until the pod fault tolerance was ported: the async bank under
    # a mesh, sharded checkpoints and the guarded barrier's timeout
    "pod": ["--async_bank", "--mesh_model", "2", "--ckpt_format", "sharded",
            "--barrier_timeout_s", "10"],
}


def _assert_fields_equal(port, ref, path=""):
    for f in dataclasses.fields(port):
        value = getattr(port, f.name)
        if dataclasses.is_dataclass(value):
            _assert_fields_equal(value, getattr(ref, f.name), f"{path}{f.name}.")
        else:
            assert value == getattr(ref, f.name), f"{path}{f.name}"


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_config_fields_equal_jax(case):
    argv = ARGVS[case]
    port = tcommon.config_from_args(_parser(tcommon).parse_args(argv))
    ref = jcommon.config_from_args(_parser(jcommon).parse_args(argv))
    _assert_fields_equal(port, ref)


# the multi-GPU flags and the profiler's are ported but straggler
# detection, which waits for the rest of the obs plane
REFUSED_ARGVS = {
    "straggler_threshold": (["--straggler_threshold", "0.5"], "A9"),
    "straggler_patience": (["--straggler_patience", "2"], "A9"),
}
# refused until the observatory was ported: each now reaches run_training
PROFILER_ARGVS = {
    "profile_dir": (["--profile_dir", "/p"], "/p"),
    "profile_steps": (["--profile_steps", "3:5"], "3:5"),
    "profile_on_anomaly": (["--profile_on_anomaly"], True),
    "profile_out": (["--profile_out", "/p"], "/p"),
}


def test_every_refused_flag_has_a_case():
    assert {d for d, _, _ in tcommon.REFUSED} == set(REFUSED_ARGVS)


@pytest.mark.parametrize("dest", sorted(REFUSED_ARGVS))
def test_unported_flags_are_refused_with_their_roadmap_item(dest):
    argv, item = REFUSED_ARGVS[dest]
    args = _parser(tcommon).parse_args(argv)
    with pytest.raises(tcommon.NotPortedError, match=f"--{dest}=.*ROADMAP {item}"):
        tcommon.config_from_args(args)


@pytest.mark.parametrize("dest", sorted(PROFILER_ARGVS))
def test_the_profiler_flags_reach_run_training(dest, monkeypatch):
    """The profiler flags parse, pass config_from_args and reach
    run_training (tests/test_torch_obs.py runs them end to end)."""
    argv, want = PROFILER_ARGVS[dest]
    tcommon.config_from_args(_parser(tcommon).parse_args(argv))
    seen = {}
    monkeypatch.setattr(ttrain, "run_training", lambda cfg, **kw: seen.update(kw))
    monkeypatch.setattr(ttrain.preemption, "install_handlers", lambda: None)
    ttrain.main(["--device", "cpu"] + argv)
    assert seen[dest] == want


@pytest.mark.parametrize("argv,want", [
    ([], {"telemetry_dir": "", "telemetry": True, "auto_tune": False}),
    (["--auto_tune", "--telemetry-dir", "/t"],
     {"telemetry_dir": "/t", "telemetry": True, "auto_tune": True}),
    (["--telemetry_dir", "/u", "--no-telemetry"],
     {"telemetry_dir": "/u", "telemetry": False, "auto_tune": False}),
])
def test_the_telemetry_and_auto_tune_flags_reach_run_training(argv, want, monkeypatch):
    """--auto_tune and --telemetry_dir (refused before the planner and the
    telemetry plane were ported) and --no-telemetry reach run_training."""
    seen = {}
    monkeypatch.setattr(ttrain, "run_training", lambda cfg, **kw: seen.update(kw))
    monkeypatch.setattr(ttrain.preemption, "install_handlers", lambda: None)
    ttrain.main(["--device", "cpu"] + argv)
    assert {k: seen[k] for k in want} == want


# ------------------------------------------------------------- the mains
TINY_FLAGS = [
    "--dataset", "CUB", "--arch", "tiny", "--num_classes", "4", "--protos_per_class", "3",
    "--proto_dim", "8", "--aux_emb_sz", "8", "--mine_level", "4", "--mem_sz", "16",
    "--no_pretrained", "--batch_size", "6", "--num_workers", "0", "--device", "cpu",
]


def _last_json_line(captured: str) -> dict:
    lines = [ln for ln in captured.strip().splitlines() if ln.startswith("{")]
    assert lines, f"no JSON line in output:\n{captured}"
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The train main's run: (data flags, model_dir)."""
    root = tmp_path_factory.mktemp("cli")
    train = write_jpeg_tree(str(root / "train"), 4, 5, seed=0)
    ood = write_jpeg_tree(str(root / "ood"), 2, 3, seed=1)
    data = ["--img_size", "32", "--train_dir", train, "--test_dir", train, "--push_dir", train,
            "--ood_dir", ood]
    model_dir = str(root / "run")
    ttrain.main(TINY_FLAGS + data + [
        "--model_dir", model_dir, "--epochs", "2", "--mine_start", "0", "--gmm_start", "0",
        "--push_start", "1", "--push_every", "1", "--prune_top_m", "2",
        "--no_preempt_handlers"])
    return data, model_dir


def test_train_main_runs_the_schedule(trained):
    _, model_dir = trained
    stages = {c[1] for c in tck.list_checkpoints(model_dir)}
    assert stages == {"nopush", "push", "prune"}
    assert os.listdir(os.path.join(model_dir, "img", "epoch-1"))
    log = open(os.path.join(model_dir, "train.log")).read()
    assert "training done" in log and "arch='tiny'" in log
    rows = [json.loads(ln) for ln in open(os.path.join(model_dir, "metrics.jsonl"))]
    assert rows[-1]["stage"] == "prune"


def test_evaluate_main_prints_the_last_test_accuracy(trained, capsys):
    data, model_dir = trained
    capsys.readouterr()
    tevaluate.main(TINY_FLAGS + data + ["--model_dir", model_dir])
    out = _last_json_line(capsys.readouterr().out)
    prune = tck.list_checkpoints(model_dir)[-1]
    assert prune[1] == "prune" and out["checkpoint"] == prune[3]
    rows = [json.loads(ln) for ln in open(os.path.join(model_dir, "metrics.jsonl"))]
    assert out["accuracy"] == rows[-1]["acc"]
    for key in ("ood_thresh", "FPR95_1", "AUROC_1", "score_rule"):
        assert key in out
    assert out["score_rule"] == "sum"


def test_interpret_main_prints_run_interprets_metrics(tmp_path, capsys):
    from test_torch_interpretability import _write_layout

    from mgproto_tpu_torch.config import tiny_test_config
    from mgproto_tpu_torch.engine.train import Trainer

    cub = _write_layout(str(tmp_path / "cub"), 4, 3, ("beak", "tail", "crown"), 0, [(64, 48)])
    run_dir = str(tmp_path / "run")
    state = Trainer(tiny_test_config(), 1, device="cpu").init_state(0)
    tck.save_checkpoint(run_dir, state, "1nopush0.5000")
    csv = str(tmp_path / "p.csv")
    flags = ["--half_size", "8", "--purity_half_size", "6", "--purity_top_k", "2"]
    capsys.readouterr()
    tinterpret.main(TINY_FLAGS + ["--img_size", "32", "--cub_root", cub, "--model_dir", run_dir,
                                  "--export_csv", csv] + flags)
    out = _last_json_line(capsys.readouterr().out)
    cfg = tcommon.config_from_args(_parser(tcommon).parse_args(
        TINY_FLAGS + ["--img_size", "32", "--model_dir", run_dir]))
    want = tinterpret.run_interpret(cfg, cub, half_size=8, purity_half_size=6, purity_top_k=2,
                                    export_csv=str(tmp_path / "q.csv"), device="cpu")
    assert set(out) == {"consistency", "stability", "purity", "purity_std", "csv_rows", "csv"}
    for key in ("consistency", "stability", "purity", "purity_std", "csv_rows"):
        assert out[key] == want[key], key
    assert out["csv"] == csv and os.path.getsize(csv) > 0


BLOCKER = ("import sys, runpy; sys.modules['jax'] = None; sys.modules['mgproto_tpu'] = None; "
           "sys.argv = [sys.argv[1], '--help']; "
           "runpy.run_module(sys.argv[0], run_name='__main__')")


@pytest.mark.parametrize("main", ["train", "evaluate", "interpret", "prep"])
def test_help_runs_without_jax(main):
    r = subprocess.run([sys.executable, "-c", BLOCKER, f"mgproto_tpu_torch.cli.{main}"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "usage:" in r.stdout
