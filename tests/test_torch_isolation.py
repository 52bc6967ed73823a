"""mgproto_tpu_torch stands alone: no JAX, nothing of mgproto_tpu, neither
cv2 nor matplotlib (neither is known to exist beside the card), and no
silent CPU fallback at its entry points."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.core.mgproto import build_mgproto, init_gmm
from mgproto_tpu_torch.core.state import create_train_state
from mgproto_tpu_torch.engine.eval import Evaluator
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.numerics import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mgproto_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mgproto_tpu", "cv2", "matplotlib")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield SMOKE


def test_no_forbidden_imports_in_package_or_chip_smoke():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert not bad, bad


def test_imports_with_jax_and_mgproto_tpu_blocked():
    code = f"""
import importlib, importlib.util, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
import mgproto_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(mgproto_tpu_torch.__path__, "mgproto_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location("chip_smoke", {SMOKE!r})
importlib.util.module_from_spec(spec)
spec.loader.exec_module(importlib.util.module_from_spec(spec))
missing = [m for m in {INPUT_PATH_MODULES + INTERPRET_MODULES + OPTION_MODULES + SERVE_MODULES
                       + ONLINE_MODULES + TRUST_MODULES + PARALLEL_MODULES + OBS_MODULES!r}
           if m not in mods]
assert not missing, missing
print(len(mods))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


# the input path's modules, walked and imported above with JAX blocked
INPUT_PATH_MODULES = (
    "mgproto_tpu_torch.data", "mgproto_tpu_torch.data.folder", "mgproto_tpu_torch.data.loader",
    "mgproto_tpu_torch.data.transforms", "mgproto_tpu_torch.native",
    "mgproto_tpu_torch.ops.augment", "mgproto_tpu_torch.ops.prng",
    "mgproto_tpu_torch.utils.images", "mgproto_tpu_torch.resilience.retry",
)
# the interpretability plane's modules, walked and imported the same way
INTERPRET_MODULES = (
    "mgproto_tpu_torch.data.cub_parts", "mgproto_tpu_torch.utils.vis",
    "mgproto_tpu_torch.engine.interpretability", "mgproto_tpu_torch.cli.interpret",
)
# the precision policy and the modules of the training options
OPTION_MODULES = ("mgproto_tpu_torch.perf", "mgproto_tpu_torch.perf.precision",
                  "mgproto_tpu_torch.core.losses", "mgproto_tpu_torch.models.resnet",
                  "mgproto_tpu_torch.utils.checkpoint")
# the export and serving plane's modules
SERVE_MODULES = ("mgproto_tpu_torch.engine.export", "mgproto_tpu_torch.serving.batcher",
                 "mgproto_tpu_torch.serving.health", "mgproto_tpu_torch.serving.replica",
                 "mgproto_tpu_torch.serving.swap", "mgproto_tpu_torch.serving.frontend",
                 "mgproto_tpu_torch.cli.export", "mgproto_tpu_torch.cli.serve")
# the online plane and the flight recorder (obs/)
ONLINE_MODULES = ("mgproto_tpu_torch.online", "mgproto_tpu_torch.online.capture",
                  "mgproto_tpu_torch.online.classes", "mgproto_tpu_torch.online.consolidate",
                  "mgproto_tpu_torch.online.drift", "mgproto_tpu_torch.online.drill",
                  "mgproto_tpu_torch.online.metrics", "mgproto_tpu_torch.online.republish",
                  "mgproto_tpu_torch.obs", "mgproto_tpu_torch.obs.flightrec",
                  "mgproto_tpu_torch.cli.online")
TRUST_MODULES = ("mgproto_tpu_torch.ops.corrupt", "mgproto_tpu_torch.trust",
                 "mgproto_tpu_torch.trust.auroc", "mgproto_tpu_torch.trust.matrix",
                 "mgproto_tpu_torch.trust.metrics", "mgproto_tpu_torch.cli.trust",
                 "mgproto_tpu_torch.cli.telemetry")
# the distributed runtime
PARALLEL_MODULES = ("mgproto_tpu_torch.parallel", "mgproto_tpu_torch.parallel.mesh",
                    "mgproto_tpu_torch.parallel.collectives",
                    "mgproto_tpu_torch.parallel.sharding",
                    "mgproto_tpu_torch.parallel.multihost",
                    "mgproto_tpu_torch.parallel.trainer",
                    "mgproto_tpu_torch.resilience.metrics", "mgproto_tpu_torch.resilience.retry",
                    "mgproto_tpu_torch.trust.interp_sharded")
# the observatory (obs/) and its report main
OBS_MODULES = ("mgproto_tpu_torch.obs.profiler", "mgproto_tpu_torch.obs.stall",
               "mgproto_tpu_torch.obs.opcount", "mgproto_tpu_torch.obs.reqtrace",
               "mgproto_tpu_torch.cli.trace_report", "mgproto_tpu_torch.utils.log")
# a trace's attribution, the stall gate and request tracing need no torch
TORCHLESS_OBS_MODULES = ("mgproto_tpu_torch.obs.profiler", "mgproto_tpu_torch.obs.stall",
                         "mgproto_tpu_torch.obs.reqtrace", "mgproto_tpu_torch.cli.trace_report",
                         "mgproto_tpu_torch.serving.response")
# the trust check re-derives a report's verdicts on a host without torch
TORCHLESS_TRUST_MODULES = ("mgproto_tpu_torch.trust.auroc", "mgproto_tpu_torch.trust.metrics",
                           "mgproto_tpu_torch.cli.telemetry")
# the online modules a serving host without the model stack imports: the
# engine's capture tap, the drift monitor, the republisher, the recorder
TORCHLESS_ONLINE_MODULES = ("mgproto_tpu_torch.online.capture", "mgproto_tpu_torch.online.drift",
                            "mgproto_tpu_torch.online.metrics",
                            "mgproto_tpu_torch.online.republish",
                            "mgproto_tpu_torch.obs.flightrec")
# what a spawn loader worker unpickles, the CUB part tables and the precision
# policy (a Config validates its dtype through it): they must import without
# torch (and without PIL, which only opening an image needs)
WORKER_MODULES = ("mgproto_tpu_torch.data.loader", "mgproto_tpu_torch.data.folder",
                  "mgproto_tpu_torch.data.transforms", "mgproto_tpu_torch.native",
                  "mgproto_tpu_torch.data.cub_parts", "mgproto_tpu_torch.perf.precision",
                  "mgproto_tpu_torch.config", "mgproto_tpu_torch.resilience.retry")


def test_the_online_taps_import_without_torch():
    code = f"""
import importlib, sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None
for m in {TORCHLESS_ONLINE_MODULES!r}:
    importlib.import_module(m)
print(sorted(m for m in sys.modules if m.split(".")[0] == "torch" and sys.modules[m]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_trace_attribution_runs_without_torch(tmp_path):
    """cli.trace_report's trace mode and check --stall-report on a host
    without torch."""
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void bn_epilogue_kernel<F32x4>()", "pid": 0,
         "tid": 7, "ts": 0, "dur": 10}]}))
    report = str(tmp_path / "r.json")
    code = f"""
import contextlib, importlib, io, sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None
for m in {TORCHLESS_OBS_MODULES!r}:
    importlib.import_module(m)
from mgproto_tpu_torch.cli import telemetry, trace_report
with contextlib.redirect_stdout(io.StringIO()):
    trace_report.main(["--trace", {str(trace)!r}, "--out", {report!r}])
    code = telemetry.check_main(["--stall-report", {report!r}])
print(code, sorted(m for m in sys.modules if m.split(".")[0] == "torch" and sys.modules[m]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []"


def test_the_trust_check_runs_without_torch():
    baseline = os.path.join(REPO, "evidence", "trust_baseline.json")
    code = f"""
import contextlib, importlib, io, sys
for name in ("torch",) + {FORBIDDEN!r}:
    sys.modules[name] = None
for m in {TORCHLESS_TRUST_MODULES!r}:
    importlib.import_module(m)
from mgproto_tpu_torch.cli.telemetry import check_main
with contextlib.redirect_stdout(io.StringIO()):
    code = check_main(["--trust", {baseline!r}])
print(code, sorted(m for m in sys.modules if m.split(".")[0] == "torch" and sys.modules[m]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []"


def test_worker_modules_import_without_torch_or_pil():
    code = f"""
import importlib, sys
for name in ("torch", "PIL") + {FORBIDDEN!r}:
    sys.modules[name] = None
for m in {WORKER_MODULES!r}:
    importlib.import_module(m)
from mgproto_tpu_torch.data import Cub2011Eval, DataLoader, ImageFolder, transforms
transforms.TrainTransform(32, device_augment=True)
from mgproto_tpu_torch.config import ModelConfig
ModelConfig(compute_dtype="bfloat16")
print(sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "PIL") and sys.modules[m]))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_mgproto(cfg.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_gmm(cfg.model, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    model, gmm = build_mgproto(cfg.model, device="cpu", seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(model, gmm, cfg)
    assert Evaluator(model, gmm, cfg, device="cpu").device.type == "cpu"


def test_training_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(cfg, torch.Generator())
    trainer = Trainer(cfg, steps_per_epoch=1, device="cpu")
    assert trainer.init_state(0).gmm.means.device.type == "cpu"


def test_interpret_entry_point_needs_cuda_or_an_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from mgproto_tpu_torch.cli.interpret import run_interpret

    cfg = tiny_test_config().replace(model_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_interpret(cfg, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_interpret(cfg, str(tmp_path), device="cuda")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run_interpret(cfg, str(tmp_path), device="cpu")


def test_serving_entry_points_need_cuda_or_an_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from mgproto_tpu_torch.cli import export as cli_export
    from mgproto_tpu_torch.cli import serve as cli_serve
    from mgproto_tpu_torch.engine import export
    from mgproto_tpu_torch.serving.calibration import gmm_fingerprint
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = tiny_test_config().replace(model_dir=str(tmp_path))
    model, gmm = build_mgproto(cfg.model, device="cpu", seed=0)
    path = str(tmp_path / "a.mgproto")
    export.save_artifact(path, model, gmm, export.artifact_meta(cfg, None, gmm_fingerprint(gmm)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.load_artifact(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine.from_artifact(path, allow_uncalibrated=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_serve.main(["--artifact", path, "--allow-uncalibrated"])
    assert export.load_artifact(path, device="cpu").evaluator.device.type == "cpu"
    save_checkpoint(str(tmp_path), Trainer(cfg, 1, device="cpu").init_state(0), "0nopush0.5000")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_export.main(["--arch", "tiny", "--img_size", "32", "--num_classes", "4",
                         "--protos_per_class", "3", "--proto_dim", "8", "--aux_emb_sz", "8",
                         "--mine_level", "4", "--mem_sz", "16", "--no_pretrained",
                         "--model_dir", str(tmp_path), "--out", str(tmp_path / "o.mgproto")])
