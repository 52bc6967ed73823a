"""mgproto_tpu_torch stands alone: no JAX, nothing of mgproto_tpu, neither
cv2 nor matplotlib (neither is known to exist beside the card), and no
silent CPU fallback at its entry points."""

import ast
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
missing = [m for m in {INPUT_PATH_MODULES + INTERPRET_MODULES + OPTION_MODULES!r}
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
    "mgproto_tpu_torch.utils.images", "mgproto_tpu_torch.utils.retry",
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
# what a spawn loader worker unpickles, the CUB part tables and the precision
# policy (a Config validates its dtype through it): they must import without
# torch (and without PIL, which only opening an image needs)
WORKER_MODULES = ("mgproto_tpu_torch.data.loader", "mgproto_tpu_torch.data.folder",
                  "mgproto_tpu_torch.data.transforms", "mgproto_tpu_torch.native",
                  "mgproto_tpu_torch.data.cub_parts", "mgproto_tpu_torch.perf.precision",
                  "mgproto_tpu_torch.config")


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
