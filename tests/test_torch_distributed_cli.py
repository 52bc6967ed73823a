"""`cli.train --distributed` and `cli.evaluate --distributed` on two CPU
ranks (gloo), against one process on the same data.

Each rank is a process of the main with the torch launcher's environment
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK), as `torchrun
--nproc_per_node 2` sets it, at --batch_size 3 (a global batch of 6); the
one-process run takes --batch_size 6 on the same JPEG tree. One epoch: the
train steps, the test pass with an OoD set, the push (rendered) and the
prune, at mesh (2, 1) and (1, 2) (the class slabs through the push, the
test pass and the checkpoints). The ranks are joined within a wall limit
of their own and killed past it.

Tolerances: the final (`prune`) checkpoints' parameters, means, priors and
bank features rtol 2e-5, atol 1e-5 (tests/test_torch_parallel.py's: the
same arithmetic summed in another order across the ranks); the bank's
lengths and cursors, the pushed prototypes' provenance and the test
accuracy exact.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _torch_jax_states import write_jpeg_tree
from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.utils import checkpoint as tck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL_S = 120
FLAGS = [
    "--dataset", "CUB", "--arch", "tiny", "--num_classes", "4", "--protos_per_class", "3",
    "--proto_dim", "8", "--aux_emb_sz", "8", "--mine_level", "4", "--mem_sz", "16",
    "--no_pretrained", "--num_workers", "0", "--device", "cpu", "--img_size", "32",
]
SCHEDULE = ["--epochs", "1", "--mine_start", "0", "--gmm_start", "0", "--push_start", "0",
            "--push_every", "1", "--prune_top_m", "2", "--no_preempt_handlers"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(module, flags, ranks):
    """Start `python -m module flags` as `ranks` processes (the launcher's
    environment set when ranks > 1, with --distributed)."""
    port = _free_port()
    procs = []
    for r in range(ranks):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        argv = list(flags)
        if ranks > 1:
            env.update(RANK=str(r), WORLD_SIZE=str(ranks), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            argv.append("--distributed")
        procs.append(subprocess.Popen([sys.executable, "-m", module] + argv, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    return procs


def _join(procs, deadline):
    """Each process's stdout; past `deadline` every one is killed. Fails
    with the stderr of a rank that failed."""
    outs, errors = [], []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            errors.append(f"rank {r}: killed at the wall limit\n{err[-3000:]}")
        else:
            if p.returncode:
                errors.append(f"rank {r}: exit {p.returncode}\n{err[-3000:]}")
        outs.append(out)
    for p in procs:
        p.wait(timeout=10)
    assert not errors, "\n".join(errors)
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    tree = write_jpeg_tree(str(root / "imgs"), 4, 5, seed=0)
    ood = write_jpeg_tree(str(root / "ood"), 2, 3, seed=1)
    data = ["--train_dir", tree, "--test_dir", tree, "--push_dir", tree, "--ood_dir", ood]
    deadline = time.monotonic() + WALL_S
    runs = {name: (ranks, FLAGS + data + extra + ["--model_dir", str(root / name)])
            for name, ranks, extra in (("one", 1, ["--batch_size", "6"]),
                                       ("2x1", 2, ["--batch_size", "3"]),
                                       ("1x2", 2, ["--batch_size", "3", "--mesh_model", "2"]))}
    # each run's train, then its evaluation; the one-process run beside
    # the (2, 1) ranks, then the (1, 2) ranks (at most three processes)
    printed = {}
    for group in (("one", "2x1"), ("1x2",)):
        trains = {n: _start("mgproto_tpu_torch.cli.train", runs[n][1] + SCHEDULE, runs[n][0])
                  for n in group}
        for procs in trains.values():
            _join(procs, deadline)
        evals = {n: _start("mgproto_tpu_torch.cli.evaluate", runs[n][1], runs[n][0])
                 for n in group}
        printed.update({n: _join(procs, deadline) for n, procs in evals.items()})
    return {n: (str(root / n), printed[n]) for n in runs}


def _restore(path):
    tr = Trainer(tiny_test_config(), 1, device="cpu")
    return tr, tck.restore_checkpoint(path, tr.init_state(0, for_restore=True))


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_two_ranks_train_an_epoch_like_one_process(runs, mesh):
    """Both ranks exit 0; rank 0 writes every stage checkpoint, the
    provenance and the pictures, rank 1 its host-tagged log and metrics;
    the prune checkpoint restores in one process and equals the
    one-process run's."""
    one_dir, _ = runs["one"]
    model_dir, _ = runs[mesh]
    stages = [c[1] for c in tck.list_checkpoints(model_dir)]
    assert stages == [c[1] for c in tck.list_checkpoints(one_dir)] == ["nopush", "push", "prune"]
    for name in ("train.log", "metrics.jsonl", "train.log.h1", "metrics.jsonl.h1",
                 "push_provenance.json"):
        assert os.path.isfile(os.path.join(model_dir, name)), name
    assert not os.path.exists(os.path.join(model_dir, "push_provenance.json.h1"))
    assert os.listdir(os.path.join(model_dir, "img", "epoch-0"))
    log1 = open(os.path.join(model_dir, "train.log.h1")).read()
    assert "rank: 1 of 2" in log1 and "training done" in log1
    with open(os.path.join(model_dir, "push_provenance.json")) as f:
        got = json.load(f)
    with open(os.path.join(one_dir, "push_provenance.json")) as f:
        want = json.load(f)
    assert got["image_id"] == want["image_id"] and got["spatial_idx"] == want["spatial_idx"]

    _, a = _restore(tck.list_checkpoints(model_dir)[-1][3])
    _, b = _restore(tck.list_checkpoints(one_dir)[-1][3])
    assert a.step == b.step and a.joint_updates == b.joint_updates
    for p, q in zip(Trainer.params(a), Trainer.params(b)):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=2e-5, atol=1e-5)
    for x, y in zip(a.gmm[:3], b.gmm[:3]):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=2e-5, atol=1e-5)
    assert torch.equal(a.gmm.keep, b.gmm.keep)
    for f in ("length", "cursor", "updated"):
        assert torch.equal(getattr(a.memory, f), getattr(b.memory, f)), f
    np.testing.assert_allclose(a.memory.feats.numpy(), b.memory.feats.numpy(), atol=1e-5)
    rows = [json.loads(ln) for ln in open(os.path.join(model_dir, "metrics.jsonl"))]
    one_rows = [json.loads(ln) for ln in open(os.path.join(one_dir, "metrics.jsonl"))]
    assert rows[-1]["stage"] == "prune" and rows[-1]["acc"] == one_rows[-1]["acc"]


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_evaluate_distributed_restores_and_rank_zero_prints(runs, mesh):
    """`cli.evaluate --distributed` restores the ranks' prune checkpoint on
    each rank; rank 0 prints the JSON line, with the accuracy the one-
    process evaluation of the one-process run prints; rank 1 prints
    nothing."""
    _, printed = runs[mesh]
    _, one_printed = runs["one"]
    lines = [json.loads(ln) for ln in printed[0].splitlines() if ln.startswith("{")]
    one = [json.loads(ln) for ln in one_printed[0].splitlines() if ln.startswith("{")][-1]
    assert lines and not printed[1].strip()
    assert lines[-1]["accuracy"] == one["accuracy"]
    assert lines[-1]["checkpoint"].endswith(os.path.basename(one["checkpoint"]))
    for key in ("ood_thresh", "FPR95_1", "AUROC_1"):
        np.testing.assert_allclose(lines[-1][key], one[key], rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("flag", [["--distributed"], ["--mesh_model", "2"]],
                         ids=["distributed", "mesh_model"])
@pytest.mark.parametrize("main,argv", [("export", ["--out", "m.mgproto"]), ("serve", []),
                                       ("trust", ["matrix", "--synthetic"])],
                         ids=["export", "serve", "trust"])
def test_single_process_mains_refuse_the_distributed_flags(main, argv, flag):
    """The mains that run one process in both packages (JAX's parse these
    flags but never join a group) refuse --distributed and the mesh flags
    by design, before anything loads; cli.train, cli.evaluate,
    cli.interpret and cli.trust interp take them."""
    import importlib

    from mgproto_tpu_torch.cli.common import NotPortedError

    mod = importlib.import_module(f"mgproto_tpu_torch.cli.{main}")
    with pytest.raises(NotPortedError, match="by design: this main runs one process"):
        mod.main(argv + flag + ["--device", "cpu"])

