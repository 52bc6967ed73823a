"""The port's sharded interpretability metrics (mgproto_tpu_torch/trust/
interp_sharded.py) and `cli.trust interp` against the JAX package's
`interp_metrics_sharded`, run live on conftest's virtual CPU devices with
the same weights (a tiny JAX state trained three steps, carried across by
models/convert.py) and the same noise, on the CPU.

The CUB-layout tree is tests/test_torch_interpretability.py's wide one (4
classes x 8 images, half of them test images, CUB's 15 parts), read in
global batches of 4 that split over two ranks. The port's ranks are gloo
processes: at mesh (2, 1) tests/_torch_parallel_worker.py (each rank its
rows against the whole mixture), at (1, 2) `cli.trust interp --distributed
--mesh_model 2` (each rank scores its class slab, one sum over the model
group assembles the maps) and `cli.interpret --distributed --mesh_model
2` (the interpretability main's own line and CSV); all are joined within
their own wall limit.

Tolerances: the port's sharded metrics equal its one-process metrics on
the same batches exactly (the CLI's line and CSV too); against JAX's sharded metrics the rule of
tests/test_torch_interpretability.py: equal, unless a map's peak or a
prototype's top-K order differs between the packages' collections (named;
each such prototype may move a metric by its weight, 100 / prototypes).
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import pytest

from mgproto_tpu.data import Cub2011Eval as JaxCub2011Eval
from mgproto_tpu.data import DataLoader as JaxDataLoader
from mgproto_tpu.data import ood_transform as jax_ood_transform
from mgproto_tpu.data.cub_parts import CubParts as JaxCubParts
from mgproto_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from mgproto_tpu.parallel import make_mesh as jax_make_mesh
from mgproto_tpu.trust import interp_sharded as jis
from mgproto_tpu_torch.cli import interpret as tcli
from mgproto_tpu_torch.cli import trust as ttrust_cli
from mgproto_tpu_torch.config import DataConfig
from mgproto_tpu_torch.data.cub_parts import CubParts
from mgproto_tpu_torch.parallel.trainer import ShardedTrainer
from mgproto_tpu_torch.trust import interp_sharded as tis
from mgproto_tpu_torch.utils import checkpoint as tck
from test_torch_interpretability import CUB_PARTS, IMG, _assert_metric, _states, _write_layout
from test_torch_parallel import join_ranks, start_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
HALF, PURITY_HALF, TOP_K = 12, 8, 2
C = 4
WALL_S = 120
KEYS = ("consistency", "stability", "purity", "purity_std")
INTERPRET = ["--half_size", str(HALF), "--purity_half_size", str(PURITY_HALF),
             "--purity_top_k", str(TOP_K)]
TINY = ["--dataset", "CUB", "--arch", "tiny", "--num_classes", "4", "--protos_per_class", "3",
        "--proto_dim", "8", "--aux_emb_sz", "8", "--mine_level", "4", "--mem_sz", "16",
        "--no_pretrained", "--num_workers", "0", "--device", "cpu", "--img_size", str(IMG),
        "--batch_size", str(BATCH)]


def _jax_metrics(root, mesh):
    jtrainer, jstate, _, _ = _states()
    devices = jax.devices()[:mesh[0] * mesh[1]]
    sh = JaxShardedTrainer(jtrainer.cfg, 4, mesh=jax_make_mesh(*mesh, devices=devices))
    loader = lambda: iter(JaxDataLoader(  # noqa: E731
        JaxCub2011Eval(root, train=False, transform=jax_ood_transform(IMG)), BATCH,
        num_workers=0))
    return jis.interp_metrics_sharded(sh, sh.prepare(jstate), loader, JaxCubParts(root), C,
                                      consistency_half_size=HALF, purity_half_size=PURITY_HALF,
                                      top_k=TOP_K)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("interp"))
    cub = _write_layout(os.path.join(root, "cub"), C, 8, CUB_PARTS, 1,
                        [(64, 48), (50, 70), (90, 60)], train_every=2)
    _, _, ptrainer, pstate = _states()
    model_dir = os.path.join(root, "run")
    ckpt = tck.save_checkpoint(model_dir, pstate, "0nopush0.5000")
    deadline = time.monotonic() + WALL_S
    out21 = os.path.join(root, "2x1")
    procs = start_ranks(root, (2, 1), [{"kind": "interp", "ckpt": ckpt, "cub": cub, "out": out21,
                                        "batch": BATCH, "half_size": HALF,
                                        "purity_half_size": PURITY_HALF, "top_k": TOP_K}], "")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rec12 = os.path.join(root, "interp_1x2.json")
    csvs = [os.path.join(root, f"interpret_rank{r}.csv") for r in range(2)]
    cli, interpret = [], []
    for r in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1", RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        cli.append(subprocess.Popen(
            [sys.executable, "-m", "mgproto_tpu_torch.cli.trust", "interp"] + TINY
            + ["--distributed", "--mesh_model", "2", "--cub_root", cub, "--model_dir",
               model_dir, "--half_size", str(HALF), "--purity_half_size", str(PURITY_HALF),
               "--top_k", str(TOP_K), "--out", rec12],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for r in range(2):  # each rank names a CSV of its own: only rank 0's may appear
        env = dict(os.environ, OMP_NUM_THREADS="1", RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        interpret.append(subprocess.Popen(
            [sys.executable, "-m", "mgproto_tpu_torch.cli.interpret"] + TINY
            + ["--distributed", "--mesh_model", "2", "--cub_root", cub, "--model_dir",
               model_dir] + INTERPRET + ["--export_csv", csvs[r]],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    jax_out = {m: _jax_metrics(cub, m) for m in ((2, 1), (1, 2))}
    # the port in one process, at the ranks' global batches
    cfg = ptrainer.cfg.replace(data=DataConfig(test_batch_size=BATCH, num_workers=0))
    one = tis.interp_metrics_sharded(
        ShardedTrainer(cfg, 1, device="cpu"), pstate,
        lambda: iter(tcli.build_eval_loader(cfg, cub)), CubParts(cub), C,
        consistency_half_size=HALF, purity_half_size=PURITY_HALF, top_k=TOP_K)
    join_ranks(procs, deadline)
    join_ranks(cli, deadline)
    printed = join_ranks(interpret, deadline)
    with open(rec12) as f:
        port12 = json.load(f)
    port21 = [json.load(open(os.path.join(out21, f"rank{r}.json"))) for r in (0, 1)]
    return {"cub": cub, "jax": jax_out, "one": one, "port": {(2, 1): port21[0], (1, 2): port12},
            "rank1": port21[1], "record": rec12, "model_dir": model_dir,
            "interpret": printed, "csvs": csvs}


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_two_ranks_equal_one_process_and_jax_sharded(runs, mesh):
    got, one, want = runs["port"][mesh], runs["one"], runs["jax"][mesh]
    assert got["sharded"] is True and want["sharded"] is True and one["sharded"] is False
    assert got["num_images"] == one["num_images"] == want["num_images"] == 16
    for k in KEYS:
        assert got[k] == one[k], (k, got[k], one[k])
        _assert_metric(got[k], want[k], runs["cub"], k)
    assert runs["rank1"] == runs["port"][(2, 1)]  # every rank holds the metrics


def test_cli_trust_interp_record_merges_into_report(runs, tmp_path, capsys):
    """The record is JAX's `trust_interp` shape, and `report --interp`
    merges it (gates re-derived), as the JAX CLI does."""
    from test_torch_trust import BASELINE

    with open(runs["record"]) as f:
        record = json.load(f)
    assert record["trust_interp"] is True
    assert os.path.basename(record["checkpoint"]) == "0nopush0.5000"
    assert set(KEYS) <= set(record) and record["num_images"] == 16
    out = tmp_path / "merged.json"
    code = ttrust_cli.main(["report", "--matrix", BASELINE, "--interp", runs["record"],
                            "--out", str(out)])
    merged = json.loads(out.read_text())
    assert merged["interp"] == {k: v for k, v in record.items() if k != "trust_interp"}
    assert code in (0, 1) and "interp: " in capsys.readouterr().out


def test_cli_trust_interp_in_one_process(runs, tmp_path, capsys):
    """World 1, no --distributed: the one-process metrics."""
    out = tmp_path / "interp.json"
    code = ttrust_cli.main(["interp"] + TINY + [
        "--cub_root", runs["cub"], "--model_dir", runs["model_dir"], "--half_size", str(HALF),
        "--purity_half_size", str(PURITY_HALF), "--top_k", str(TOP_K), "--out", str(out)])
    record = json.loads(out.read_text())
    assert code == 0 and record["sharded"] is False
    for k in KEYS:
        assert record[k] == runs["one"][k], k
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record


def test_cli_interpret_distributed_prints_the_one_process_line(runs, tmp_path, capsys):
    """`cli.interpret --distributed --mesh_model 2` on two gloo ranks (the
    parameters cut over the model axis, each rank scoring its class slab):
    rank 0 prints the one-process main's lines with the same metrics
    exactly and writes the same CSV; rank 1 prints nothing and writes no
    CSV, though it was given a path of its own."""
    one_csv = str(tmp_path / "one.csv")
    tcli.main(TINY + ["--cub_root", runs["cub"], "--model_dir", runs["model_dir"]] + INTERPRET
              + ["--export_csv", one_csv])
    one = capsys.readouterr().out.strip().splitlines()
    rank0, rank1 = runs["interpret"]
    got = rank0.strip().splitlines()
    assert not rank1.strip()
    assert got[0] == one[0] and got[0].startswith("loaded ")
    want, line = json.loads(one[-1]), json.loads(got[-1])
    assert line.pop("csv") == runs["csvs"][0] and want.pop("csv") == one_csv
    assert line == want and set(KEYS) <= set(line) and line["csv_rows"] > 0
    with open(runs["csvs"][0]) as a, open(one_csv) as b:
        assert a.read() == b.read()
    assert not os.path.exists(runs["csvs"][1])
