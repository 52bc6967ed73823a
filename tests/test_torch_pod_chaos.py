"""The pod drills of the port on two CPU ranks (gloo): `cli.train
--distributed --ckpt_format sharded --barrier_timeout_s 10` with a rank
killed hard (MGPROTO_CHAOS_KILL_HOST_AT) or wedged
(MGPROTO_CHAOS_WEDGE_HOST_AT) mid-run, against the uninterrupted run
(counterpart of tests/test_pod_chaos.py and tests/test_multiprocess.py's
host kill and wedge drills).

Each rank is a process of the main with the torch launcher's environment
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), a tiny trunk at 32 px on a
4-class JPEG tree (a global batch of 6, 4 steps an epoch, 2 epochs, no
push). The knob is set in rank 1's environment only.

  * kill at global step 5 (epoch 1): rank 1 exits 86; rank 0 meets the loss
    in its next collective (gloo raises at once), holds the failure
    agreement's barrier for the timeout plus the process group's (the
    same 10 s) and exits 75 with PEER_LOST.json
    naming rank 1 and its flight recorder dumped as
    `telemetry/flightrec_peer_lost_000.jsonl` (rank 0's name has no
    suffix, as in JAX); only committed
    checkpoints are listed (epoch 0's); both ranks relaunched with
    `--resume auto` (a new barrier session) end at the uninterrupted run's
    state digest, bit for bit.
  * wedge at global step 2: rank 0's collective times out (the process
    group's timeout is the barrier timeout), the agreement's barrier times
    out again, and rank 0 exits 75 naming rank 1; the hung rank is killed.
  * an ordinary error on rank 1 (a ValueError raised in its third train
    step): rank 1 holds the agreement's barrier, rank 0 meets it there once
    its collective times out, so both raise what they met: no rank exits
    75 and no PEER_LOST.json is written.

Every rank is joined within a wall limit of its own and killed past it.
No tolerance: the digests are compared exactly.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

from _torch_jax_states import write_jpeg_tree
from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.parallel.multihost import PEER_LOST_EXIT_CODE, PEER_LOST_FILE
from mgproto_tpu_torch.resilience.chaos import HOST_KILL_EXIT_CODE
from mgproto_tpu_torch.utils import checkpoint as tck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL_S = 150
TIMEOUT_S = 10
FLAGS = [
    "--dataset", "CUB", "--arch", "tiny", "--num_classes", "4", "--protos_per_class", "3",
    "--proto_dim", "8", "--aux_emb_sz", "8", "--mine_level", "4", "--mem_sz", "16",
    "--no_pretrained", "--num_workers", "0", "--device", "cpu", "--img_size", "32",
    "--batch_size", "3", "--epochs", "2", "--mine_start", "0", "--gmm_start", "0",
    "--push_start", "99", "--no_preempt_handlers", "--distributed", "--ckpt_format", "sharded",
    "--barrier_timeout_s", str(TIMEOUT_S),
]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# rank 1's main with its third train step raising an ordinary error
RAISE_IN_STEP_3 = """
import sys
from mgproto_tpu_torch.cli import train
from mgproto_tpu_torch.engine.train import Trainer

step, calls = Trainer.train_step, []


def failing(self, *args, **kwargs):
    calls.append(1)
    if len(calls) == 3:
        raise ValueError("a bad batch on rank 1")
    return step(self, *args, **kwargs)


Trainer.train_step = failing
train.main(sys.argv[1:])
"""


def _launch(model_dir, data, extra=(), rank1_env=None, rank1_code=None):
    """Two ranks of `cli.train`; rank 1 gets `rank1_env` besides, and runs
    `rank1_code` (given the flags as its argv) in place of the module."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1", RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        env.pop("MGPROTO_BARRIER_SESSION", None)
        if r == 1 and rank1_env:
            env.update(rank1_env)
        argv = FLAGS + data + ["--model_dir", model_dir] + list(extra)
        main = (["-c", rank1_code] if r == 1 and rank1_code
                else ["-m", "mgproto_tpu_torch.cli.train"])
        procs.append(subprocess.Popen(
            [sys.executable] + main + argv, cwd=REPO, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    return procs


def _wait(procs, deadline, stop_after_first=None):
    """{rank: (exit code, monotonic exit time, stderr)}. With
    `stop_after_first`, once that rank exits the others are killed (a
    wedged peer); past `deadline` every rank is killed."""
    out, t_exit = {}, {}
    while len(t_exit) < len(procs):
        for r, p in enumerate(procs):
            if r not in t_exit and p.poll() is not None:
                t_exit[r] = time.monotonic()
        if stop_after_first is not None and stop_after_first in t_exit:
            for r, p in enumerate(procs):
                if r not in t_exit:
                    p.kill()
                    p.wait(timeout=10)
                    t_exit[r] = time.monotonic()
        if time.monotonic() > deadline:
            for p in procs:
                p.kill()
            pytest.fail("ranks killed at the wall limit: "
                        + " | ".join((p.communicate()[1] or "")[-2000:] for p in procs))
        time.sleep(0.05)
    for r, p in enumerate(procs):
        out[r] = (p.returncode, t_exit[r], p.communicate()[1])
    return out


def _digest(model_dir):
    last = tck.find_latest_checkpoint(model_dir)
    tr = Trainer(tiny_test_config(), 1, device="cpu")
    return last, tck.state_digest(tck.restore_checkpoint(last, tr.init_state(0, True)))


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    root = tmp_path_factory.mktemp("pod")
    tree = write_jpeg_tree(str(root / "imgs"), 4, 6, seed=0)
    data = ["--train_dir", tree, "--test_dir", tree, "--push_dir", tree]
    deadline = time.monotonic() + WALL_S
    dirs = {k: str(root / k) for k in ("clean", "kill", "wedge", "error")}
    # the clean run beside the kill, then the relaunch beside the wedge and
    # the ordinary error
    runs = {
        "clean": _launch(dirs["clean"], data),
        "kill": _launch(dirs["kill"], data, rank1_env={"MGPROTO_CHAOS_KILL_HOST_AT": "5"}),
    }
    done = {"clean": _wait(runs["clean"], deadline), "kill": _wait(runs["kill"], deadline)}
    # read before the relaunch, which removes the last incarnation's marker
    with open(os.path.join(dirs["kill"], PEER_LOST_FILE)) as f:
        marker = json.load(f)
    dump = os.path.join(dirs["kill"], "telemetry", "flightrec_peer_lost_000.jsonl")
    after_kill = {"listed": tck.list_checkpoints(dirs["kill"]),
                  "names": sorted(os.listdir(dirs["kill"])), "marker": marker,
                  "dump": [json.loads(ln) for ln in open(dump)]}
    relaunch = _launch(dirs["kill"], data, extra=["--resume", "auto"])
    wedge = _launch(dirs["wedge"], data, rank1_env={"MGPROTO_CHAOS_WEDGE_HOST_AT": "2"})
    error = _launch(dirs["error"], data, rank1_code=RAISE_IN_STEP_3)
    done["wedge"] = _wait(wedge, deadline, stop_after_first=0)
    done["error"] = _wait(error, deadline)
    done["relaunch"] = _wait(relaunch, deadline)
    return {"dirs": dirs, "done": done, "after_kill": after_kill}


def test_kill_exits_86_and_75_with_the_marker_and_rank_0s_dump(drills):
    done, kill_dir = drills["done"]["kill"], drills["dirs"]["kill"]
    assert done[1][0] == HOST_KILL_EXIT_CODE, done[1][2][-3000:]
    assert done[0][0] == PEER_LOST_EXIT_CODE, done[0][2][-3000:]
    assert "peer lost" in done[0][2]
    # rank 0 ends within the agreement's wait (the barrier timeout plus the
    # process group's) and a margin of its peer's death
    assert done[0][1] - done[1][1] < 2 * TIMEOUT_S + 20
    marker = drills["after_kill"]["marker"]
    assert marker["missing_processes"] == [1] and marker["survivor"] == 0
    assert marker["exit_code"] == PEER_LOST_EXIT_CODE and marker["timeout_s"] == TIMEOUT_S
    lines = drills["after_kill"]["dump"]
    assert not os.path.exists(os.path.join(kill_dir, "telemetry",
                                           "flightrec_peer_lost_000.h1.jsonl"))
    assert lines[0]["reason"] == "peer_lost" and lines[0]["host"] == 0
    assert any(e.get("kind") == "barrier_timeout" and e["host"] == 0 for e in lines[1:])


def test_kill_leaves_only_committed_checkpoints(drills):
    listed = drills["after_kill"]["listed"]
    assert [(c[0], c[1]) for c in listed] == [(0, "nopush")]
    kill_dir = drills["dirs"]["kill"]
    for name in drills["after_kill"]["names"]:
        if tck.parse_checkpoint_name(name):
            path = os.path.join(kill_dir, name)
            assert tck.has_shard_files(path) and tck.is_committed(path), name


def test_relaunch_resumes_to_the_clean_runs_digest(drills):
    done = drills["done"]
    for run in ("clean", "relaunch"):
        for r in (0, 1):
            assert done[run][r][0] == 0, (run, r, done[run][r][2][-3000:])
    assert not os.path.exists(os.path.join(drills["dirs"]["kill"], PEER_LOST_FILE))
    clean_last, clean = _digest(drills["dirs"]["clean"])
    last, digest = _digest(drills["dirs"]["kill"])
    assert os.path.basename(last) == os.path.basename(clean_last)
    assert tck.is_committed(last) and tck.has_shard_files(last)
    assert digest == clean


def test_wedge_exits_75_after_the_timeout(drills):
    done, wedge_dir = drills["done"]["wedge"], drills["dirs"]["wedge"]
    assert done[0][0] == PEER_LOST_EXIT_CODE, done[0][2][-3000:]
    assert done[1][0] != 0  # killed by the test, hung until then
    with open(os.path.join(wedge_dir, PEER_LOST_FILE)) as f:
        marker = json.load(f)
    assert marker["missing_processes"] == [1]
    assert marker["heartbeat_ages_s"]["1"] is None or marker["heartbeat_ages_s"]["1"] >= 0


def test_an_ordinary_error_on_one_rank_is_not_a_peer_loss(drills):
    done, error_dir = drills["done"]["error"], drills["dirs"]["error"]
    assert "ValueError: a bad batch on rank 1" in done[1][2], done[1][2][-3000:]
    for r in (0, 1):
        assert done[r][0] not in (0, PEER_LOST_EXIT_CODE), (r, done[r][2][-3000:])
        assert "peer lost" not in done[r][2]
    assert not os.path.exists(os.path.join(error_dir, PEER_LOST_FILE))
