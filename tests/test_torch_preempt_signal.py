"""A real SIGTERM and SIGINT sent to a training run's process group while
its spawn loader workers start (mgproto_tpu_torch/data/loader.py,
`cli/train.py::main`), on the CPU.

  * The loader alone, in a session of its own: the group signals sent the
    moment the pool has forked its workers (all still in the group) reach
    the main process's handlers, and no worker: the workers that load the
    first batch are the ones forked, none replaced. Closed while the group
    signal is still pending in starting workers, the pool ends them all.
  * The train main (`--worker_backend process`): signalled while a worker
    is still in the main's process group, it saves a `preempt`
    checkpoint with its batch position and PREEMPTED.json, exits 0 and
    leaves no worker behind; `--resume auto` then finishes the run.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

from _torch_jax_states import write_jpeg_tree
from mgproto_tpu_torch.cli import train as ttrain
from mgproto_tpu_torch.resilience import preemption
from mgproto_tpu_torch.utils import checkpoint as tck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOADER_SCRIPT = textwrap.dedent("""
    import json, os, signal, sys, time
    import numpy as np
    from mgproto_tpu_torch.data.loader import DataLoader

    class Rows:
        def __len__(self):
            return 8

        def load(self, index, rng):
            return np.full((4, 4, 3), index, np.uint8), index % 2, index

    if __name__ == "__main__":
        got = []
        signal.signal(signal.SIGTERM, lambda *a: got.append("SIGTERM"))
        signal.signal(signal.SIGINT, lambda *a: got.append("SIGINT"))
        loader = DataLoader(Rows(), batch_size=4, num_workers=2, worker_backend="process")
        pool = loader._ensure_pool()
        forked = list(pool._pool)
        out = {"in_group": [os.getpgid(p.pid) == os.getpgid(0) for p in forked]}
        os.killpg(0, signal.SIGTERM)
        os.killpg(0, signal.SIGINT)
        if sys.argv[1] == "load":
            it = iter(loader)
            out["ids"] = next(it)[2].tolist()
            it.close()
            out["exitcodes_after_load"] = [p.exitcode for p in forked]
            out["same_workers"] = [p.pid for p in pool._pool] == [p.pid for p in forked]
        t0 = time.perf_counter()
        loader.close()
        out["close_s"] = time.perf_counter() - t0
        out["alive_after_close"] = [p.is_alive() for p in forked]
        out["got"] = got
        print(json.dumps(out))
""")


def _run_loader_script(tmp_path, mode):
    path = tmp_path / "loader_signal.py"
    path.write_text(LOADER_SCRIPT)
    r = subprocess.run([sys.executable, str(path), mode], cwd=REPO, capture_output=True,
                       text=True, timeout=120, start_new_session=True,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_group_signals_at_pool_start_reach_the_main_process_only(tmp_path):
    out = _run_loader_script(tmp_path, "load")
    assert out["in_group"] == [True, True]  # signalled before any worker left the group
    assert sorted(out["got"]) == ["SIGINT", "SIGTERM"]
    assert out["ids"] == [0, 1, 2, 3]
    assert out["exitcodes_after_load"] == [None, None] and out["same_workers"]
    assert out["alive_after_close"] == [False, False]


def test_a_pool_closed_while_a_group_signal_is_pending_ends_its_workers(tmp_path):
    out = _run_loader_script(tmp_path, "close")
    assert out["in_group"] == [True, True]
    assert sorted(out["got"]) == ["SIGINT", "SIGTERM"]
    assert out["alive_after_close"] == [False, False] and out["close_s"] < 60


def _children(pid):
    """[(child pid, its process group, its command line)] from /proc."""
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            stat = open(f"/proc/{name}/stat").read().rsplit(")", 1)[1].split()
            cmd = open(f"/proc/{name}/cmdline", "rb").read()
        except OSError:
            continue
        if int(stat[1]) == pid:
            found.append((int(name), int(stat[2]), cmd))
    return found


def _alive(pid):
    try:
        state = open(f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return False
    return state != "Z"


def test_train_main_preempted_while_its_workers_start(tmp_path):
    """SIGTERM to the group once the first spawn worker exists and is still
    in the main's group: exit 0, a `preempt` checkpoint at batch >= 1 with
    its marker, no worker left; the resume ends at the prune."""
    imgs = write_jpeg_tree(str(tmp_path / "imgs"), 4, 5, seed=0)
    run_dir = str(tmp_path / "run")
    flags = ["--arch", "tiny", "--num_classes", "4", "--protos_per_class", "3", "--proto_dim", "8",
             "--aux_emb_sz", "8", "--mine_level", "4", "--mem_sz", "16", "--no_pretrained",
             "--batch_size", "6", "--device", "cpu", "--img_size", "32", "--train_dir", imgs,
             "--test_dir", imgs, "--push_dir", imgs, "--model_dir", run_dir, "--epochs", "1",
             "--mine_start", "0", "--gmm_start", "0", "--push_start", "100"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "mgproto_tpu_torch.cli.train", *flags, "--num_workers", "2",
         "--worker_backend", "process"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True, env=dict(os.environ, PYTHONPATH=REPO))
    workers, starting = set(), []
    try:
        for line in proc.stdout:
            if line.startswith("update GMM:"):  # logged right before the first step
                break
        deadline = time.time() + 60
        while not starting and time.time() < deadline:
            kids = [(p, g) for p, g, cmd in _children(proc.pid) if b"spawn_main" in cmd]
            starting = [p for p, g in kids if g == proc.pid]
            time.sleep(0.01)
        assert starting, "no spawn worker was seen in the main's process group"
        os.killpg(proc.pid, signal.SIGTERM)
        while proc.poll() is None:
            workers |= {p for p, _, cmd in _children(proc.pid) if b"spawn_main" in cmd}
            time.sleep(0.05)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    marker = preemption.read_marker(run_dir)
    ckpts = tck.list_checkpoints(run_dir)
    assert marker is not None and ckpts[-1][1] == "preempt"
    meta = tck.load_metadata(ckpts[-1][3])
    assert meta["reason"] == "signal SIGTERM" and meta["batch_in_epoch"] >= 1
    assert marker["batch_in_epoch"] == meta["batch_in_epoch"]
    deadline = time.time() + 20
    while any(_alive(p) for p in workers | set(starting)) and time.time() < deadline:
        time.sleep(0.1)
    assert not [p for p in workers | set(starting) if _alive(p)]

    ttrain.main(flags + ["--num_workers", "0", "--resume", "auto", "--no_preempt_handlers"])
    assert preemption.read_marker(run_dir) is None
    assert tck.list_checkpoints(run_dir)[-1][1] == "prune"
