"""The port's sharded checkpoint protocol, guarded barrier and pod chaos
knobs (mgproto_tpu_torch/utils/checkpoint.py, parallel/multihost.py,
resilience/{chaos,metrics,retry}.py), case by case against
tests/test_sharded_checkpoint.py, on the CPU.

One-process cases save the port's tiny state (a JAX state trained two
steps, carried across by models/convert.py, so the optimizers hold their
moments) with `sharded=True`; the cross-rank cases run two gloo ranks
(tests/_torch_parallel_worker.py, which imports no JAX): a save at mesh
(1, 2), each rank writing its class slab and its slices of the
parameters and moments, restored by two ranks at (2, 1), by four at
(2, 2) and by this process at world 1. The ranks are joined within their
own wall limit and killed past it.

Tolerances: none. Every restore is held bit for bit (`state_digest`, or
each array equal) to the state saved or to the ranks' gathered state; the
JAX package's listings (`is_committed`, `has_shard_files`,
`list_checkpoints`, `apply_retention`) must give the port's answers on the
port's directories exactly.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from _torch_jax_states import port_state, trained_jax_state
from mgproto_tpu.utils import checkpoint as jck
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.obs.flightrec import FlightRecorder, set_recorder
from mgproto_tpu_torch.parallel import multihost
from mgproto_tpu_torch.resilience import chaos
from mgproto_tpu_torch.resilience import metrics as res_metrics
from mgproto_tpu_torch.resilience.chaos import ChaosPlan, ChaosState, set_active
from mgproto_tpu_torch.serving.metrics import MetricRegistry, set_current_registry
from mgproto_tpu_torch.utils import checkpoint as ck
from mgproto_tpu_torch.utils.checkpoint import (
    COMMIT_FILE,
    MANIFEST_FILE,
    TMP_SUFFIX,
    CheckpointIntegrityError,
    apply_retention,
    find_latest_checkpoint,
    has_shard_files,
    is_committed,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
    state_digest,
)
from test_torch_parallel import _full_of, join_ranks, start_ranks

WALL_S = 120


@pytest.fixture(scope="module")
def start():
    """(the port's Trainer, a JAX state trained two steps carried across)."""
    _, jstate = trained_jax_state(steps=2)
    return port_state(jstate)


def _target(tr):
    return tr.init_state(1, for_restore=True)


@pytest.fixture
def registry():
    reg = MetricRegistry()
    prev = set_current_registry(reg)
    yield reg
    set_current_registry(prev)


@pytest.fixture
def failing_saves():
    """Install a chaos state whose first checkpoint save fails."""
    def install(n=1):
        set_active(ChaosState(ChaosPlan(checkpoint_write_failures=n)))
    yield install
    set_active(None)


# ----------------------------------------------------- sharded save/restore
def test_sharded_roundtrip_bit_exact(start, tmp_path):
    tr, st = start
    path = save_checkpoint(str(tmp_path), st, "0nopush0.5000", metadata={"epoch": 0},
                           sharded=True)
    names = set(os.listdir(path))
    assert {COMMIT_FILE, MANIFEST_FILE, "shard_00000.npz", "shard_00000.idx.json"} <= names
    assert has_shard_files(path) and is_committed(path)
    assert state_digest(restore_checkpoint(path, _target(tr))) == state_digest(st)
    with open(os.path.join(path, MANIFEST_FILE)) as f:
        manifest = json.load(f)
    assert manifest["sharded"] is True
    assert manifest["num_hosts"] == manifest["num_devices"] == 1
    assert manifest["step"] == st.step


def test_mid_save_crash_leaves_no_visible_checkpoint(start, tmp_path, registry, failing_saves):
    """The chaos failure fires between the shard writes and COMMIT: the save
    dies in its staging directory, nothing appears at the real name, no
    listing trusts the wreckage, a restore refuses it, and the failed
    attempt is counted."""
    tr, st = start
    failing_saves()
    with pytest.raises(IOError, match="chaos"):
        save_checkpoint(str(tmp_path), st, "1nopush0.6000", retries=0, sharded=True)
    crashed = str(tmp_path / "1nopush0.6000")
    staging = crashed + TMP_SUFFIX
    assert not os.path.isdir(crashed)
    assert has_shard_files(staging) and not is_committed(staging)
    assert find_latest_checkpoint(str(tmp_path)) is None
    assert list_checkpoints(str(tmp_path)) == []
    with pytest.raises(CheckpointIntegrityError, match="COMMIT|uncommitted"):
        restore_checkpoint(staging, _target(tr))
    assert registry.counter(res_metrics.CKPT_WRITE_FAILURES).value() == 1


def test_commit_marker_is_the_publish_point(start, tmp_path):
    tr, st = start
    path = save_checkpoint(str(tmp_path), st, "0nopush0.5000", sharded=True)
    assert find_latest_checkpoint(str(tmp_path)) == path
    os.unlink(os.path.join(path, COMMIT_FILE))
    assert find_latest_checkpoint(str(tmp_path)) is None
    with pytest.raises(CheckpointIntegrityError, match="COMMIT"):
        restore_checkpoint(path, _target(tr))
    os.unlink(os.path.join(path, MANIFEST_FILE))  # a save that died before its manifest
    assert find_latest_checkpoint(str(tmp_path)) is None
    with pytest.raises(CheckpointIntegrityError, match="uncommitted"):
        restore_checkpoint(path, _target(tr))


def test_elastic_restore_counter_on_topology_change(start, tmp_path, registry):
    tr, st = start
    path = save_checkpoint(str(tmp_path), st, "0nopush0.5000", sharded=True)
    mpath = os.path.join(path, MANIFEST_FILE)
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["num_hosts"] = 4  # as if four ranks had saved it
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    rec = FlightRecorder()
    prev = set_recorder(rec)
    try:
        assert state_digest(restore_checkpoint(path, _target(tr))) == state_digest(st)
    finally:
        set_recorder(prev)
    assert registry.counter(res_metrics.ELASTIC_RESTORES).value() == 1
    assert rec.events()[-1]["kind"] == "elastic_restore"


@pytest.mark.parametrize("damage", ["torn", "overlap"])
def test_torn_or_overlapping_chunk_cover_is_refused(start, tmp_path, damage):
    """A shard pair lost after the commit fails the exact-cover check; a
    chunk filed twice fails the overlap check."""
    tr, st = start
    path = save_checkpoint(str(tmp_path), st, "0nopush0.5000", sharded=True)
    idx = os.path.join(path, "shard_00000.idx.json")
    if damage == "torn":
        os.unlink(idx)
        match = "cover"
    else:
        with open(idx) as f:
            side = json.load(f)
        side["chunks"].append(dict(side["chunks"][0]))
        with open(idx, "w") as f:
            json.dump(side, f)
        match = "overlapping"
    with pytest.raises(CheckpointIntegrityError, match=match):
        restore_checkpoint(path, _target(tr))


def test_replicated_escape_hatch_still_roundtrips(start, tmp_path):
    tr, st = start
    rep = save_checkpoint(str(tmp_path), st, "0nopush0.5000", sharded=False)
    assert not has_shard_files(rep)
    assert state_digest(restore_checkpoint(rep, _target(tr))) == state_digest(st)
    sh = save_checkpoint(str(tmp_path), st, "1nopush0.6000", sharded=True)
    assert [c[3] for c in list_checkpoints(str(tmp_path))] == [rep, sh]
    assert find_latest_checkpoint(str(tmp_path)) == sh


# ------------------------------------------------------------------ retention
def test_retention_mixed_committed_uncommitted_legacy(start, tmp_path, failing_saves):
    tr, st = start
    old = save_checkpoint(str(tmp_path), st, "0nopush0.5000", sharded=True)
    newest = save_checkpoint(str(tmp_path), st, "1nopush0.4000", sharded=True)
    legacy = save_checkpoint(str(tmp_path), st, "2nopush0.3000", sharded=False)
    os.unlink(os.path.join(legacy, MANIFEST_FILE))
    failing_saves()
    with pytest.raises(IOError):
        save_checkpoint(str(tmp_path), st, "3nopush0.9000", retries=0, sharded=True)
    orphan = str(tmp_path / "3nopush0.9000") + TMP_SUFFIX
    assert os.path.isdir(orphan)
    removed = apply_retention(str(tmp_path), keep_last=1, keep_best=0)
    assert os.path.isdir(legacy)
    assert not os.path.isdir(orphan) and orphan in removed
    assert not os.path.isdir(old) and not os.path.isdir(newest)
    assert find_latest_checkpoint(str(tmp_path)) is None


def test_same_name_resave_failure_retries_to_commit(start, tmp_path, registry, failing_saves):
    """A resave over a committed checkpoint of the same name whose first
    attempt fails before COMMIT: the old COMMIT cannot fake success, the
    retry republishes, and the checkpoint holds the new state."""
    tr, st = start
    p = save_checkpoint(str(tmp_path), st, "0nopush0.5000", sharded=True)
    second = tr.init_state(7)
    failing_saves()
    p2 = save_checkpoint(str(tmp_path), second, "0nopush0.5000", retries=2, sharded=True)
    assert p2 == p and is_committed(p2)
    assert registry.counter(res_metrics.CKPT_WRITE_FAILURES).value() == 1
    assert registry.counter(res_metrics.RETRIES).value(scope="checkpoint") == 1
    assert state_digest(restore_checkpoint(p2, _target(tr))) == state_digest(second)
    assert not os.path.isdir(p2 + TMP_SUFFIX)


def test_retention_never_deletes_last_committed(start, tmp_path, failing_saves):
    tr, st = start
    committed = save_checkpoint(str(tmp_path), st, "0nopush0.5000", sharded=True)
    failing_saves()
    with pytest.raises(IOError):
        save_checkpoint(str(tmp_path), st, "5nopush0.9999", retries=0, sharded=True)
    apply_retention(str(tmp_path), keep_last=1, keep_best=1)
    assert find_latest_checkpoint(str(tmp_path)) == committed


def test_the_jax_listings_read_the_ports_directories_alike(start, tmp_path, failing_saves):
    """Committed sharded, replicated, a staging orphan, a bare uncommitted
    sharded directory: `is_committed`, `has_shard_files`,
    `list_checkpoints` (both strictness levels) and `apply_retention` of
    the JAX package answer as the port's do."""
    tr, st = start
    roots = {}
    for tag in ("port", "jax"):
        root = tmp_path / tag
        save_checkpoint(str(root), st, "0nopush0.5000", sharded=True)
        save_checkpoint(str(root), st, "1nopush0.7000", sharded=False)
        bare = save_checkpoint(str(root), st, "2nopush0.6000", sharded=True)
        os.unlink(os.path.join(bare, COMMIT_FILE))
        save_checkpoint(str(root), st, "3push0.6500", sharded=True)
        failing_saves()
        with pytest.raises(IOError):
            save_checkpoint(str(root), st, "4nopush0.9000", retries=0, sharded=True)
        roots[tag] = str(root)
    names = sorted(os.listdir(roots["port"]))
    for name in names:
        path = os.path.join(roots["port"], name)
        assert jck.is_committed(path) == is_committed(path), name
        assert jck.has_shard_files(path) == has_shard_files(path), name
    for strict in (False, True):
        assert (jck.list_checkpoints(roots["port"], require_manifest=strict)
                == list_checkpoints(roots["port"], require_manifest=strict))
    got = sorted(os.path.basename(p) for p in apply_retention(roots["port"], 1, 1))
    want = sorted(os.path.basename(p) for p in jck.apply_retention(roots["jax"], 1, 1))
    assert got == want and sorted(os.listdir(roots["port"])) == sorted(os.listdir(roots["jax"]))


# ------------------------------------------------------------ guarded barrier
@pytest.fixture
def model_dir(tmp_path):
    yield str(tmp_path)
    multihost.clear_barrier()


def test_guarded_barrier_passes_when_peer_arrives(model_dir):
    g = multihost.configure_barrier(model_dir, timeout_s=5.0, process_id=0, num_processes=2,
                                    poll_s=0.01, session="t")

    def peer():
        time.sleep(0.15)
        with open(g._file("sync", 0, 1), "w") as f:
            f.write("x")

    t = threading.Thread(target=peer)
    t.start()
    multihost.guarded_barrier("sync")
    t.join()
    assert not os.path.exists(os.path.join(model_dir, multihost.PEER_LOST_FILE))


def test_guarded_barrier_timeout_writes_marker_and_dumps(model_dir, tmp_path, registry):
    dump_dir = str(tmp_path / "dumps")
    prev = set_recorder(FlightRecorder(dump_dir=dump_dir))
    try:
        g = multihost.configure_barrier(model_dir, timeout_s=0.3, process_id=0,
                                        num_processes=2, poll_s=0.01, session="t")
        multihost.heartbeat_tick()
        with pytest.raises(multihost.BarrierTimeoutError) as e:
            multihost.guarded_barrier("sync")
        assert e.value.missing == [1]
        with open(os.path.join(model_dir, multihost.PEER_LOST_FILE)) as f:
            payload = json.load(f)
        assert payload["missing_processes"] == [1]
        assert payload["exit_code"] == multihost.PEER_LOST_EXIT_CODE == 75
        assert payload["heartbeat_ages_s"]["1"] is None
        assert payload["heartbeat_ages_s"]["0"] is not None
        assert any(n.startswith("flightrec_peer_lost") for n in os.listdir(dump_dir))
        assert registry.counter(res_metrics.MISSED_BARRIERS).value(barrier="sync") == 1
        assert registry.counter(res_metrics.PEER_LOST).value() == 1
        assert g is multihost.barrier_guard()
        # a collective's error is agreed on the same way
        err = RuntimeError("Connection closed by peer")
        lost = multihost.agree_on_failure(err)
        assert lost.missing == [1] and lost.name == "peer_lost" and lost.__cause__ is err
    finally:
        set_recorder(prev)


def test_guarded_barrier_noop_when_unconfigured(model_dir):
    multihost.clear_barrier()
    multihost.guarded_barrier("anything")
    multihost.heartbeat_tick()
    multihost.checkpoint_barrier("x")
    assert multihost.peer_heartbeat_ages() == {}
    assert multihost.agree_on_failure(RuntimeError("x")) is None
    assert os.listdir(model_dir) == []


def test_barrier_session_namespacing(model_dir, monkeypatch):
    g1 = multihost.configure_barrier(model_dir, timeout_s=1.0, process_id=0, num_processes=2,
                                     poll_s=0.01, session="incarnation1")
    for pid in (0, 1):
        with open(g1._file("sync", 0, pid), "w") as f:
            f.write("x")
    monkeypatch.setenv("MGPROTO_BARRIER_SESSION", "incarnation2")
    g2 = multihost.configure_barrier(model_dir, timeout_s=0.2, process_id=0, num_processes=2,
                                     poll_s=0.01)
    assert g1.barrier_dir != g2.barrier_dir and g2.barrier_dir.endswith("incarnation2")
    with pytest.raises(multihost.BarrierTimeoutError):
        multihost.guarded_barrier("sync")


# ------------------------------------------------------------ the wire
def test_allgather_sum_single_process_identity():
    assert multihost.allgather_sum(float(2 ** 24 + 1)) == float(2 ** 24 + 1)
    assert multihost.any_across_hosts(True) is True
    assert multihost.any_across_hosts(False) is False


# ------------------------------------------------------- chaos host faults
def test_chaos_host_kill_wedge_knobs_parse_and_fire_once():
    from mgproto_tpu.resilience import chaos as jchaos

    env = {"MGPROTO_CHAOS_KILL_HOST_AT": "4", "MGPROTO_CHAOS_WEDGE_HOST_AT": "6",
           "MGPROTO_CHAOS_HOST_INDEX": "1", "MGPROTO_CHAOS_CKPT_FAILS": "2"}
    plan = chaos.plan_from_env(env)
    want = jchaos.plan_from_env(env)
    assert (plan.kill_host_at, plan.wedge_host_at, plan.host_index,
            plan.checkpoint_write_failures) == (want.kill_host_at, want.wedge_host_at,
                                                want.host_index,
                                                want.checkpoint_write_failures)
    assert plan.any_active() and chaos.HOST_KILL_EXIT_CODE == jchaos.HOST_KILL_EXIT_CODE == 86
    st = ChaosState(plan)
    assert not st.host_kill_due(10, process_index=0)
    assert not st.host_kill_due(3, process_index=1)
    assert st.host_kill_due(4, process_index=1)
    assert not st.host_kill_due(5, process_index=1)
    assert st.host_wedge_due(6, process_index=1)
    assert not st.host_wedge_due(7, process_index=1)
    assert [st.checkpoint_should_fail() for _ in range(3)] == [True, True, False]
    assert st.injections == {"host_kill": 1, "host_wedge": 1, "checkpoint_write": 2}


def test_new_resilience_counters_registered():
    from mgproto_tpu.resilience import metrics as jmetrics

    assert res_metrics.HELP == jmetrics.HELP
    for name in ("missed_barriers_total", "peer_lost_total", "elastic_restores_total"):
        assert name in res_metrics.ALL_COUNTERS
    reg = MetricRegistry()
    res_metrics.register_resilience_metrics(reg)
    snap = reg.snapshot()
    for name in res_metrics.ALL_COUNTERS:
        assert snap[name]["series"] == [{"labels": {}, "value": 0.0}]


def test_retry_schedule_and_budget_match_jax():
    from mgproto_tpu.resilience import retry as jretry

    from mgproto_tpu_torch.resilience import retry

    a = list(retry.backoff_delays(5, 0.1, 1.0, rng=np.random.default_rng(3)))
    b = list(jretry.backoff_delays(5, 0.1, 1.0, rng=np.random.default_rng(3)))
    assert a == b
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry.retry_call(flaky, retries=3, sleep=slept.append, scope="t") == "ok"
    assert len(calls) == 3 and len(slept) == 2
    with pytest.raises(ValueError):
        retry.retry_call(lambda: (_ for _ in ()).throw(ValueError("x")), retries=3,
                         no_retry_on=(ValueError,), sleep=slept.append)


# ------------------------------------------------------- across two ranks
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, start):
    """A save by two ranks at (1, 2) of one step from the carried state
    (each rank writing its class slab and its slices of the parameters and
    moments), restored by two ranks at (2, 1) and by four at (2, 2); the
    wire scenario beside it."""
    tr, st = start
    root = str(tmp_path_factory.mktemp("sharded"))
    ckpt = save_checkpoint(root, st, "0start0.0000", sharded=False)
    deadline = time.monotonic() + WALL_S
    out = os.path.join(root, "1x2")
    procs = start_ranks(root, (1, 2), [
        {"ckpt": ckpt, "steps": 1, "out": out, "save": os.path.join(out, "ckpt")},
        {"kind": "wire", "out": os.path.join(root, "wire")}], _batches_file(root))
    join_ranks(procs, deadline)
    saved = os.path.join(out, "ckpt", "1nopush0.5000")
    backs = {mesh: os.path.join(root, f"{mesh[0]}x{mesh[1]}") for mesh in ((2, 1), (2, 2))}
    procs = [p for mesh, back in backs.items()
             for p in start_ranks(root, mesh, [{"ckpt": saved, "steps": 0, "out": back}],
                                  _batches_file(root))]
    join_ranks(procs, deadline)
    load = lambda d, r: dict(np.load(os.path.join(d, f"rank{r}.npz")))  # noqa: E731
    return {"saved": saved, "ranks": [load(out, r) for r in (0, 1)],
            "back": [load(backs[(2, 1)], r) for r in (0, 1)],
            "back22": [load(backs[(2, 2)], r) for r in range(4)],
            "wire": os.path.join(root, "wire"), "trainer": tr}


def _batches_file(root):
    from test_torch_parallel import _batches

    path = os.path.join(root, "batches.npz")
    if not os.path.exists(path):
        np.savez(path, **_batches())
    return path


def _rank_chunks(whole_path, trainer, mesh):
    """{payload path: [start, stop) per axis} of what rank `mesh.rank` of a
    (1, m) `mesh` writes of a sharded save: its slab and slices of the
    whole state at `whole_path`, cut here by `shard_params` and
    `shard_classes`, spanned by `sharded_payload_axes`, and rank 0 every
    leaf held whole."""
    from mgproto_tpu_torch.parallel.sharding import (
        shard_classes,
        shard_params,
        sharded_payload_axes,
    )

    c = trainer.cfg.model.num_classes
    st = restore_checkpoint(whole_path, _target(trainer))
    shard_classes(shard_params(st, mesh, c), mesh)
    axes = sharded_payload_axes(st, c, mesh.model)
    out = {}
    for path, t in ck._tensors(ck.state_payload(st)):
        span = [[0, d] for d in t.shape]
        if path in axes:
            a, n = axes[path], t.shape[axes[path]]
            span[a] = [mesh.model_index * n, (mesh.model_index + 1) * n]
        elif mesh.rank:
            continue
        out[path] = span
    return out


def test_two_rank_save_restores_bit_equal_at_another_mesh_and_at_world_one(two_ranks, tmp_path):
    """The (1, 2) ranks each wrote exactly their spec's chunks: the class
    slab and their slices of the parameters and moments (rank 1 a half of
    the trunk, rank 0 no longer the whole of it), rank 0 the leaves held
    whole; the (2, 1) and (2, 2) ranks and one process restore the
    gathered state bit for bit, an elastic restore at world 1."""
    from mgproto_tpu_torch.parallel.mesh import Mesh

    saved = two_ranks["saved"]
    assert is_committed(saved) and jck.is_committed(saved)
    tr = two_ranks["trainer"]
    whole = save_checkpoint(str(tmp_path), restore_checkpoint(saved, _target(tr)),
                            "1nopush0.5000", sharded=False)
    with open(os.path.join(saved, MANIFEST_FILE)) as f:
        shapes = {e["path"]: e["shape"] for e in json.load(f)["leaves"]}
    for r in (0, 1):
        with open(os.path.join(saved, f"shard_{r:05d}.idx.json")) as f:
            chunks = {c["path"]: c["index"] for c in json.load(f)["chunks"]}
        assert chunks == _rank_chunks(whole, tr, Mesh(1, 2, rank=r)), r
        assert "gmm/means" in chunks, r  # every rank writes its slab
        trunk = [p for p in chunks if p.startswith("model/features.") and p.endswith("weight")]
        assert trunk and any(b - a != d for p in trunk
                             for (a, b), d in zip(chunks[p], shapes[p])), r
    r0 = two_ranks["ranks"][0]
    for back in two_ranks["back"] + two_ranks["back22"]:
        for k in ("means", "priors", "length", "cursor", "feats", "params", "running_mean"):
            np.testing.assert_array_equal(back[k], r0[k], err_msg=k)
    reg = MetricRegistry()
    prev = set_current_registry(reg)
    try:
        st = restore_checkpoint(saved, tr.init_state(0, for_restore=True))
    finally:
        set_current_registry(prev)
    full = _full_of(st)
    for k in ("means", "priors", "length", "cursor", "feats", "params"):
        np.testing.assert_array_equal(full[k], r0[k], err_msg=k)
    assert st.step == 3 and reg.counter(res_metrics.ELASTIC_RESTORES).value() == 1
    assert st.mean_opt.state[st.gmm.means]["exp_avg"].shape == st.gmm.means.shape


def test_the_wire_and_the_recorders_host_identity_on_two_ranks(two_ranks):
    """allgather_sum is exact in float64 past 2^24, allgather_rows keeps
    rank order and float64 bits, and each rank's recorder tags its events
    and dump header with its rank; rank 1 writes `.h1`, rank 0 the
    unsuffixed name (JAX's)."""
    wire = two_ranks["wire"]
    res = [json.load(open(os.path.join(wire, f"rank{r}.json"))) for r in (0, 1)]
    for r, got in enumerate(res):
        assert got["sum"] == float(2 * (2 ** 24 + 1) + 1)
        assert got["rows"] == [[0.0, 2.0 ** 53 - 1], [1.0, 2.0 ** 53 - 2]]
        assert got["event"]["host"] == r and got["event"]["kind"] == "probe"
        suffix = f".h{r}" if r else ""
        assert os.path.basename(got["dump"]) == f"flightrec_probe_000{suffix}.jsonl"
        with open(got["dump"]) as f:
            header = json.loads(f.readline())
        assert header["host"] == r and header["reason"] == "probe" and header["pid"] > 0


def test_one_process_recorder_dump_is_unsuffixed(tmp_path):
    rec = FlightRecorder(dump_dir=str(tmp_path))
    rec.record("x", a=1)
    path = rec.maybe_dump("crash")
    assert os.path.basename(path) == "flightrec_crash_000.jsonl"
    lines = [json.loads(ln) for ln in open(path)]
    assert lines[0]["host"] == 0 and lines[1]["kind"] == "x" and lines[1]["host"] == 0
    assert FlightRecorder().maybe_dump("crash") is None


def test_trainer_save_writes_the_format_it_is_told(start, tmp_path):
    tr, st = start
    trainer = Trainer(tr.cfg, 4, device="cpu")
    assert not has_shard_files(trainer.save(str(tmp_path), st, "0nopush0.1000"))
    trainer.ckpt_sharded = True
    path = trainer.save(str(tmp_path), st, "1nopush0.1000")
    assert has_shard_files(path) and is_committed(path)
    assert torch.equal(restore_checkpoint(path, _target(tr)).gmm.means, st.gmm.means)
    assert ck.latest_checkpoint(str(tmp_path)) == path


def test_cli_evaluate_restores_the_ranks_sharded_checkpoint_in_one_process(two_ranks, tmp_path,
                                                                            capsys):
    """`cli.evaluate` at world 1 on the two ranks' sharded checkpoint (an
    elastic restore) prints what it prints on the same state saved
    replicated."""
    from _torch_jax_states import write_jpeg_tree
    from mgproto_tpu_torch.cli import evaluate as tevaluate

    tree = write_jpeg_tree(str(tmp_path / "imgs"), 4, 2, seed=0)
    tr = two_ranks["trainer"]
    rep = save_checkpoint(str(tmp_path / "rep"), restore_checkpoint(
        two_ranks["saved"], tr.init_state(0, for_restore=True)), "1nopush0.5000")
    flags = ["--arch", "tiny", "--num_classes", "4", "--protos_per_class", "3", "--proto_dim",
             "8", "--aux_emb_sz", "8", "--mine_level", "4", "--mem_sz", "16", "--no_pretrained",
             "--num_workers", "0", "--device", "cpu", "--img_size", "32", "--batch_size", "4",
             "--train_dir", tree, "--test_dir", tree, "--push_dir", tree,
             "--model_dir", str(tmp_path / "eval")]  # its telemetry_eval lands there
    printed = []
    for path in (two_ranks["saved"], rep):
        tevaluate.main(flags + ["--checkpoint", path])
        printed.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert printed[0].pop("checkpoint") == two_ranks["saved"]
    assert printed[1].pop("checkpoint") == rep
    assert printed[0] == printed[1]


@pytest.mark.parametrize("classes", [4, 6])
def test_a_slabs_sharded_leaves_come_from_the_sharding_specs(classes):
    """`sharded_payload_axes` on a rank's state at model axis 2 names
    exactly the leaves the specs put on 'model' that the rank holds cut:
    after `shard_classes` the payload's class-leading leaves (the GMM, the
    bank and the mean optimizer's two moments, at C/2 rows each on axis 0;
    6 classes: a slab of 3, which the model axis does not divide again);
    after `shard_params` as well every parameter, proxy and joint moment
    whose spec names 'model', on its spec's axis, at half its length."""
    from mgproto_tpu_torch.config import tiny_test_config
    from mgproto_tpu_torch.core.state import create_train_state
    from mgproto_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
    from mgproto_tpu_torch.parallel.sharding import (
        shard_classes,
        shard_params,
        sharded_payload_axes,
        state_partition_specs,
    )

    state = create_train_state(tiny_test_config(num_classes=classes),
                               torch.Generator().manual_seed(0), "cpu")
    for p in [state.gmm.means] + Trainer.params(state):
        p.grad = torch.ones_like(p)
    state.mean_opt.step()  # the moments exist
    state.opt.step()
    specs = state_partition_specs(state, classes, 2)
    state = shard_classes(state, Mesh(1, 2, rank=1))
    slab = classes // 2
    axes = sharded_payload_axes(state, classes, 2)
    leaves = dict(ck._tensors(ck.state_payload(state)))
    want = {p for p in leaves if p.split("/")[0] in ("gmm", "memory")}
    want |= {"mean_opt/state/0/exp_avg", "mean_opt/state/0/exp_avg_sq"}
    assert axes == dict.fromkeys(want, 0)
    assert all(leaves[p].shape[0] == slab for p in axes)

    whole = {p: tuple(t.shape) for p, t in leaves.items()}
    shard_params(state, Mesh(1, 2, rank=1), classes)
    axes = sharded_payload_axes(state, classes, 2)
    leaves = dict(ck._tensors(ck.state_payload(state)))
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = [p for g in state.opt.param_groups for p in g["params"]]
    want = dict.fromkeys(want, 0)
    for n, spec in specs["model"].items():
        if MODEL_AXIS in spec:
            want[f"model/{n}"] = spec.index(MODEL_AXIS)
    if MODEL_AXIS in specs["proxies"]:
        want["proxies"] = specs["proxies"].index(MODEL_AXIS)
    for i, p in enumerate(params):
        name = "proxies" if p is state.proxies else names[id(p)]
        for key in ("exp_avg", "exp_avg_sq"):
            spec = specs["opt"][f"{name}/{key}"]
            if MODEL_AXIS in spec:
                want[f"opt/state/{i}/{key}"] = spec.index(MODEL_AXIS)
    assert axes == want
    assert any(p.startswith("model/") for p in axes) and any(p.startswith("opt/") for p in axes)
    for p, a in axes.items():
        if p.split("/")[0] not in ("gmm", "memory", "mean_opt"):
            assert leaves[p].shape[a] * 2 == whole[p][a], p


def test_a_model_axis_of_four_cuts_every_leaf_once():
    """`shard_params` on four constructed (1, 4) ranks of one whole state
    with its joint and warm moments: on each leaf the specs put on 'model',
    the four slices cover every element exactly once, in the spans
    `sharded_payload_axes` gives, and hold the whole state's values; the
    leaves held whole are equal on every rank."""
    from mgproto_tpu_torch.config import tiny_test_config
    from mgproto_tpu_torch.core.state import create_train_state
    from mgproto_tpu_torch.parallel.mesh import Mesh
    from mgproto_tpu_torch.parallel.sharding import shard_params, sharded_payload_axes

    cfg = tiny_test_config(num_classes=8, proto_dim=16)

    def state():
        st = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
        for i, p in enumerate(Trainer.params(st)):
            p.grad = torch.full_like(p, float(i + 1))
        st.opt.step()
        st.warm_opt.step()
        return st

    whole = dict(ck._tensors(ck.state_payload(state())))
    cover = {p: torch.zeros(t.shape, dtype=torch.int64) for p, t in whole.items()}
    for r in range(4):
        st = shard_params(state(), Mesh(1, 4, rank=r), cfg.model.num_classes)
        axes = sharded_payload_axes(st, cfg.model.num_classes, 4)
        assert all(not p.startswith(("gmm/", "memory/", "mean_opt/")) for p in axes)
        assert any(p.startswith("warm_opt/") for p in axes)
        for p, t in ck._tensors(ck.state_payload(st)):
            if p not in axes:
                assert torch.equal(t, whole[p]), p
                continue
            a, n = axes[p], t.shape[axes[p]]
            assert n * 4 == whole[p].shape[a], p
            assert torch.equal(t, whole[p].narrow(a, r * n, n)), p
            cover[p].narrow(a, r * n, n).add_(1)
    cut = [p for p, c in cover.items() if int(c.max()) > 0]
    assert cut and all(bool((cover[p] == 1).all()) for p in cut)
