"""The port's distributed runtime (mgproto_tpu_torch/parallel/) against the
JAX package's ShardedTrainer and the port's one-process Trainer, on the CPU.

The JAX references run here, on conftest's virtual CPU devices (the first
n of them for an n-rank mesh). The port's ranks are separate processes
(tests/_torch_parallel_worker.py, gloo on the CPU) that import no JAX:
they restore the start states that this process writes as port
checkpoints (the JAX state carried across by models/convert.py), take
their rows of seeded global batches of 8, and write their results. Every
spawn is joined within its own wall limit and what is left is killed, so a
hang fails one test.

Tolerances:
  * the port's ranks against the port's one-process Trainer on the same
    global batch: the loss rtol 2e-5; the means, the first trunk parameter,
    every parameter, the priors and the eval logits rtol 2e-5, atol 2e-6
    (tests/test_parallel.py's): the same arithmetic, summed in another
    order across the ranks; the bank's lengths, cursors and EM counts
    exact, its features atol 1e-5 (they come from the forward after the
    parameters' steps; tests/test_torch_train.py's bound).
  * the port's ranks against JAX's ShardedTrainer on the same mesh shape
    (tests/test_torch_train.py's tolerances, looser, as XLA's and ATen's
    CPU convolutions sum in different orders): the loss and accuracy atol
    1e-4; the bank's lengths exact; the means atol 1e-6 where no EM ran,
    else within 2 lr per EM round (atol 2 * num_em_loop * mean_lr); the
    first trunk parameter after one Adam step within 2 features_lr (Adam's
    first step turns a near-zero gradient into +-lr); the eval logits of
    the start state rtol 1e-5, atol 1e-4. Reference stepping from a full
    bank: priors atol 1e-5 and the means within 2 lr per class and round
    (tests/test_torch_options.py carries one EM call at 1e-6; here a whole
    step with its trunk runs first).
  * across the ranks of one run: every parameter and BatchNorm statistic
    bit-equal.
  * a checkpoint written by n ranks, restored by one process: bit-equal to
    the ranks' gathered state.
  * the at-rest layout (model axis above 1): every cut parameter and
    moment equal to its slice of the gathered whole, bit for bit; the
    bytes of their storage equal `tree_bytes_per_chip` of the specs
    exactly, and that count equals JAX's for its state at the same model
    axis exactly.
  * the async bank pipeline (three steps from a full bank, then the flush):
    against the port's one-process async Trainer as above (TIGHT, the
    bank's lengths, cursors and EM counts exact); against JAX's
    ShardedTrainer(async_bank=True) on the same mesh shape with the
    tolerances above, the means within 2 lr per EM round over the run's
    three bank phases and the first trunk parameter within 2 features_lr
    per Adam step; the ranks bit-equal.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from conftest import prefill_full_memory
from mgproto_tpu.config import EMConfig as JaxEMConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from mgproto_tpu.parallel import make_mesh as jax_make_mesh
from mgproto_tpu.parallel import sharding as jsharding
from mgproto_tpu_torch.config import LossConfig, tiny_test_config
from mgproto_tpu_torch.core.state import create_train_state
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models.convert import _module_name, from_jax_train_state, from_jax_variables
from mgproto_tpu_torch.parallel import sharding as tsharding
from mgproto_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, make_mesh, mesh_shape
from mgproto_tpu_torch.parallel.trainer import ShardedTrainer
from mgproto_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_parallel_worker.py")
B = 8
MESHES = ((2, 1), (1, 2), (2, 2))
SPAWN_WALL_S = 120
TIGHT = dict(rtol=2e-5, atol=2e-6)

sys.path.insert(0, HERE)
import _torch_parallel_worker as worker  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(root, mesh, scenarios, batches, device="cpu"):
    """Start the ranks of one run (each a process of its own); returns the
    processes. `join_ranks` waits for them."""
    n = mesh[0] * mesh[1]
    spec = {"init": f"tcp://127.0.0.1:{_free_port()}", "world": n, "mesh": list(mesh),
            "device": device, "backend": "gloo", "batches": batches, "scenarios": scenarios}
    path = os.path.join(root, f"spec_{mesh[0]}x{mesh[1]}_{device.replace(':', '')}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, path, str(r)], cwd=HERE, env=env,
                             stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for r in range(n)]


def join_ranks(procs, deadline):
    """Wait for every rank until `deadline` (time.monotonic()), kill what
    is left; fails with each failed rank's stderr. Returns each rank's
    stdout (None where it was not piped)."""
    errors, outs = [], []
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
    for p in procs:  # a rank killed above
        p.wait(timeout=10)
    assert not errors, "\n".join(errors)
    return outs


def _results(out, n):
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(n)]


def _batches():
    rng = np.random.RandomState(0)
    out = {f"x{i}": rng.rand(B, 32, 32, 3).astype(np.float32) for i in range(3)}
    out.update({f"y{i}": rng.randint(0, 4, size=B).astype(np.int64) for i in range(3)})
    out["ex"] = rng.rand(B, 32, 32, 3).astype(np.float32)
    return out


def _port_cfg(sc, batch):
    return worker.scenario_config(sc, batch)


def _jax_cfg(reference_stepping=False, async_bank=False):
    cfg = jax_tiny_config()
    return cfg.replace(em=JaxEMConfig(async_bank=async_bank, reference_stepping=reference_stepping))


# the scenarios of every mesh's run: (name, scenario keys, start state, steps)
SCENARIOS = (
    ("one", {}, "s0", 1),
    ("three", {}, "s0", 3),
    ("ref", {"reference_stepping": True}, "s1", 1),
    ("ms", {"aux_loss": "ms"}, "ms", 2),
    ("fused", {"fused_scoring": True, "fused_estep": True}, "s1", 2),
    ("async", {"async_bank": True}, "s1", 3),
)


def _port_single(sc, ckpt, batches, steps):
    """The one-process port Trainer on the global batches: its state and
    per-step (loss, accuracy, em_active)."""
    tr = Trainer(_port_cfg(sc, B), steps_per_epoch=4, device="cpu")
    st = restore_checkpoint(ckpt, tr.init_state(0, for_restore=True))
    eval0 = tr.eval_step(st, batches["ex"]).logits.numpy()
    rec = []
    for i in range(steps):
        st, m = tr.train_step(st, batches[f"x{i}"], batches[f"y{i}"], use_mine=True,
                              update_gmm=True)
        rec.append((float(m.loss), float(m.accuracy), m.em_active))
    st, _ = tr.flush_bank(st)
    return tr, st, rec, eval0, tr.eval_step(st, batches["ex"]).logits.numpy()


def _jax_async(s1, batches, mesh):
    """JAX's ShardedTrainer(async_bank=True) on conftest's virtual devices:
    three steps from the full bank, then the flush."""
    jcfg = _jax_cfg(async_bank=True)
    devices = jax.devices()[:mesh[0] * mesh[1]]
    sh = JaxShardedTrainer(jcfg, 4, mesh=jax_make_mesh(*mesh, devices=devices))
    st = sh.prepare(s1)
    rec = []
    for i in range(3):
        st, m = sh.train_step(st, batches[f"x{i}"], batches[f"y{i}"].astype(np.int32),
                              use_mine=True, update_gmm=True)
        rec.append((float(m.loss), int(m.em_active)))
    st, _ = sh.flush_bank(st)
    sd, _ = from_jax_variables({"params": jax.device_get(st.params["net"])},
                               jax.device_get(st.gmm))
    return dict(rec=rec, length=np.asarray(st.memory.length), means=np.asarray(st.gmm.means),
                params={k: v.numpy() for k, v in sd.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run every mesh's ranks, one mesh at a time, each beside a part of
    the references computed here: {"port": {mesh: {scenario: [rank results]}},
    "jax": ..., "single": ..., "ckpts": ...}."""
    root = str(tmp_path_factory.mktemp("parallel"))
    jcfg = _jax_cfg()
    jtrainer = JaxTrainer(jcfg, steps_per_epoch=4)
    s0 = jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0))
    s1 = prefill_full_memory(s0)
    tcfg = _port_cfg({}, B)
    ckpts = {
        "s0": save_checkpoint(root, from_jax_train_state(jax.device_get(s0), tcfg, "cpu"),
                              "0s0_0.0000"),
        "s1": save_checkpoint(root, from_jax_train_state(jax.device_get(s1), tcfg, "cpu"),
                              "0s1_0.0000"),
        "ms": save_checkpoint(root, create_train_state(
            _port_cfg({"aux_loss": "ms"}, B), torch.Generator().manual_seed(3), "cpu"),
            "0ms_0.0000"),
    }
    batches = _batches()
    bpath = os.path.join(root, "batches.npz")
    np.savez(bpath, **batches)
    deadline = time.monotonic() + SPAWN_WALL_S
    scenarios = {}
    for mesh in MESHES:
        scs = []
        for name, keys, start, steps in SCENARIOS:
            out = os.path.join(root, f"{mesh[0]}x{mesh[1]}", name)
            sc = dict(keys, ckpt=ckpts[start], steps=steps, out=out)
            if name == "three":
                sc["save"] = os.path.join(out, "ckpt")
            scs.append(sc)
        scenarios[mesh] = scs
    port = {}

    def join(mesh, procs):
        join_ranks(procs, deadline)
        port[mesh] = {name: _results(sc["out"], len(procs))
                      for (name, *_), sc in zip(SCENARIOS, scenarios[mesh])}

    # one mesh's ranks at a time (at most four processes), each beside a
    # part of the references
    running = start_ranks(root, MESHES[0], scenarios[MESHES[0]], bpath)
    x, y = batches["x0"], batches["y0"].astype(np.int32)
    jax_out = {}
    for mesh in MESHES:
        devices = jax.devices()[:mesh[0] * mesh[1]]
        sh = JaxShardedTrainer(jcfg, 4, mesh=jax_make_mesh(*mesh, devices=devices))
        st = sh.prepare(s0)
        eval0 = np.asarray(sh.eval_step(st, batches["ex"]).logits)
        st, m = sh.train_step(st, x, y, use_mine=True, update_gmm=True)
        sd, _ = from_jax_variables({"params": jax.device_get(st.params["net"])},
                                   jax.device_get(st.gmm))
        jax_out[mesh] = dict(
            loss=float(m.loss), accuracy=float(m.accuracy), em_active=int(m.em_active),
            length=np.asarray(st.memory.length), means=np.asarray(st.gmm.means),
            params={k: v.numpy() for k, v in sd.items()}, eval0=eval0)
    join(MESHES[0], running)
    running = start_ranks(root, MESHES[1], scenarios[MESHES[1]], bpath)
    rcfg = _jax_cfg(reference_stepping=True)
    sh = JaxShardedTrainer(rcfg, 4, mesh=jax_make_mesh(1, 2, devices=jax.devices()[:2]))
    st, m = sh.train_step(sh.prepare(s1), x, y, use_mine=True, update_gmm=True)
    jax_ref = dict(loss=float(m.loss), em_active=int(m.em_active),
                   means=np.asarray(st.gmm.means), priors=np.asarray(st.gmm.priors))
    jax_async = {m: _jax_async(s1, batches, m) for m in MESHES[:2]}
    join(MESHES[1], running)
    running = start_ranks(root, MESHES[2], scenarios[MESHES[2]], bpath)
    single = {name: _port_single(keys, ckpts[start], batches, steps)
              for name, keys, start, steps in SCENARIOS}
    jax_async[MESHES[2]] = _jax_async(s1, batches, MESHES[2])
    join(MESHES[2], running)
    return {"port": port, "jax": jax_out, "jax_ref": jax_ref, "single": single,
            "jax_async": jax_async, "batches": batches, "cfg": tcfg, "root": root}


def _full_of(state):
    return dict(means=state.gmm.means.detach().numpy(), priors=state.gmm.priors.numpy(),
                length=state.memory.length.numpy(), cursor=state.memory.cursor.numpy(),
                feats=state.memory.feats.numpy(),
                params=torch.cat([p.detach().reshape(-1) for p in Trainer.params(state)]).numpy())


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_one_step_matches_jax_sharded_and_the_single_process_trainer(runs, mesh):
    """One step with mining and EM from JAX's PRNGKey(0) state: the ranks
    against JAX's ShardedTrainer on the same mesh shape and against the
    port's one-process step; the eval logits of the start state too."""
    r0 = runs["port"][mesh]["one"][0]
    j = runs["jax"][mesh]
    np.testing.assert_allclose(r0["loss"][0], j["loss"], atol=1e-4)
    np.testing.assert_allclose(r0["accuracy"][0], j["accuracy"], atol=1e-4)
    np.testing.assert_array_equal(r0["length"], j["length"])
    assert r0["em_active"][0] == j["em_active"]
    cfg = runs["cfg"]
    means_tol = 1e-6 if j["em_active"] == 0 else 2 * cfg.em.num_em_loop * cfg.em.mean_lr
    np.testing.assert_allclose(r0["means"], j["means"], atol=means_tol)
    trunk0 = next(n for n, _ in create_train_state(
        cfg, torch.Generator(), "cpu").model.features.named_parameters())
    np.testing.assert_allclose(r0["trunk0"], j["params"][f"features.{trunk0}"],
                               atol=2 * cfg.optim.features_lr)
    np.testing.assert_allclose(r0["eval0"], j["eval0"], rtol=1e-5, atol=1e-4)

    _, st, rec, eval0, _ = runs["single"]["one"]
    np.testing.assert_allclose(r0["loss"][0], rec[0][0], rtol=2e-5)
    np.testing.assert_allclose(r0["accuracy"][0], rec[0][1], rtol=1e-6)
    full = _full_of(st)
    np.testing.assert_array_equal(r0["length"], full["length"])
    for k in ("means", "params"):
        np.testing.assert_allclose(r0[k], full[k], **TIGHT, err_msg=k)
    np.testing.assert_allclose(r0["trunk0"], next(st.model.features.parameters())
                               .detach().numpy(), **TIGHT)
    np.testing.assert_allclose(r0["eval0"], eval0, **TIGHT)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", ["three", "ref", "ms", "fused"])
def test_steps_match_the_single_process_trainer_and_ranks_agree_bitwise(runs, mesh, name):
    """three: three steps from an empty bank (it accumulates; EM runs once
    classes fill); ref: reference stepping from a full bank; ms: the
    Multi-Similarity aux loss (its [B, B] pair masks on the gathered
    batch); fused: the score_pool and E-step kernel wrappers (their plain
    versions on the CPU) on the class slabs, from a full bank. Every rank
    holds the one-process step's state, and the ranks' parameters and
    BatchNorm statistics are bit-equal."""
    ranks = runs["port"][mesh][name]
    r0 = ranks[0]
    _, st, rec, _, eval1 = runs["single"][name]
    np.testing.assert_allclose(r0["loss"], [r[0] for r in rec], rtol=2e-5)
    np.testing.assert_array_equal(r0["em_active"], [r[2] for r in rec])
    full = _full_of(st)
    for k in ("length", "cursor"):
        np.testing.assert_array_equal(r0[k], full[k], err_msg=k)
    np.testing.assert_allclose(r0["feats"], full["feats"], atol=1e-5)
    for k in ("means", "priors", "params"):
        np.testing.assert_allclose(r0[k], full[k], **TIGHT, err_msg=k)
    np.testing.assert_allclose(r0["eval_logits"], eval1, **TIGHT)
    for r in ranks[1:]:
        for k in ("params", "running_mean", "means", "priors", "length", "loss"):
            np.testing.assert_array_equal(r[k], r0[k], err_msg=k)
    if name in ("ref", "fused"):
        assert r0["em_active"][0] == runs["cfg"].model.num_classes  # the full bank's EM


def test_reference_stepping_matches_jax_sharded(runs):
    """Reference stepping from a full bank at mesh (1, 2) against JAX's
    ShardedTrainer at the same shape (the sequential pass over every
    class, gathered from the slabs)."""
    r0 = runs["port"][(1, 2)]["ref"][0]
    j = runs["jax_ref"]
    cfg = runs["cfg"]
    assert r0["em_active"][0] == j["em_active"] == cfg.model.num_classes
    np.testing.assert_allclose(r0["loss"][0], j["loss"], atol=1e-4)
    np.testing.assert_allclose(r0["priors"], j["priors"], atol=1e-5)
    np.testing.assert_allclose(r0["means"], j["means"],
                               atol=2 * cfg.em.num_em_loop * cfg.em.mean_lr)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_checkpoint_of_n_ranks_restores_in_one_process(runs, mesh):
    """Rank 0 writes the gathered state (`Trainer.save`); a one-process
    restore holds it bit for bit, and one more step from it equals the
    one-process trainer's fourth step."""
    r0 = runs["port"][mesh]["three"][0]
    path = os.path.join(runs["root"], f"{mesh[0]}x{mesh[1]}", "three", "ckpt", "1nopush0.5000")
    tr = Trainer(runs["cfg"], steps_per_epoch=4, device="cpu")
    st = restore_checkpoint(path, tr.init_state(0, for_restore=True))
    full = _full_of(st)
    for k in ("means", "priors", "length", "cursor", "feats", "params"):
        np.testing.assert_array_equal(full[k], r0[k], err_msg=k)
    assert st.step == 3


def _jax_param_bytes(model_size):
    """`tree_bytes_per_chip` of JAX's tiny state at a model axis of
    `model_size`: its parameters and the joint optimizer's Adam moments
    (the step counts left out: the port's Adam keeps a step per
    parameter)."""
    jstate = jax.eval_shape(JaxTrainer(_jax_cfg(), steps_per_epoch=4).init_state,
                            jax.random.PRNGKey(0))
    specs = jsharding.state_partition_specs(jstate, 4, model_size)
    counts = sum(np.dtype(x.dtype).itemsize for x in jax.tree_util.tree_leaves(jstate.opt_state)
                 if not x.shape)
    return (jsharding.tree_bytes_per_chip(jstate.params, specs.params, model_size)
            + jsharding.tree_bytes_per_chip(jstate.opt_state, specs.opt_state, model_size)
            - counts)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_parameters_and_moments_are_held_as_slices_at_rest(runs, mesh):
    """On every rank, after the restore onto the mesh and after three
    steps: at a model axis above 1 the leaves whose spec names 'model'
    hold only their slices, each equal to its slice of the gathered whole,
    and the storage behind the parameters and moments is exactly
    `tree_bytes_per_chip` of the specs (less than the whole state's),
    which is JAX's count for its state at that model axis; at (2, 1)
    everything whole."""
    for r in runs["port"][mesh]["three"]:
        for pre in ("layout0", "layout"):
            assert r[f"{pre}_equal"], pre
            assert r[f"{pre}_bytes"] == r[f"{pre}_spec"], pre
            if mesh[1] == 1:
                assert r[f"{pre}_cut"] == 0 and r[f"{pre}_spec"] == r[f"{pre}_replicated"]
            else:
                assert 0 < r[f"{pre}_cut"] <= r[f"{pre}_leaves"], pre
                assert r[f"{pre}_spec"] < r[f"{pre}_replicated"], pre
        assert r["layout_leaves"] > r["layout0_leaves"]  # the joint moments exist now
        assert int(r["layout_spec"]) == _jax_param_bytes(mesh[1])


# ------------------------------------------------------------ no spawning
def test_mesh_shapes_and_errors_match_jax():
    assert mesh_shape(8) == (8, 1)
    assert mesh_shape(8, model=2) == (4, 2)
    assert mesh_shape(4, 2, 2) == (2, 2)
    for data, model in ((3, 2), (-1, 3), (-1, 0)):
        with pytest.raises(ValueError) as port:
            mesh_shape(8, data, model)
        with pytest.raises(ValueError) as ref:
            jax_make_mesh(data, model)
        assert str(port.value) == str(ref.value)
    m = make_mesh()  # one process
    assert (m.size, m.rank, m.model_group, m.data_group) == (1, 0, None, None)
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        make_mesh(data=2)
    grid = Mesh(2, 2, rank=3)
    assert (grid.data_index, grid.model_index, grid.shape) == (1, 1, {"data": 2, "model": 2})
    assert grid.class_slab(8) == (4, 8) and grid.class_slab(5) == (0, 5)
    assert not grid.shards_classes(5) and grid.shards_classes(4)


def _leaf_path(path):
    return tuple(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))) for k in path)


def _jax_param_specs(tree):
    """{the port's parameter name: its JAX spec (JAX's axis order)} of a
    JAX params['net'] spec tree (models/convert.py's names)."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in flat:
        keys = _leaf_path(path)
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[keys[-1]]
        out[f"{_module_name(keys[:-1], None)}.{leaf}"] = tuple(spec)
    return out


def _norm(spec, ndim):
    spec = tuple(spec)[:ndim] + (None,) * max(ndim - len(tuple(spec)), 0)
    return () if all(s is None for s in spec) else spec


@pytest.mark.parametrize("classes,model_size", [(4, 1), (4, 2), (4, 4), (1000, 4)])
def test_state_partition_specs_match_jax_leaf_by_leaf(classes, model_size):
    """The port's spec tree against JAX's `state_partition_specs` for the
    same tiny config: every parameter (conv kernels compared on their
    layouts: JAX HWIO, the port [O, I, kh, kw]), the proxies, the GMM, the
    bank and the mean-Adam moments; at (1000, 4) the ImageNet-scale class
    sharding of tests/test_parallel.py (C = 1000, K = 2, d = 8, bank 8)."""
    kw = dict(num_classes=classes)
    if classes == 1000:
        kw.update(prototypes_per_class=2, proto_dim=8, mem_capacity=8, mine_T=3)
    jcfg = jax_tiny_config(**kw)
    jstate = jax.eval_shape(JaxTrainer(jcfg, steps_per_epoch=2).init_state,
                            jax.random.PRNGKey(0))
    jspecs = jsharding.state_partition_specs(jstate, classes, model_size)
    tcfg = tiny_test_config(**kw)
    tstate = create_train_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    tspecs = tsharding.state_partition_specs(tstate, classes, model_size)

    params = dict(tstate.model.named_parameters())
    want = _jax_param_specs(jspecs.params["net"])
    assert set(want) == set(params)
    for name, p in params.items():
        w = _norm(want[name], p.dim()) or (None,) * p.dim()
        if p.dim() == 4:  # HWIO -> [O, I, kh, kw]
            w = (w[3], w[2], w[0], w[1])
        elif p.dim() == 2:
            w = (w[1], w[0])
        assert _norm(tspecs["model"][name], p.dim()) == _norm(w, p.dim()), name
        for moment in ("exp_avg", "exp_avg_sq"):
            key = f"{name}/{moment}"
            if key in tspecs["opt"]:
                assert tspecs["opt"][key] == tspecs["model"][name], key
    assert _norm(tspecs["proxies"], 2) == _norm(jspecs.params["proxies"], 2)
    for field in ("gmm", "memory"):
        for leaf, spec in getattr(jspecs, field)._asdict().items():
            assert _norm(tspecs[field][leaf], 1) == _norm(spec, 1), (field, leaf)
    jmu = [s for s in jax.tree_util.tree_leaves(
        jspecs.proto_opt_state, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert {_norm(s, 1) for s in jmu} >= {_norm(tspecs["mean_opt"]["means/exp_avg"], 1)}
    if model_size > 1 and classes % model_size == 0:
        assert tspecs["gmm"]["means"] == (MODEL_AXIS,)
        assert tspecs["memory"]["feats"] == (MODEL_AXIS,)
        assert tspecs["mean_opt"]["means/exp_avg"] == (MODEL_AXIS,)
    # per-rank bytes of the class-sharded state: the GMM and the bank
    tb = {f: {k: t for k, t in getattr(tstate, f)._asdict().items()} for f in ("gmm", "memory")}
    jb = {f: getattr(jstate, f) for f in ("gmm", "memory")}
    assert tsharding.tree_bytes_per_chip(tb, tspecs, model_size) == \
        jsharding.tree_bytes_per_chip(jb, {f: getattr(jspecs, f) for f in jb}, model_size)
    assert tsharding.param_partition_spec((3, 5), 2) == ()
    assert tsharding.param_partition_spec((3, 3, 8, 16), 2) == (None, None, None, MODEL_AXIS)


@pytest.mark.parametrize("model_size", [2, 4])
def test_a_cut_state_holds_the_specs_bytes_on_every_rank(model_size):
    """`shard_params` on each rank of a constructed (1, m) mesh (no
    collective) of the tiny state with its joint moments: the storage
    behind the parameters and moments is `param_bytes_per_rank` exactly,
    which is JAX's per-chip count at m; the state then holds slices, and a
    second cut leaves it as it is."""
    cfg = tiny_test_config()
    for rank in range(model_size):
        st = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
        for p in Trainer.params(st):
            p.grad = torch.ones_like(p)
        st.opt.step()
        assert not tsharding.holds_slices(st)
        whole = tsharding.param_bytes_per_rank(st, 4, 1)
        assert tsharding.held_bytes(tsharding.param_tensors(st)) == whole
        tsharding.shard_params(st, Mesh(1, model_size, rank=rank), 4)
        held = tsharding.held_bytes(tsharding.param_tensors(st))
        assert tsharding.holds_slices(st)
        assert held == tsharding.param_bytes_per_rank(st, 4, model_size) == \
            _jax_param_bytes(model_size) < whole
        cut = {n: p.detach().clone() for n, p in st.model.named_parameters()}
        tsharding.shard_params(st, Mesh(1, model_size, rank=rank), 4)
        assert all(torch.equal(p, cut[n]) for n, p in st.model.named_parameters())


def test_full_state_refuses_a_cut_state_outside_full_params():
    """A state whose parameters hold this rank's slices has no whole
    parameters to give: `full_state` raises and names `full_params`."""
    cfg = tiny_test_config()
    mesh = Mesh(1, 2, rank=1)
    trainer = ShardedTrainer(cfg, steps_per_epoch=4, mesh=mesh, device="cpu")
    st = tsharding.shard_params(create_train_state(cfg, torch.Generator().manual_seed(0), "cpu"),
                                mesh, cfg.model.num_classes)
    with pytest.raises(RuntimeError, match="full_params"):
        trainer.full_state(st)


def test_sharding_rules_cover_every_state_field():
    tstate = create_train_state(tiny_test_config(), torch.Generator().manual_seed(0), "cpu")
    assert set(tsharding.SHARDING_RULES) == {f.name for f in dataclasses.fields(tstate)}
    rules = dict(tsharding.SHARDING_RULES)
    try:
        del tsharding.SHARDING_RULES["memory"]
        with pytest.raises(tsharding.ShardingCoverageError, match="memory"):
            tsharding.state_partition_specs(tstate, 4, 2)
    finally:
        tsharding.SHARDING_RULES.clear()
        tsharding.SHARDING_RULES.update(rules)


def test_put_batch_takes_this_ranks_rows():
    x = np.arange(8)
    assert tsharding.put_batch((x,), Mesh(2, 2, rank=2))[0].tolist() == [4, 5]
    with pytest.raises(ValueError, match="does not split"):
        tsharding.put_batch((np.arange(6),), Mesh(2, 2, rank=0))


def test_fused_scoring_with_indivisible_classes_raises_at_construction():
    """JAX's message, before any collective (a hand-built mesh of two
    model ranks; no process group is needed to refuse)."""
    cfg = tiny_test_config(num_classes=5)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, fused_scoring=True))
    with pytest.raises(ValueError, match="divisible by the mesh model axis"):
        ShardedTrainer(cfg, steps_per_epoch=4, mesh=Mesh(1, 2, rank=0), device="cpu")
    jcfg = jax_tiny_config(num_classes=5)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, fused_scoring=True))
    with pytest.raises(ValueError, match="divisible by the mesh model axis"):
        JaxShardedTrainer(jcfg, steps_per_epoch=4,
                          mesh=jax_make_mesh(1, 2, devices=jax.devices()[:2]))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_async_steps_match_jax_sharded_and_the_one_process_async_trainer(runs, mesh):
    """Three async steps from a full bank and the flush on the ranks: every
    rank holds the one-process async trainer's state (the trunk on the
    one-step-stale means of its slab, the bank phase's gather and EM sums
    on the bank's own process groups), the ranks bit-equal, and within the
    stated bounds of JAX's async ShardedTrainer on the same mesh shape."""
    ranks = runs["port"][mesh]["async"]
    r0 = ranks[0]
    _, st, rec, _, eval1 = runs["single"]["async"]
    np.testing.assert_allclose(r0["loss"], [r[0] for r in rec], rtol=2e-5)
    np.testing.assert_array_equal(r0["em_active"], [r[2] for r in rec])
    assert r0["em_active"][0] == 0  # the fill step holds its bank phase
    full = _full_of(st)
    for k in ("length", "cursor"):
        np.testing.assert_array_equal(r0[k], full[k], err_msg=k)
    np.testing.assert_allclose(r0["feats"], full["feats"], atol=1e-5)
    for k in ("means", "priors", "params"):
        np.testing.assert_allclose(r0[k], full[k], **TIGHT, err_msg=k)
    np.testing.assert_allclose(r0["eval_logits"], eval1, **TIGHT)
    for r in ranks[1:]:
        for k in ("params", "running_mean", "means", "priors", "length", "loss", "feats"):
            np.testing.assert_array_equal(r[k], r0[k], err_msg=k)

    j = runs["jax_async"][mesh]
    cfg = runs["cfg"]
    np.testing.assert_allclose(r0["loss"], [x[0] for x in j["rec"]], atol=1e-4)
    np.testing.assert_array_equal(r0["em_active"], [x[1] for x in j["rec"]])
    np.testing.assert_array_equal(r0["length"], j["length"])
    np.testing.assert_allclose(r0["means"], j["means"],
                               atol=3 * 2 * cfg.em.num_em_loop * cfg.em.mean_lr)
    trunk0 = next(n for n, _ in create_train_state(
        cfg, torch.Generator(), "cpu").model.features.named_parameters())
    np.testing.assert_allclose(r0["trunk0"], j["params"][f"features.{trunk0}"],
                               atol=3 * 2 * cfg.optim.features_lr)


def test_one_rank_sharded_trainer_is_the_trainer():
    """At world size 1 the ShardedTrainer's step is the Trainer's, bit for
    bit (no collective, no slab)."""
    cfg = tiny_test_config().replace(loss=LossConfig(aux_loss="proxy_anchor"))
    a, b = Trainer(cfg, 4, device="cpu"), ShardedTrainer(cfg, 4, device="cpu")
    sa, sb = a.init_state(0), b.init_state(0)
    batches = _batches()
    for i in range(2):
        sa, ma = a.train_step(sa, batches[f"x{i}"], batches[f"y{i}"], True, True)
        sb, mb = b.train_step(sb, batches[f"x{i}"], batches[f"y{i}"], True, True)
        assert float(ma.loss) == float(mb.loss)
    for p, q in zip(a.params(sa), b.params(sb)):
        assert torch.equal(p, q)
    assert torch.equal(sa.gmm.means, sb.gmm.means)
