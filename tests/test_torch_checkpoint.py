"""The port's checkpoints (mgproto_tpu_torch/utils/checkpoint.py) and its
carry of a JAX train state's optimizer state (models/convert.py), on the
CPU.

  * save -> restore into a fresh state is bit-exact for every tensor, every
    Adam state, `step` and `joint_updates`, and restores into the same
    parameter objects the optimizers hold;
  * a changed shape or dtype, or a truncated state file, raises
    CheckpointIntegrityError; a `.tmp` directory is never listed; a failed
    write is retried;
  * the listings, retention and selection give the JAX package's answers
    on the same directory of names (the JAX listing reads only names and
    manifests, and the port writes the JAX manifest schema);
  * a JAX TrainState after 3 steps carries across with its Adam moments
    (atol 1e-7), counts and `joint_updates` (exact), and the next 3 steps
    follow the JAX loss trajectory within atol 1e-3 a step, with the
    proxies and the means within atol 1e-5 after them (3e-7 measured; with
    the moments dropped they differ by about 1e-2).
"""

import functools
import importlib
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_jax_states import B, images, port_state, trained_jax_state
from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models.convert import _walk, _weight_name
from mgproto_tpu_torch.utils import checkpoint as tck

jck = importlib.import_module("mgproto_tpu.utils.checkpoint")

LABELS = np.array([0, 1, 2, 3, 0, 1], np.int32)


def _trained_port_state(cfg=None, seed=0):
    """A port state after two joint steps with EM from a full bank and one
    warm step, so all three optimizers hold state."""
    cfg = cfg or tiny_test_config()
    trainer = Trainer(cfg, steps_per_epoch=4, device="cpu")
    state = trainer.init_state(seed)
    m = cfg.model
    g = torch.Generator().manual_seed(1)
    state.memory = state.memory._replace(
        feats=torch.nn.functional.normalize(
            torch.randn(m.num_classes, m.mem_capacity, m.proto_dim, generator=g), dim=-1),
        length=torch.full((m.num_classes,), m.mem_capacity, dtype=torch.int32))
    for i in range(2):
        trainer.train_step(state, images(60 + i), LABELS, use_mine=True, update_gmm=True)
    trainer.train_step(state, images(62), LABELS, use_mine=True, update_gmm=False, warm=True)
    return trainer, state


def _all_tensors(state):
    return dict(tck._tensors(tck.state_payload(state)))


def test_save_restore_is_bit_exact(tmp_path):
    _, state = _trained_port_state()
    assert state.joint_updates == 2 and state.step == 3
    assert all(len(getattr(state, o).state) for o in ("opt", "warm_opt", "mean_opt"))
    path = tck.save_checkpoint(str(tmp_path), state, "0nopush0.5000", metadata={"epoch": 0})
    assert os.path.isfile(os.path.join(path, tck.STATE_FILE))
    assert tck.load_metadata(path) == {"epoch": 0}

    fresh = Trainer(tiny_test_config(), 4, device="cpu").init_state(5)
    params_before = [id(p) for p in fresh.opt.param_groups[0]["params"]]
    means_obj = fresh.gmm.means
    restored = tck.restore_checkpoint(path, fresh)
    assert restored is fresh and restored.gmm.means is means_obj
    assert [id(p) for p in restored.opt.param_groups[0]["params"]] == params_before
    assert dict(restored.model.named_parameters())["features.conv0.weight"] is \
        restored.opt.param_groups[0]["params"][0]
    assert restored.mean_opt.param_groups[0]["params"][0] is restored.gmm.means
    assert (restored.step, restored.joint_updates) == (state.step, state.joint_updates)
    want, got = _all_tensors(state), _all_tensors(restored)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and torch.equal(want[k], got[k]), k
        assert want[k].stride() == got[k].stride(), k  # channels_last moments stay so
    for o in ("opt", "warm_opt", "mean_opt"):
        a, b = getattr(state, o).state_dict(), getattr(restored, o).state_dict()
        assert a["param_groups"] == b["param_groups"], o

    # the restored state trains on exactly as the saved one
    trainer = Trainer(tiny_test_config(), 4, device="cpu")
    _, m_a = trainer.train_step(state, images(70), LABELS, use_mine=True, update_gmm=True)
    _, m_b = trainer.train_step(restored, images(70), LABELS, use_mine=True, update_gmm=True)
    assert m_a.loss.item() == m_b.loss.item()
    for k, v in _all_tensors(state).items():
        assert torch.equal(v, _all_tensors(restored)[k]), k


def test_integrity_errors(tmp_path):
    _, state = _trained_port_state()
    path = tck.save_checkpoint(str(tmp_path), state, "1nopush0.2500")
    wider = tiny_test_config(proto_dim=16)
    with pytest.raises(tck.CheckpointIntegrityError, match="does not match the restore target"):
        tck.restore_checkpoint(path, Trainer(wider, 4, device="cpu").init_state(0))

    target = lambda: Trainer(tiny_test_config(), 4, device="cpu").init_state(0)  # noqa: E731
    mpath = os.path.join(path, tck.MANIFEST_FILE)
    with open(mpath) as f:
        manifest = json.load(f)
    bad = json.loads(json.dumps(manifest))
    entry = next(e for e in bad["leaves"] if e["path"] == "gmm/priors")
    entry["dtype"] = "float64"
    with open(mpath, "w") as f:
        json.dump(bad, f)
    with pytest.raises(tck.CheckpointIntegrityError, match="gmm/priors"):
        tck.restore_checkpoint(path, target())

    # a payload whose tensor changed dtype under an intact manifest
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    payload = torch.load(os.path.join(path, tck.STATE_FILE), weights_only=True)
    payload["memory"]["length"] = payload["memory"]["length"].long()
    torch.save(payload, os.path.join(path, tck.STATE_FILE))
    with pytest.raises(tck.CheckpointIntegrityError, match="does not match its manifest"):
        tck.restore_checkpoint(path, target())

    tck.save_checkpoint(str(tmp_path), state, "1nopush0.2500")
    spath = os.path.join(path, tck.STATE_FILE)
    with open(spath, "rb") as f:
        head = f.read(os.path.getsize(spath) // 2)
    with open(spath, "wb") as f:
        f.write(head)
    with pytest.raises(tck.CheckpointIntegrityError, match="unreadable"):
        tck.restore_checkpoint(path, target())
    with open(mpath, "w") as f:
        f.write("{not json")
    with pytest.raises(tck.CheckpointIntegrityError, match="unreadable manifest"):
        tck.restore_checkpoint(path, target())


def test_a_failed_write_is_retried_and_never_listed(tmp_path, monkeypatch):
    _, state = _trained_port_state()
    real_save, calls = torch.save, []

    def flaky(obj, f):
        calls.append(f)
        if len(calls) == 1:
            raise OSError("disk hiccup")
        real_save(obj, f)

    monkeypatch.setattr(tck.time, "sleep", lambda s: None)
    monkeypatch.setattr(torch, "save", flaky)
    path = tck.save_checkpoint(str(tmp_path), state, "2push0.7500")
    assert len(calls) == 2 and os.path.isdir(path) and not os.path.exists(path + ".tmp")

    def broken(obj, f):
        raise OSError("disk gone")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk gone"):
        tck.save_checkpoint(str(tmp_path), state, "3nopush0.7500")
    assert os.path.isdir(os.path.join(tmp_path, "3nopush0.7500.tmp"))
    names = [os.path.basename(c[3]) for c in tck.list_checkpoints(str(tmp_path))]
    assert names == ["2push0.7500"]
    assert tck.find_latest_checkpoint(str(tmp_path)) == path


def _names_tree(root, state):
    """A directory of checkpoint names: real saves, a manifest-less legacy
    directory, a corrupt manifest, an interrupted `.tmp` save and names
    that do not parse."""
    for name in ("0nopush0.2500", "1nopush0.5000", "1push0.2500", "2nopush0.7500",
                 "2push0.5000", "2prune0.5000", "3preempt0.0000"):
        tck.save_checkpoint(str(root), state, name)
    os.makedirs(root / "4nopush0.1000")  # no manifest
    os.makedirs(root / "5nopush0.9000")
    (root / "5nopush0.9000" / tck.MANIFEST_FILE).write_text("{torn")
    shutil.copytree(root / "2prune0.5000", root / "6nopush0.9500.tmp")
    os.makedirs(root / "notacheckpoint")
    (root / "7nopush0.1234").write_text("a file, not a directory")
    return root


def _rel(entries, root):
    if entries is None:
        return None
    if isinstance(entries, str):
        return os.path.relpath(entries, root)
    if isinstance(entries, tuple):
        return entries[:3] + (os.path.relpath(entries[3], root),)
    return [_rel(e, root) for e in entries]


def test_listing_retention_and_selection_match_jax(tmp_path):
    _, state = _trained_port_state()
    root = _names_tree(tmp_path / "a", state)
    assert "6nopush0.9500.tmp" not in [os.path.basename(c[3]) for c in tck.list_checkpoints(
        str(root))]
    for strict in (False, True):
        assert _rel(tck.list_checkpoints(str(root), strict), root) == \
            _rel(jck.list_checkpoints(str(root), strict), root)
    assert _rel(tck.latest_checkpoint(str(root)), root) == _rel(jck.latest_checkpoint(str(root)),
                                                                root) == "4nopush0.1000"
    assert _rel(tck.find_latest_checkpoint(str(root)), root) == \
        _rel(jck.find_latest_checkpoint(str(root)), root) == "3preempt0.0000"
    for stage in ("nopush", "push", "prune", "missing"):
        for policy in ("best", "latest"):
            assert _rel(tck.select_checkpoint(str(root), stage, policy), root) == \
                _rel(jck.select_checkpoint(str(root), stage, policy), root)
    with pytest.raises(ValueError):
        tck.select_checkpoint(str(root), policy="first")
    assert tck.list_checkpoints(str(tmp_path / "absent")) == []

    twin = shutil.copytree(root, tmp_path / "b")
    for keep_last, keep_best in ((0, 1), (3, 1), (2, 0), (1, 2)):
        t_removed = tck.apply_retention(str(root), keep_last, keep_best)
        j_removed = jck.apply_retention(str(twin), keep_last, keep_best)
        assert sorted(_rel(t_removed, root)) == sorted(_rel(j_removed, twin))
        assert sorted(os.listdir(root)) == sorted(os.listdir(twin))
    assert "6nopush0.9500.tmp" not in os.listdir(root)


def test_names_and_conditional_save(tmp_path):
    for args in ((104, "nopush", 0.82244), (3, "prune", 1.0), (0, "push", 0.0)):
        name = tck.checkpoint_name(*args)
        assert name == jck.checkpoint_name(*args)
        assert tck.parse_checkpoint_name(name) == jck.parse_checkpoint_name(name)
    assert tck.parse_checkpoint_name("x1nopush0.5") is None
    _, state = _trained_port_state()
    assert tck.save_state_w_condition(str(tmp_path), state, 2, "nopush", 0.5, 0.6) is None
    path = tck.save_state_w_condition(str(tmp_path), state, 2, "nopush", 0.6, 0.6,
                                      metadata={"arch": "tiny"})
    assert os.path.basename(path) == "2nopush0.6000"
    assert tck.load_metadata(path) == {"arch": "tiny", "epoch": 2, "stage": "nopush",
                                       "accuracy": 0.6}


@functools.lru_cache(maxsize=None)
def _jax_after_three_steps():
    return trained_jax_state(steps=3)


def _adam_states(opt_state, groups):
    """{(group, torch name): (mu, nu, count)} of an optax multi_transform."""
    out = {}
    for g in groups:
        adam = [s for s in jax.tree_util.tree_leaves(
            opt_state.inner_states[g], is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")][0]
        for path, mu in _walk(adam.mu["net"]):
            nu = adam.nu["net"]
            for p in path:
                nu = nu[p]
            name, mu_t = _weight_name(path, np.asarray(mu))
            out[(g, name)] = (mu_t, _weight_name(path, np.asarray(nu))[1], int(adam.count))
        if hasattr(adam.mu["proxies"], "shape"):
            out[(g, "proxies")] = (np.asarray(adam.mu["proxies"]),
                                   np.asarray(adam.nu["proxies"]), int(adam.count))
    return out


def test_jax_optimizer_state_carries_across():
    jtrainer, jstate = _jax_after_three_steps()
    host = jax.device_get(jstate)
    _, pstate = port_state(jstate)
    assert pstate.joint_updates == 3 == int(host.step)
    params = dict(pstate.model.named_parameters(), proxies=pstate.proxies)
    want = _adam_states(host.opt_state, ("features", "add_on", "aux"))
    assert {n for _, n in want} == {n for n in params if not n.startswith("embedding")}
    for (_, name), (mu, nu, count) in want.items():
        st = pstate.opt.state[params[name]]
        assert count == 3 and st["step"].item() == count, name
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu, rtol=0, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu, rtol=0, atol=1e-7, err_msg=name)
        assert st["exp_avg"].stride() == params[name].stride(), name
    for p in pstate.warm_opt.param_groups[0]["params"]:
        assert p not in pstate.warm_opt.state  # no warm step was taken
    m = pstate.mean_opt.state[pstate.gmm.means]
    mean_adam = host.proto_opt_state[0]
    assert m["step"].item() == int(mean_adam.count) > 0
    np.testing.assert_allclose(m["exp_avg"].numpy(), np.asarray(mean_adam.mu), atol=1e-7)
    np.testing.assert_allclose(m["exp_avg_sq"].numpy(), np.asarray(mean_adam.nu), atol=1e-7)


def test_warm_optimizer_state_carries_across():
    jtrainer, jstate = _jax_after_three_steps()
    jstate, _ = jtrainer.train_step(jstate, images(80), LABELS, use_mine=True,
                                    update_gmm=False, warm=True)
    host = jax.device_get(jstate)
    _, pstate = port_state(jstate)
    params = dict(pstate.model.named_parameters(), proxies=pstate.proxies)
    want = _adam_states(host.warm_opt_state, ("add_on", "aux"))
    assert want and all(n.startswith("add_on") or n == "proxies" for _, n in want)
    for (_, name), (mu, nu, count) in want.items():
        st = pstate.warm_opt.state[params[name]]
        assert count == 1 and st["step"].item() == 1, name
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu, rtol=0, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu, rtol=0, atol=1e-7, err_msg=name)


def test_three_more_steps_follow_jax_after_the_carry():
    jtrainer, jstate = _jax_after_three_steps()
    ptrainer, pstate = port_state(jstate)
    rng = np.random.default_rng(9)
    for i in range(3):
        labels = rng.integers(0, 4, size=B).astype(np.int32)
        x = images(90 + i)
        jstate, jm = jtrainer.train_step(jstate, x, labels, use_mine=True, update_gmm=True)
        pstate, pm = ptrainer.train_step(pstate, x, labels, use_mine=True, update_gmm=True)
        np.testing.assert_allclose(pm.loss.item(), float(jm.loss), atol=1e-3, err_msg=f"step {i}")
    assert pstate.joint_updates == 6 and pstate.step == int(jstate.step) == 6
    # with the moments dropped these differ by ~1e-2 (measured); carried, ~3e-7
    np.testing.assert_allclose(pstate.proxies.detach().numpy(), np.asarray(jstate.params["proxies"]),
                               atol=1e-5)
    np.testing.assert_allclose(pstate.gmm.means.detach().numpy(), np.asarray(jstate.gmm.means),
                               atol=1e-5)
