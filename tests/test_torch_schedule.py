"""The port's training schedule (mgproto_tpu_torch/cli/train.py
`run_training`) and its top-M prune, on the CPU.

  * `prune_top_m` against the JAX package's on priors with ties at the
    threshold, with and without `renormalize`: priors and `keep` exactly
    equal; an M out of range raises in both.
  * `run_training` on a seeded class folder (tiny config, 4 classes x 5
    JPEGs as train, push and test set, one OoD folder; 2 epochs, push at
    epoch 1, prune at the end): the stage checkpoints, the step count, the
    provenance and the logs; `resume="auto"` from the prune checkpoint
    returns at once; resuming from epoch 0's `nopush` checkpoint gives the
    uninterrupted run's final state bit for bit (the CPU is deterministic);
    the push renders 3 pictures per pushed prototype under `img/epoch-1`,
    and `render_push=False` writes none.
  * the same schedule assembled from the JAX package's functions
    (`Trainer.train_epoch`, `evaluate_with_ood`, `push_prototypes`,
    `prune_top_m`) on its own loaders over the same folders, from the same
    carried start (a JAX state with a full bank, handed to `run_training`
    as a checkpoint to resume): per-step losses within atol 1e-3, push
    image ids equal (a prototype whose choice rests on a near-tie within
    1e-4 on the port's side may differ, one per such prototype), final
    priors within 1e-5 and `keep` equal, each stage's accuracy within
    1 / N_test.
"""

import functools
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_states import configs, full_bank, write_jpeg_tree
from mgproto_tpu.config import DataConfig as JaxDataConfig
from mgproto_tpu.core.mgproto import GMMState as JaxGMMState
from mgproto_tpu.core.mgproto import prune_top_m as jax_prune_top_m
from mgproto_tpu.data import build_pipelines as jax_build_pipelines
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu_torch.cli import train as ttrain
from mgproto_tpu_torch.config import DataConfig
from mgproto_tpu_torch.core.mgproto import GMMState, prune_top_m
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models.convert import from_jax_train_state
from mgproto_tpu_torch.utils import checkpoint as tck

jev = importlib.import_module("mgproto_tpu.engine.evaluate")
jpush = importlib.import_module("mgproto_tpu.engine.push")

BATCH = 6
CLASSES, PER_CLASS = 4, 5
N_TEST = CLASSES * PER_CLASS


def _priors_with_ties():
    rng = np.random.default_rng(4)
    p = rng.dirichlet(np.ones(5), size=6).astype(np.float32)
    p[0] = [0.3, 0.2, 0.2, 0.2, 0.1]  # three tied at the 2nd and 3rd largest
    p[1] = 0.2  # all tied
    p[2, 4] = p[2].max()  # a tie at the top
    return p


@pytest.mark.parametrize("renormalize", [False, True])
@pytest.mark.parametrize("top_m", [1, 2, 3, 5])
def test_prune_top_m_matches_jax(top_m, renormalize):
    pri = _priors_with_ties()
    z = np.zeros(pri.shape + (3,), np.float32)
    keep = np.ones(pri.shape, bool)
    j = jax_prune_top_m(JaxGMMState(*map(jnp.asarray, (z, z, pri, keep))), top_m, renormalize)
    t = prune_top_m(GMMState(*map(torch.from_numpy, (z, z, pri, keep))), top_m, renormalize)
    np.testing.assert_array_equal(t.priors.numpy(), np.asarray(j.priors))
    np.testing.assert_array_equal(t.keep.numpy(), np.asarray(j.keep))
    assert (t.keep.sum(-1) >= top_m).all()
    if top_m == 2:
        assert t.keep[0].sum() == 4 and t.keep[1].all()  # ties keep more than M
    assert (t.priors.numpy()[~t.keep.numpy()] == 0).all()


def test_prune_top_m_out_of_range_raises_in_both():
    pri = _priors_with_ties()
    z = np.zeros(pri.shape + (3,), np.float32)
    keep = np.ones(pri.shape, bool)
    for m in (0, 6):
        with pytest.raises(ValueError):
            prune_top_m(GMMState(*map(torch.from_numpy, (z, z, pri, keep))), m)
        with pytest.raises(ValueError):
            jax_prune_top_m(JaxGMMState(*map(jnp.asarray, (z, z, pri, keep))), m)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("schedule")
    return (write_jpeg_tree(str(root / "train"), CLASSES, PER_CLASS, seed=0),
            write_jpeg_tree(str(root / "ood"), 2, 3, seed=1))


def _data(train, ood, cls=DataConfig):
    return cls(train_dir=train, test_dir=train, train_push_dir=train, ood_dirs=(ood,),
               train_batch_size=BATCH, test_batch_size=BATCH, train_push_batch_size=BATCH,
               num_workers=0)


def _port_cfg(folders, model_dir):
    return configs()[1].replace(data=_data(*folders), model_dir=str(model_dir))


def _state_tensors(state):
    return dict(tck._tensors(tck.state_payload(state)))


def _assert_same_state(a, b):
    assert (a.step, a.joint_updates) == (b.step, b.joint_updates)
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def _records(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_training_stages_resume_and_logs(folders, tmp_path):
    cfg = _port_cfg(folders, tmp_path / "run")
    state, acc = ttrain.run_training(cfg, device="cpu")
    steps = N_TEST // BATCH
    assert state.step == 2 * steps and state.model.training
    stages = {c[1] for c in tck.list_checkpoints(cfg.model_dir)}
    assert stages == {"nopush", "push", "prune"}
    names = sorted(os.path.basename(c[3]) for c in tck.list_checkpoints(cfg.model_dir))
    assert [n[:2] for n in names] == ["0n", "1n", "1p", "1p"]
    for f in ("push_provenance.json", "train.log", "metrics.jsonl"):
        assert os.path.isfile(os.path.join(cfg.model_dir, f)), f
    with open(os.path.join(cfg.model_dir, "push_provenance.json")) as f:
        prov = json.load(f)
    assert prov["epoch"] == 1 and len(prov["image_id"]) == 4 * 3
    # the render (render_push, on by default): 3 pictures per pushed prototype
    pushed = int((np.array(prov["image_id"]) >= 0).sum())
    assert os.listdir(os.path.join(cfg.model_dir, "img")) == ["epoch-1"]
    assert len(os.listdir(os.path.join(cfg.model_dir, "img", "epoch-1"))) == 3 * pushed > 0
    recs = _records(cfg.model_dir)
    assert [r["render_s"] >= 0 for r in recs if "push_s" in r] == [True]
    assert [r.get("stage") for r in recs if "acc" in r] == [None, None, "push", "prune"]
    assert recs[-1]["acc"] == acc and all("AUROC_1" in r for r in recs if "acc" in r)
    assert (state.gmm.priors[~state.gmm.keep] == 0).all()
    with open(os.path.join(cfg.model_dir, "train.log")) as f:
        assert "training done" in f.read()

    again, acc2 = ttrain.run_training(cfg, resume="auto", device="cpu")
    assert acc2 == acc
    _assert_same_state(again, state)
    with open(os.path.join(cfg.model_dir, "train.log")) as f:
        assert "nothing to resume" in f.read()

    # resume from epoch 0's nopush checkpoint in a fresh directory
    epoch0 = [c for c in tck.list_checkpoints(cfg.model_dir) if c[0] == 0][0][3]
    resumed_cfg = cfg.replace(model_dir=str(tmp_path / "resumed"))
    resumed, acc3 = ttrain.run_training(resumed_cfg, resume=epoch0, device="cpu")
    assert acc3 == acc
    _assert_same_state(resumed, state)
    with pytest.raises(FileNotFoundError):
        ttrain.run_training(resumed_cfg, resume=str(tmp_path / "nothing"), device="cpu")


def test_run_training_without_render_push_writes_no_pictures(folders, tmp_path):
    cfg = _port_cfg(folders, tmp_path / "run")
    ttrain.run_training(cfg, device="cpu", render_push=False)
    assert not os.path.exists(os.path.join(cfg.model_dir, "img"))
    assert [r.get("render_s") for r in _records(cfg.model_dir) if "push_s" in r] == [None]


def _jax_cfg(folders):
    jcfg = configs()[0]
    return jcfg.replace(data=_data(*folders, cls=JaxDataConfig))


@functools.lru_cache(maxsize=None)
def _jax_schedule(folders):
    """The JAX package's functions in run_training's order; returns the
    start state, the per-step losses, the stage accuracies, the push result
    and the final GMM."""
    jcfg = _jax_cfg(folders)
    train, push, test, oods = jax_build_pipelines(jcfg)
    trainer = JaxTrainer(jcfg, steps_per_epoch=len(train))
    start = jax.jit(trainer.init_state)(jax.random.PRNGKey(3))
    start = start.replace(memory=full_bank(jcfg.model, 5))
    losses = []
    step = trainer.train_step

    def recording(*a, **kw):
        out = step(*a, **kw)
        losses.append(float(out[1].loss))
        return out

    trainer.train_step = recording

    def labeled(loader):
        for b in loader:
            yield (b[0], b[1]) + tuple(b[3:])

    def test_pass(state):
        return jev.evaluate_with_ood(trainer, state, labeled(test), [labeled(o) for o in oods],
                                     log=lambda *_: None)[0]

    state, accs, push_result = start, [], None
    for epoch in range(jcfg.schedule.num_train_epochs):
        train.epoch = epoch
        state, _ = trainer.train_epoch(state, labeled(train), epoch)
        accs.append(test_pass(state))
        if epoch in jcfg.schedule.push_epochs():
            state, push_result = jpush.push_prototypes(trainer, state, iter(push))
            accs.append(test_pass(state))
    state = state.replace(gmm=jax_prune_top_m(state.gmm, jcfg.schedule.prune_top_m))
    accs.append(test_pass(state))
    return jax.device_get(start), losses, accs, push_result, jax.device_get(state.gmm)


def test_schedule_matches_the_jax_functions_assembled(folders, tmp_path, monkeypatch):
    jstart, jlosses, jaccs, jpush_result, jgmm = _jax_schedule(folders)
    cfg = _port_cfg(folders, tmp_path / "run")
    start = from_jax_train_state(jstart, cfg, device="cpu")
    ckpt = tck.save_checkpoint(str(tmp_path), start, "start",
                               metadata={"epoch": -1, "stage": "nopush"})
    losses = []
    step = Trainer.train_step

    def recording(self, *a, **kw):
        out = step(self, *a, **kw)
        losses.append(out[1].loss.item())
        return out

    monkeypatch.setattr(Trainer, "train_step", recording)
    state, _ = ttrain.run_training(cfg, resume=ckpt, device="cpu")

    assert len(losses) == len(jlosses) == 2 * (N_TEST // BATCH)
    np.testing.assert_allclose(losses, jlosses, atol=1e-3)
    accs = [r["acc"] for r in _records(cfg.model_dir) if "acc" in r]
    assert len(accs) == len(jaccs) == 4
    np.testing.assert_allclose(accs, jaccs, atol=1.0 / N_TEST + 1e-12)
    with open(os.path.join(cfg.model_dir, "push_provenance.json")) as f:
        ids = np.array(json.load(f)["image_id"]).reshape(jpush_result.image_id.shape)
    assert (ids != jpush_result.image_id).sum() <= _near_tie_pushes(cfg)
    np.testing.assert_allclose(state.gmm.priors.numpy(), np.asarray(jgmm.priors), atol=1e-5)
    np.testing.assert_array_equal(state.gmm.keep.numpy(), np.asarray(jgmm.keep))


def _near_tie_pushes(cfg):
    """Prototypes whose push on the port's side rests on a near-tie: two of
    their candidates' best densities within 1e-4, from the scan of the state
    the push saw (epoch 1's `nopush` checkpoint)."""
    from mgproto_tpu_torch.data import build_pipelines
    from mgproto_tpu_torch.engine.push import scan_candidates

    trainer = Trainer(cfg, 1, device="cpu")
    before_push = [c for c in tck.list_checkpoints(cfg.model_dir) if c[:2] == (1, "nopush")]
    state = tck.restore_checkpoint(before_push[0][3], trainer.init_state(0))
    _, push, _, _ = build_pipelines(cfg, device="cpu")
    cand = scan_candidates(trainer, state, push)
    near = 0
    for c in range(cfg.model.num_classes):
        v = cand.vals[cand.labels == c]
        for k in range(v.shape[1]):
            gaps = np.abs(v[:, None, k] - v[None, :, k])[np.triu_indices(len(v), 1)]
            near += int((gaps <= 1e-4).any())
    return near
