"""The port's divergence guard, rollback and preemption
(mgproto_tpu_torch/resilience/, `Trainer.train_epoch(guard=...)`,
`cli/train.py::run_training`) on the CPU.

  * `EpochGuard` against the JAX package's on seeded `nonfinite` flag
    sequences, for several `check_every` and `max_bad_steps`: the same
    step raises `DivergenceError` (with the same streak and step), or
    neither raises; the final poll in `end_epoch` included; the skipped
    steps counted equal.
  * The drills run the tiny schedule (4 classes x 5 JPEGs, 2 epochs, push
    at epoch 1) and are held to the port's own clean run, bit for bit
    (the CPU is deterministic), not to the JAX package's chaos drill,
    which fails on the seed:
    - `nan_at_step` with `max_bad_steps=1`: one rollback to epoch 0's
      checkpoint, and the final state equals the clean run's;
    - a rollback budget of 0 re-raises the DivergenceError;
    - `preempt_at_step`: a `preempt` checkpoint with its batch position
      and PREEMPTED.json; `resume="auto"` clears the marker and ends
      equal to the clean run;
    - a preemption keeps the epoch's gates: a resume after the bank has
      filled mid-epoch still runs the epoch without EM, as the clean run
      did.
  * `plan_from_env`: the two ported knobs read; every other
    MGPROTO_CHAOS_* knob, the seed of the JAX package's random events
    included, raises with its ROADMAP item.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_states import configs, write_jpeg_tree
from mgproto_tpu.resilience.guard import DivergenceError as JaxDivergenceError
from mgproto_tpu.resilience.guard import EpochGuard as JaxEpochGuard
from mgproto_tpu_torch.cli import train as ttrain
from mgproto_tpu_torch.config import DataConfig
from mgproto_tpu_torch.resilience import chaos, preemption
from mgproto_tpu_torch.resilience.guard import DivergenceError, EpochGuard
from mgproto_tpu_torch.utils import checkpoint as tck

BATCH = 6
CLASSES, PER_CLASS = 4, 5
STEPS_PER_EPOCH = CLASSES * PER_CLASS // BATCH  # the train loader drops the tail


class _Flag:
    def __init__(self, bad, jax_side):
        self.nonfinite = jnp.asarray(bad) if jax_side else bool(bad)


class _Step:
    def __init__(self, step):
        self.step = step


def _drive(guard_cls, error_cls, flags, jax_side, **kw):
    """(outcome, skipped): outcome is ("raise", streak, step, at) or ("end",)."""
    guard = guard_cls(**kw)
    guard.begin_epoch(3, _Step(np.int32(100)) if jax_side else _Step(100))
    try:
        for i, bad in enumerate(flags):
            if jax_side:
                guard.after_step(None, _Flag(bad, True))
            else:
                guard.after_step(_Flag(bad, False))
        skipped = guard.end_epoch()
    except error_cls as e:
        return ("raise", e.streak, e.step, e.epoch), None
    return ("end",), int(skipped)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("check_every", [1, 3, 8])
@pytest.mark.parametrize("max_bad", [0, 1, 2, 3])
def test_guard_raises_where_jax_raises(seed, check_every, max_bad):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 30))
    # runs of bad steps of every length, some reaching the limit between polls
    flags = rng.random(n) < rng.uniform(0.2, 0.8)
    kw = dict(max_bad_steps=max_bad, check_every=check_every)
    want = _drive(JaxEpochGuard, JaxDivergenceError, flags, True, **kw)
    got = _drive(EpochGuard, DivergenceError, flags, False, **kw)
    assert got == want


def test_guard_raises_in_end_epoch_as_jax_does():
    flags = [False, True, True]  # the streak reaches 2 after the last poll
    kw = dict(max_bad_steps=2, check_every=8)
    want = _drive(JaxEpochGuard, JaxDivergenceError, flags, True, **kw)
    assert want[0][0] == "raise"
    assert _drive(EpochGuard, DivergenceError, flags, False, **kw) == want


# ------------------------------------------------------------------ drills
@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_jpeg_tree(str(tmp_path_factory.mktemp("guard") / "train"), CLASSES,
                           PER_CLASS, seed=0)


def _cfg(folder, model_dir, device_augment=None):
    data = DataConfig(train_dir=folder, test_dir=folder, train_push_dir=folder,
                      train_batch_size=BATCH, test_batch_size=BATCH,
                      train_push_batch_size=BATCH, num_workers=0,
                      device_augment=device_augment)
    return configs()[1].replace(data=data, model_dir=str(model_dir))


def _assert_same_state(a, b):
    assert (a.step, a.joint_updates) == (b.step, b.joint_updates)
    ta = dict(tck._tensors(tck.state_payload(a)))
    tb = dict(tck._tensors(tck.state_payload(b)))
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def _run(cfg, **kw):
    return ttrain.run_training(cfg, device="cpu", render_push=False, **kw)


@pytest.fixture(scope="module")
def clean(folder, tmp_path_factory):
    state, acc = _run(_cfg(folder, tmp_path_factory.mktemp("clean")))
    assert state.step == 2 * STEPS_PER_EPOCH
    return state, acc


@pytest.mark.parametrize("device_augment", [False, True])
def test_nan_drill_rolls_back_once_and_ends_equal_to_the_clean_run(folder, tmp_path, clean,
                                                                   device_augment):
    """On the uint8 wire (device augmentation, as on the card) the NaN
    rides on the augmentation draws; on the f32 wire on the images."""
    if device_augment:
        state_ref, acc_ref = _run(_cfg(folder, tmp_path / "ref", device_augment=True))
    else:
        state_ref, acc_ref = clean
    nan_step = STEPS_PER_EPOCH + 1  # epoch 1, after epoch 0's checkpoint
    cs = chaos.ChaosState(chaos.ChaosPlan(nan_at_step=nan_step))
    state, acc = _run(_cfg(folder, tmp_path, device_augment=device_augment), chaos=cs,
                      max_bad_steps=1, divergence_check_every=1, max_rollbacks=1)
    assert cs.injections == {"nan_loss": 1}
    log = open(os.path.join(tmp_path, "train.log")).read()
    rollbacks = [ln for ln in log.splitlines() if "; rolling back to " + str(tmp_path) in ln]
    assert len(rollbacks) == 1 and "0nopush" in rollbacks[0] and "(1/1)" in rollbacks[0]
    _assert_same_state(state, state_ref)
    assert acc == acc_ref


def test_an_exhausted_rollback_budget_reraises(folder, tmp_path):
    cs = chaos.ChaosState(chaos.ChaosPlan(nan_at_step=STEPS_PER_EPOCH + 1))
    with pytest.raises(DivergenceError) as e:
        _run(_cfg(folder, tmp_path), chaos=cs, max_bad_steps=1, divergence_check_every=1,
             max_rollbacks=0)
    assert e.value.step == STEPS_PER_EPOCH + 2 and e.value.epoch == 1


def test_preempt_drill_saves_and_resumes_to_the_clean_run(folder, tmp_path, clean):
    state_ref, acc_ref = clean
    cfg = _cfg(folder, tmp_path)
    preempt_step = STEPS_PER_EPOCH + 1
    cs = chaos.ChaosState(chaos.ChaosPlan(preempt_at_step=preempt_step))
    state, _ = _run(cfg, chaos=cs)
    assert preemption.get_handler().requested()
    # the step the flag was raised for finished first
    assert state.step == preempt_step + 1
    marker = preemption.read_marker(str(tmp_path))
    assert marker["epoch"] == 1 and marker["batch_in_epoch"] == 2
    ckpt = tck.find_latest_checkpoint(str(tmp_path))
    meta = tck.load_metadata(ckpt)
    assert os.path.basename(ckpt).startswith("1preempt")
    assert meta["stage"] == "preempt" and meta["batch_in_epoch"] == 2
    assert meta["reason"] == "chaos preempt_at_step"
    assert meta["epoch_flags"] == {"warm": False, "use_mine": True, "update_gmm": False}
    state, acc = _run(cfg, resume="auto")
    assert preemption.read_marker(str(tmp_path)) is None
    assert not preemption.get_handler().requested()
    _assert_same_state(state, state_ref)
    assert acc == acc_ref
    log = open(os.path.join(tmp_path, "train.log")).read()
    assert "skipping 2 completed batches" in log


def test_a_resume_keeps_the_gates_of_the_preempted_epoch(folder, tmp_path):
    """The bank (16 rows a class) fills during epoch 1: EM is off for the
    whole epoch in an uninterrupted run, since the gate reads the bank at
    the epoch's start. A resume from a preempt save in that epoch must keep
    it off."""
    cfg = _cfg(folder, tmp_path)
    ref, _ = _run(cfg.replace(model_dir=str(tmp_path / "ref")))
    cs = chaos.ChaosState(chaos.ChaosPlan(preempt_at_step=STEPS_PER_EPOCH + 1))
    state, _ = _run(cfg, chaos=cs)
    assert bool((state.memory.length == state.memory.capacity).all())
    meta = tck.load_metadata(tck.find_latest_checkpoint(str(tmp_path)))
    assert meta["epoch_flags"]["update_gmm"] is False
    state, _ = _run(cfg, resume="auto")
    _assert_same_state(state, ref)


def test_plan_from_env_reads_the_ported_knobs():
    assert chaos.plan_from_env({}) is None
    assert chaos.plan_from_env({"MGPROTO_CHAOS_PREEMPT_AT_STEP": ""}) is None
    plan = chaos.plan_from_env({"MGPROTO_CHAOS_NAN_AT_STEP": "5",
                                "MGPROTO_CHAOS_PREEMPT_AT_STEP": "", "OTHER": "x"})
    assert plan == chaos.ChaosPlan(nan_at_step=5, preempt_at_step=None)
    with pytest.raises(ValueError, match="not a valid int"):
        chaos.plan_from_env({"MGPROTO_CHAOS_NAN_AT_STEP": "five"})


@pytest.mark.parametrize("knob,item", [
    ("MGPROTO_CHAOS_LOADER_IO_RATE", "A9"),
    ("MGPROTO_CHAOS_LOADER_IO_FAILS", "A9"),
    ("MGPROTO_CHAOS_SLOW_HOST_MS", "A9"),
])
def test_plan_from_env_refuses_a_knob_it_does_not_read(knob, item):
    with pytest.raises(ValueError, match=f"{knob}=.*ROADMAP item {item}"):
        chaos.plan_from_env({knob: "1", "MGPROTO_CHAOS_NAN_AT_STEP": "2"})


@pytest.mark.parametrize("knob,raw", [
    ("MGPROTO_CHAOS_SEED", "7"),
    ("MGPROTO_CHAOS_SERVE_MALFORMED_RATE", "0.25"),
    ("MGPROTO_CHAOS_SERVE_NAN_RATE", "0.5"),
    ("MGPROTO_CHAOS_SERVE_DEVICE_ERRORS", "1,4"),
    ("MGPROTO_CHAOS_SERVE_STORM_AT", "3"),
    ("MGPROTO_CHAOS_SERVE_STORM_LEN", "2"),
    ("MGPROTO_CHAOS_SERVE_REPLICA_KILL_AT", "5"),
    ("MGPROTO_CHAOS_SERVE_WEDGE_AT", "6"),
    ("MGPROTO_CHAOS_SERVE_SWAP_BAD_ARTIFACT", "1"),
    ("MGPROTO_CHAOS_TENANT_STORM_AT", "8"),
    ("MGPROTO_CHAOS_TENANT_BAD_SWAP", "2"),
    ("MGPROTO_CHAOS_ONLINE_POISON_RATE", "0.25"),
    ("MGPROTO_CHAOS_TENANT_POISON_RATE", "0.5"),
    ("MGPROTO_CHAOS_CKPT_FAILS", "2"),
    ("MGPROTO_CHAOS_KILL_HOST_AT", "4"),
    ("MGPROTO_CHAOS_WEDGE_HOST_AT", "6"),
    ("MGPROTO_CHAOS_HOST_INDEX", "1"),
])
def test_plan_from_env_reads_the_serving_knobs_as_jax_does(knob, raw):
    """The serving, tenant, online, checkpoint and pod knobs (refused
    before each was ported) parse to the JAX package's values, field for
    field."""
    from mgproto_tpu.resilience import chaos as jchaos

    env = {knob: raw, "MGPROTO_CHAOS_NAN_AT_STEP": "2"}
    got, want = chaos.plan_from_env(env), jchaos.plan_from_env(env)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_preemption_marker_round_trip(tmp_path):
    assert preemption.read_marker(str(tmp_path)) is None
    path = preemption.write_marker(str(tmp_path), str(tmp_path / "ck"), reason="signal SIGTERM",
                                   extra={"epoch": 2})
    got = json.load(open(path))
    assert got["reason"] == "signal SIGTERM" and got["epoch"] == 2
    assert preemption.read_marker(str(tmp_path))["checkpoint"] == str(tmp_path / "ck")
    preemption.clear_marker(str(tmp_path))
    preemption.clear_marker(str(tmp_path))
    assert preemption.read_marker(str(tmp_path)) is None


def test_install_handlers_sets_the_flag_on_the_first_signal():
    import signal

    h = preemption.PreemptionHandler()
    uninstall = preemption.install_handlers((signal.SIGUSR1,), handler=h)
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.requested() and h.reason == "signal SIGUSR1"
    finally:
        uninstall()


@pytest.mark.parametrize("knob,due", [("MGPROTO_CHAOS_ONLINE_POISON_RATE", "online_poison_due"),
                                      ("MGPROTO_CHAOS_TENANT_POISON_RATE", "tenant_poison_due")])
def test_the_poison_knobs_draw_the_requests_jax_draws(knob, due):
    """Each poison knob hits the same request indices as the JAX package's
    (numpy's default_rng([seed, tag, index])), at roughly its rate, and
    counts every hit."""
    from mgproto_tpu.resilience import chaos as jchaos

    env = {knob: "0.25", "MGPROTO_CHAOS_SEED": "3"}
    got = chaos.ChaosState(chaos.plan_from_env(env))
    want = jchaos.ChaosState(jchaos.plan_from_env(env))
    hits = [getattr(got, due)(i) for i in range(400)]
    assert hits == [getattr(want, due)(i) for i in range(400)]
    assert 40 <= sum(hits) <= 160
    assert got.injections[due.removesuffix("_due")] == sum(hits)
    off = chaos.ChaosState(chaos.ChaosPlan(seed=3))
    assert not any(getattr(off, due)(i) for i in range(50))
