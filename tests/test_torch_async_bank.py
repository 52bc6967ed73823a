"""The port's async bank pipeline (mgproto_tpu_torch/engine/train.py
`_async_train_step`, `flush_bank`, `reset_bank_pipeline`) against the JAX
package's, on the CPU.

A tiny JAX `Trainer` with `async_bank=True` (fused_scoring and fused_estep
forced on, so its Pallas kernels run in interpret mode; compact EM width 2
of 4 classes) and a pre-filled bank, carried into the port by
`from_jax_train_state`; both run the same seeded batches.

Tolerances (those of tests/test_torch_train.py):
  * losses and metrics of every step: atol 1e-4 (XLA's and ATen's CPU
    convolutions sum in different orders; the loss is O(10)). em_active,
    em_compact_fallback and nonfinite exactly (they carry the previous
    step's bank, zeros on the fill step).
  * after the flush: the bank's lengths, cursors and flags exact, features
    atol 1e-5; priors atol 1e-5; means within 2 lr per EM round
    (atol 2 * rounds * mean_lr over every round the run took).
  * the port against itself: bit-equal (the one-step-stale oracle built
    from the step's own functions, the staleness, async off).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgproto_tpu.config import EMConfig as JaxEMConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.core import memory as jmem
from _torch_async_oracle import one_step_stale_oracle
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu_torch.config import EMConfig, tiny_test_config
from mgproto_tpu_torch.core.em import bank_update
from mgproto_tpu_torch.engine import train as ttrain
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.models.convert import from_jax_train_state
from mgproto_tpu_torch.resilience.guard import DivergenceError, EpochGuard

B = 6
WIDTH = 2
STEPS = 4


def _configs(async_bank=True):
    jcfg = jax_tiny_config()
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, fused_scoring=True),
        em=JaxEMConfig(fused_estep=True, async_bank=async_bank, max_active_classes=WIDTH),
    )
    tcfg = tiny_test_config()
    tcfg = tcfg.replace(
        model=dataclasses.replace(tcfg.model, fused_scoring=True),
        em=EMConfig(fused_estep=True, max_active_classes=WIDTH, async_bank=async_bank),
    )
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_start():
    """A JAX state with the bank pre-filled (classes 0-2 full, class 3 two
    short, nothing marked updated)."""
    jcfg, _ = _configs()
    trainer = JaxTrainer(jcfg, steps_per_epoch=STEPS)
    state = jax.jit(trainer.init_state)(jax.random.PRNGKey(0))
    m = jcfg.model
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(m.num_classes, m.mem_capacity, m.proto_dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    length = np.full(m.num_classes, m.mem_capacity, np.int32)
    length[3] -= 2
    memory = jmem.Memory(
        feats=jnp.asarray(feats), length=jnp.asarray(length),
        cursor=jnp.asarray(rng.integers(0, m.mem_capacity, m.num_classes).astype(np.int32)),
        updated=jnp.zeros(m.num_classes, bool),
    )
    return jax.device_get(state.replace(memory=memory))


def _port(async_bank=True):
    _, tcfg = _configs(async_bank)
    return Trainer(tcfg, steps_per_epoch=STEPS, device="cpu"), from_jax_train_state(
        _jax_start(), tcfg, device="cpu")


def _batches(n=STEPS, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, 4, size=B).astype(np.int32)
        out.append((rng.normal(size=(B, 32, 32, 3)).astype(np.float32), labels))
    return out


def _state_arrays(state):
    """Every tensor of a port state, by name, as numpy."""
    out = {f"model.{k}": v.detach().numpy().copy() for k, v in state.model.state_dict().items()}
    for k in ("means", "sigmas", "priors", "keep"):
        out[f"gmm.{k}"] = getattr(state.gmm, k).detach().numpy().copy()
    for k in ("feats", "length", "cursor", "updated"):
        out[f"memory.{k}"] = getattr(state.memory, k).numpy().copy()
    if state.proxies is not None:
        out["proxies"] = state.proxies.detach().numpy().copy()
    for name, opt in (("opt", state.opt), ("mean_opt", state.mean_opt)):
        for i, st in enumerate(opt.state.values()):
            for k, v in st.items():
                out[f"{name}.{i}.{k}"] = v.numpy().copy() if torch.is_tensor(v) else np.asarray(v)
    out["step"] = np.asarray(state.step)
    return out


def _assert_bit_equal(a, b):
    sa, sb = _state_arrays(a), _state_arrays(b)
    assert sa.keys() == sb.keys()
    bad = [k for k in sa if not np.array_equal(sa[k], sb[k])]
    assert not bad, bad


def test_async_steps_and_flush_match_jax():
    jcfg, _ = _configs()
    jtr = JaxTrainer(jcfg, steps_per_epoch=STEPS)
    assert jtr.async_bank is True
    jstate = _jax_start()
    ptr, pstate = _port()
    assert ptr.async_bank is True
    rounds = 0
    for i, (images, labels) in enumerate(_batches()):
        jstate, jm = jtr.train_step(jstate, images, labels, use_mine=True, update_gmm=True)
        pstate, pm = ptr.train_step(pstate, images, labels, use_mine=True, update_gmm=True)
        for name in ("loss", "cross_entropy", "mine", "aux", "accuracy", "full_mem_ratio"):
            np.testing.assert_allclose(float(getattr(pm, name)), float(getattr(jm, name)),
                                       atol=1e-4, err_msg=f"step {i} {name}")
        assert pm.em_active == int(jm.em_active), i
        assert pm.em_compact_fallback == int(jm.em_compact_fallback), i
        assert pm.nonfinite is False and not bool(jm.nonfinite)
        rounds += 3 * (pm.em_active > 0)
    assert (pm.em_active, float(pm.full_mem_ratio)) != (0, 0.0)  # a real bank, not the fill
    jstate, jflushed = jtr.flush_bank(jstate)
    pstate, pflushed = ptr.flush_bank(pstate)
    assert jflushed is not None and pflushed is not None
    aux, fm = pflushed
    assert aux.num_active == int(jflushed.num_active)
    assert aux.compact_fallback == int(jflushed.compact_fallback)
    np.testing.assert_allclose(float(fm), float(jflushed.full_mem_ratio), atol=1e-6)
    rounds += 3 * (aux.num_active > 0)
    assert pstate.step == int(jstate.step) == STEPS

    jstate = jax.device_get(jstate)
    for name in ("length", "cursor", "updated"):
        np.testing.assert_array_equal(getattr(pstate.memory, name).numpy(),
                                      np.asarray(getattr(jstate.memory, name)), err_msg=name)
    np.testing.assert_allclose(pstate.memory.feats.numpy(), np.asarray(jstate.memory.feats),
                               atol=1e-5)
    np.testing.assert_allclose(pstate.gmm.priors.numpy(), np.asarray(jstate.gmm.priors),
                               atol=1e-5)
    np.testing.assert_allclose(pstate.gmm.means.detach().numpy(), np.asarray(jstate.gmm.means),
                               atol=2 * rounds * 3e-3)
    # a second flush has nothing to do on either side
    assert ptr.flush_bank(pstate)[1] is None and jtr.flush_bank(jstate)[1] is None


def test_async_is_bit_equal_to_the_one_step_stale_oracle():
    ptr, pstate = _port()
    otr, ostate = _port(async_bank=False)
    batches = _batches()
    ostate, olosses = one_step_stale_oracle(otr, ostate, batches)
    losses = []
    for images, labels in batches:
        pstate, pm = ptr.train_step(pstate, images, labels, use_mine=True, update_gmm=True)
        losses.append(pm.loss)
    pstate, _ = ptr.flush_bank(pstate)
    for got, want in zip(losses, olosses):
        assert torch.equal(got, want)
    _assert_bit_equal(pstate, ostate)


def test_first_async_step_equals_the_first_sync_step():
    ptr, pstate = _port()
    str_, sstate = _port(async_bank=False)
    images, labels = _batches(1)[0]
    pstate, pm = ptr.train_step(pstate, images, labels, use_mine=True, update_gmm=True)
    sstate, sm = str_.train_step(sstate, images, labels, use_mine=True, update_gmm=True)
    for name in ("loss", "cross_entropy", "mine", "aux", "accuracy"):
        assert torch.equal(getattr(pm, name), getattr(sm, name)), name
    # the fill step reports no bank yet
    assert (pm.em_active, pm.em_compact_fallback, float(pm.full_mem_ratio)) == (0, 0, 0.0)
    for (k, a), b in zip(pstate.model.state_dict().items(), sstate.model.state_dict().values()):
        assert torch.equal(a, b), k
    # and once flushed, the bank too
    pstate, _ = ptr.flush_bank(pstate)
    _assert_bit_equal(pstate, sstate)


def test_async_staleness_is_exactly_one_step():
    """After two async steps (no flush) the mixture equals the sync run's
    after one step, bit for bit: the lag is one bank phase."""
    ptr, pstate = _port()
    str_, sstate = _port(async_bank=False)
    batches = _batches(2)
    sstate, _ = str_.train_step(sstate, *batches[0], use_mine=True, update_gmm=True)
    for images, labels in batches:
        pstate, _ = ptr.train_step(pstate, images, labels, use_mine=True, update_gmm=True)
    for k in ("means", "priors"):
        assert torch.equal(getattr(pstate.gmm, k), getattr(sstate.gmm, k)), k
    for k in ("feats", "length", "cursor", "updated"):
        assert torch.equal(getattr(pstate.memory, k), getattr(sstate.memory, k)), k


@pytest.mark.parametrize("flag", [False, None])
def test_async_off_is_bit_equal_to_the_synchronous_step(flag):
    """With `async_bank` False or None the step is the synchronous one:
    trunk, bank phase, then the optimizer gated on the bank's probe, as
    before the trunk/bank split (the oracle below is that step's body)."""
    tr, state = _port(async_bank=flag)
    assert tr.async_bank is False
    otr, ostate = _port(async_bank=False)
    for images, labels in _batches(3):
        state, m = tr.train_step(state, images, labels, use_mine=True, update_gmm=True)
        x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
        for p in otr.params(ostate):
            p.grad = None
        ostate.model.train()
        loss, (enq, *_rest) = otr._loss(ostate, x, y, True, ostate.gmm)
        loss.backward()
        sums = torch.stack([p.grad.sum() for p in otr.params(ostate) if p.grad is not None])
        finite = torch.isfinite(loss) & torch.isfinite(sums).all()
        step0 = ostate.step
        ostate.step += 1
        ostate.gmm, ostate.memory, _, ok = bank_update(
            ostate.gmm, ostate.memory, ostate.mean_opt, otr.em_cfg, *enq, step0, True, finite)
        assert ok
        ttrain.set_joint_lrs(otr.cfg, ostate, otr.steps_per_epoch)
        ostate.opt.step()
        ostate.joint_updates += 1
        assert torch.equal(m.loss, loss.detach())
    _assert_bit_equal(state, ostate)


class _Preempt:
    """A preemption flag that rises once `after` steps have been asked."""

    def __init__(self, after):
        self.after, self.n, self.reason = after, 0, "test"

    def requested(self):
        self.n += 1
        return self.n > self.after


def test_train_epoch_flushes_at_every_exit():
    """Each exit of `train_epoch` leaves nothing held and the bank current:
    the end of the epoch and a preemption (the state bit-equal to the
    one-step-stale oracle over the batches the epoch took), and the epoch
    maxima and sum carry the flushed bank phase. A divergence leaves the
    held phase for the next epoch's reset to discard."""
    batches = _batches(STEPS, seed=7)
    flags = {"warm": False, "use_mine": True, "update_gmm": True}  # the oracle's
    otr, ostate = _port(async_bank=False)
    ostate, _ = one_step_stale_oracle(otr, ostate, batches)
    sync_tr, s_sync = _port(async_bank=False)
    s_sync, last_sync = sync_tr.train_epoch(s_sync, iter(batches), 0, flags=flags)
    tr, st = _port()
    st, last = tr.train_epoch(st, iter(batches), 0, flags=flags)
    assert tr._held is None
    _assert_bit_equal(st, ostate)
    assert torch.equal(st.memory.length, s_sync.memory.length)
    # the epoch's maxima and sum carry the flushed bank phase
    assert last.em_active == last_sync.em_active
    assert last.em_compact_fallback == last_sync.em_compact_fallback
    assert float(last.full_mem_ratio) == float(last_sync.full_mem_ratio)

    # a preemption after the third step: that step finishes, then the flush
    tr, st = _port()
    guard = EpochGuard(max_bad_steps=0, preemption=_Preempt(after=2))
    st, _ = tr.train_epoch(st, iter(batches), 0, guard=guard, flags=flags)
    assert guard.preempted and guard.batches_done == 3 and tr._held is None
    otr, o3 = _port(async_bank=False)
    o3, _ = one_step_stale_oracle(otr, o3, batches[:3])
    _assert_bit_equal(st, o3)

    # a divergence: the held phase stays until the next epoch's reset
    tr, st = _port()
    poisoned = [(np.full_like(x, np.nan), y) for x, y in batches[:2]]
    guard = EpochGuard(max_bad_steps=1, check_every=1)
    with pytest.raises(DivergenceError):
        tr.train_epoch(st, iter(poisoned), 0, guard=guard)
    assert tr._held is not None
    tr.reset_bank_pipeline()
    assert tr._held is None


# ------------------------------------------------------- the schedule's drills
DRILL_STEPS = 20 // B  # 4 classes x 5 JPEGs, the train loader drops the tail


@pytest.fixture(scope="module")
def drill_start(tmp_path_factory):
    """A JPEG folder and a `start` checkpoint holding the pre-filled bank."""
    from _torch_jax_states import write_jpeg_tree
    from mgproto_tpu_torch.utils.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("async_drills")
    folder = write_jpeg_tree(str(root / "train"), 4, 5, seed=0)
    _, state = _port()
    start = save_checkpoint(str(root / "start"), state, "start",
                            metadata={"epoch": -1, "stage": "nopush"})
    return folder, start


def _drill_run(drill_start, model_dir, **kw):
    from mgproto_tpu_torch.cli.train import run_training
    from mgproto_tpu_torch.config import DataConfig, ScheduleConfig

    folder, start = drill_start
    _, cfg = _configs()
    cfg = cfg.replace(
        data=DataConfig(train_dir=folder, test_dir=folder, train_push_dir=folder,
                        train_batch_size=B, test_batch_size=B, train_push_batch_size=B,
                        num_workers=0),
        schedule=ScheduleConfig(num_train_epochs=2, mine_start=0, update_gmm_start=0,
                                push_start=100),
        model_dir=str(model_dir))
    kw.setdefault("resume", start)
    return run_training(cfg, device="cpu", render_push=False, **kw)


def test_the_schedule_drills_end_equal_to_the_clean_async_run(drill_start, tmp_path):
    """`run_training` on the async pipeline (the tiny trunk, 2 epochs of 3
    steps from a pre-filled bank): it logs and stores `async_bank`; a NaN
    step rolled back, and a preemption at epoch 0's last step resumed, both
    end bit-equal to the uninterrupted async run (phase 13's drills on the
    card, here on the CPU)."""
    from mgproto_tpu_torch.resilience import chaos, preemption
    from mgproto_tpu_torch.utils import checkpoint as tck

    clean, acc = _drill_run(drill_start, tmp_path / "clean")
    assert clean.step == 2 * DRILL_STEPS
    assert "async_bank: True" in open(tmp_path / "clean" / "train.log").read()
    meta = tck.load_metadata(tck.find_latest_checkpoint(str(tmp_path / "clean")))
    assert meta["async_bank"] is True

    nan = chaos.ChaosState(chaos.ChaosPlan(nan_at_step=DRILL_STEPS + 1))
    rolled, acc_n = _drill_run(drill_start, tmp_path / "nan", chaos=nan, max_bad_steps=1,
                               divergence_check_every=1, max_rollbacks=1)
    assert nan.injections == {"nan_loss": 1}
    _assert_bit_equal(rolled, clean)
    assert acc_n == acc

    pre = chaos.ChaosState(chaos.ChaosPlan(preempt_at_step=DRILL_STEPS - 1))
    try:
        _drill_run(drill_start, tmp_path / "pre", chaos=pre)
        assert preemption.get_handler().requested()
        resumed, acc_r = _drill_run(drill_start, tmp_path / "pre", resume="auto")
    finally:
        preemption.get_handler().reset()
    _assert_bit_equal(resumed, clean)
    assert acc_r == acc
