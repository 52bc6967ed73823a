"""The port's test and OoD passes (mgproto_tpu_torch/engine/evaluate.py)
against the JAX package's, on the CPU.

A tiny JAX state trained three steps (tests/_torch_jax_states.py) is carried
into the port with `from_jax_train_state`; both packages evaluate it on the
same seeded batches: three labelled test batches, the last with a label -1
pad row (a zero image, as the loader pads), and one OoD set of bare image
batches.

Tolerances:
  * per-sample log p(x) and the class log-likelihood matrix: atol 1e-4
    (XLA's and ATen's CPU convolutions sum in different orders); CE atol
    1e-4; accuracy equal; `p_avg_pair_dist` rtol 1e-6.
  * `ood_thresh`: rtol 1e-4 in exp space ("sum"), atol 1e-4 in log space
    ("max", "paper").
  * FPR and AUROC equal, except that a sample whose score lies within 1e-4
    of the threshold (FPR), or an (ID, OoD) pair whose scores lie within
    1e-4 of each other (AUROC), may count either way: the test counts such
    samples and pairs on the port's scores and allows one sample's (1/N) or
    one pair's weight for each.
  * `binary_auroc`, `_logsumexp` and `ood_score_variants` on identical
    numpy inputs: exactly equal.
  * a test pass between two train steps leaves the second step bit-identical.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from _torch_jax_states import (
    B,
    NEAR,
    auroc_allowance,
    images,
    port_state,
    trained_jax_state,
)
from mgproto_tpu.trust.auroc import binary_auroc as jax_binary_auroc
from mgproto_tpu_torch.engine import evaluate as tev
from mgproto_tpu_torch.trust.auroc import binary_auroc

# the JAX package's engine/__init__ re-exports the function under the
# module's name
jev = importlib.import_module("mgproto_tpu.engine.evaluate")
LABELS = ([0, 1, 2, 3, 0, 1], [2, 3, 0, 1, 2, 3], [1, 2, 3, 0, 1, -1])


def _test_batches():
    out = []
    for i, labels in enumerate(LABELS):
        x = images(30 + i)
        labels = np.asarray(labels, np.int32)
        x[labels < 0] = 0.0  # the loader's pad row
        out.append((x, labels))
    return out


def _ood_batches():
    return [images(40 + i) * 2.0 + 1.0 for i in range(2)]


@functools.lru_cache(maxsize=None)
def _states():
    jtrainer, jstate = trained_jax_state()
    return jtrainer, jstate


def _port():
    _, jstate = _states()
    return port_state(jstate)


def _quiet(*_):
    pass


def test_run_eval_matches_jax_and_drops_pad_rows():
    jtrainer, jstate = _states()
    ptrainer, pstate = _port()
    jout = jev._run_eval(jtrainer, jstate, _test_batches())
    pout = tev._run_eval(ptrainer, pstate, _test_batches())
    n = sum(len(lb) for lb in LABELS) - 1
    assert pout[0].shape == (n,) and pout[4].shape == (n, 4)
    np.testing.assert_allclose(pout[0], jout[0], atol=1e-4)  # log p(x)
    np.testing.assert_array_equal(pout[1], jout[1])  # correct
    np.testing.assert_allclose(pout[2], jout[2], atol=1e-4)  # summed CE
    assert pout[3] == jout[3] == len(LABELS)
    np.testing.assert_allclose(pout[4], jout[4], atol=1e-4)  # class log-likelihoods
    bare = tev._run_eval(ptrainer, pstate, _ood_batches())
    assert bare[0].shape == (2 * B,) and bare[2] == 0.0 and bare[3] == 0


def test_evaluate_matches_jax():
    jtrainer, jstate = _states()
    ptrainer, pstate = _port()
    jacc, jres = jev.evaluate(jtrainer, jstate, _test_batches(), log=_quiet)
    pacc, pres = tev.evaluate(ptrainer, pstate, _test_batches(), log=_quiet)
    assert pacc == jacc == pres["acc"]
    np.testing.assert_allclose(pres["cross_entropy"], jres["cross_entropy"], atol=1e-4)
    np.testing.assert_allclose(pres["p_avg_pair_dist"], jres["p_avg_pair_dist"], rtol=1e-6)


@pytest.mark.parametrize("rule", ["sum", "max", "paper"])
def test_evaluate_with_ood_matches_jax(rule):
    jtrainer, jstate = _states()
    ptrainer, pstate = _port()
    jacc, jres = jev.evaluate_with_ood(jtrainer, jstate, _test_batches(), [_ood_batches()],
                                       score_rule=rule, log=_quiet)
    pacc, pres = tev.evaluate_with_ood(ptrainer, pstate, _test_batches(), [_ood_batches()],
                                       score_rule=rule, log=_quiet)
    assert pacc == jacc and pres["score_rule"] == rule
    if rule == "sum":
        np.testing.assert_allclose(pres["ood_thresh"], jres["ood_thresh"], rtol=1e-4)
    else:
        np.testing.assert_allclose(pres["ood_thresh"], jres["ood_thresh"], atol=1e-4)

    # the port's scores, to find the samples that may count either way
    id_lp, _, _, _, id_logits = tev._run_eval(ptrainer, pstate, _test_batches())
    ood_lp, _, _, _, ood_logits = tev._run_eval(ptrainer, pstate, _ood_batches())
    c = pstate.gmm.num_classes
    if rule == "sum":
        ood_log_score, log_thresh = ood_lp - np.log(c), np.log(pres["ood_thresh"])
    elif rule == "paper":
        ood_log_score, log_thresh = ood_lp, pres["ood_thresh"]
    else:
        ood_log_score, log_thresh = ood_logits.max(-1), pres["ood_thresh"]
    near_thresh = int((np.abs(ood_log_score - log_thresh) <= NEAR).sum())
    assert abs(pres["FPR95_1"] - jres["FPR95_1"]) <= near_thresh / len(ood_lp) + 1e-12
    assert abs(pres["AUROC_1"] - jres["AUROC_1"]) <= auroc_allowance(id_lp, ood_lp) + 1e-12
    variants = {"sum": tev._logsumexp, "max": lambda L: L.max(-1)}
    for t in (0.5, 2.0, 5.0):
        variants[f"temp_{t:g}"] = lambda L, t=t: t * tev._logsumexp(L / t)
    for name, fn in variants.items():
        allow = auroc_allowance(fn(id_logits), fn(ood_logits)) + 1e-6  # rounded to 6 digits
        got, want = pres["score_variants_1"][name], jres["score_variants_1"][name]
        assert abs(got - want) <= allow, name


def test_score_rule_is_checked():
    ptrainer, pstate = _port()
    with pytest.raises(ValueError, match="score_rule"):
        tev.evaluate_with_ood(ptrainer, pstate, [], [], score_rule="mean", log=_quiet)


@pytest.mark.parametrize("case", ["random", "ties", "empty"])
def test_host_scoring_is_the_jax_packages(case):
    rng = np.random.default_rng(7)
    if case == "random":
        id_l, ood_l = rng.normal(size=(9, 4)) * 5, rng.normal(size=(7, 4)) * 5 - 1
    elif case == "ties":
        id_l = np.round(rng.normal(size=(9, 4)), 1)
        ood_l = np.concatenate([id_l[:3], np.round(rng.normal(size=(4, 4)), 1)])
    else:
        id_l, ood_l = rng.normal(size=(5, 4)), np.zeros((0, 4))
    pos, neg = id_l[:, 0], ood_l[:, 0]
    got, want = binary_auroc(pos, neg), jax_binary_auroc(pos, neg)
    assert got == want or (np.isnan(got) and np.isnan(want))
    np.testing.assert_array_equal(tev._logsumexp(id_l), jev._logsumexp(id_l))
    if ood_l.size:
        assert tev.ood_score_variants(id_l, ood_l) == jev.ood_score_variants(id_l, ood_l)


def test_a_test_pass_between_train_steps_changes_nothing():
    """Two carried copies of one state: step, test pass, step against step,
    step. The second steps agree bit for bit, and the model is back in
    train mode after the pass, also after a pass that raised."""
    _, jstate = _states()
    x1, x2 = images(50), images(51)
    l1, l2 = np.array([0, 1, 2, 3, 0, 1], np.int32), np.array([3, 2, 1, 0, 3, 2], np.int32)
    runs = []
    for with_test in (True, False):
        trainer, state = port_state(jstate)
        trainer.train_step(state, x1, l1, use_mine=True, update_gmm=True)
        if with_test:
            tev.evaluate(trainer, state, _test_batches(), log=_quiet)
            assert state.model.training
            with pytest.raises(RuntimeError):
                trainer.eval_step(state, np.zeros((2, 7, 3), np.float32))
            assert state.model.training
        _, met = trainer.train_step(state, x2, l2, use_mine=True, update_gmm=True)
        runs.append((met, state))
    (m_a, s_a), (m_b, s_b) = runs
    assert m_a.loss.item() == m_b.loss.item()
    for (name, a), b in zip(s_a.model.state_dict().items(), s_b.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(s_a.gmm.means.detach(), s_b.gmm.means.detach())
    assert torch.equal(s_a.memory.feats, s_b.memory.feats)
    assert str(s_a.opt.state_dict()) == str(s_b.opt.state_dict())
