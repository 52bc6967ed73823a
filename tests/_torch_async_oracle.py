"""The async bank pipeline's schedule built from the synchronous trainer's
own functions (no pipeline code, one stream): trunk n scores the means as
of bank n-2, bank n-1 runs after trunk n, the last bank after the loop.
Shared by tests/test_torch_async_bank.py (CPU) and tests/test_torch_cuda.py
(the card); imports no JAX."""

from mgproto_tpu_torch.core.em import bank_update


def one_step_stale_oracle(trainer, state, batches):
    """Run `batches` ((images, labels) host arrays) on the one-step-stale
    schedule; returns (state, the trunk losses)."""
    stale = state.gmm._replace(means=state.gmm.means.detach().clone())
    pending, losses = None, []
    for images, labels in batches:
        b = trainer._claim(trainer.put_batch((images, labels)))
        trunk = trainer._trunk_step(state, b.images, b.labels, True, stale)
        step0 = state.step
        state.step += 1
        if pending is not None:
            state.gmm, state.memory, _, _ = bank_update(
                state.gmm, state.memory, state.mean_opt, trainer.em_cfg, *pending)
        stale = state.gmm._replace(means=state.gmm.means.detach().clone())
        pending = (*trunk.enq, step0, True, trunk.finite)
        trainer._apply_trunk(state, trunk, bool(trunk.finite), False)
        losses.append(trunk.loss.detach().clone())
    state.gmm, state.memory, _, _ = bank_update(
        state.gmm, state.memory, state.mean_opt, trainer.em_cfg, *pending)
    return state, losses
