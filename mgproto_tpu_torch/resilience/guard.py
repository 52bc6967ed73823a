"""EpochGuard: the recovery policy of one training epoch (counterpart of
mgproto_tpu/resilience/guard.py).

  * Divergence: the step already skips a non-finite update
    (engine/train.py) and reports it in `TrainMetrics.nonfinite`, a host
    bool the step reads anyway. The guard counts the consecutive bad steps
    and looks at the streak every `check_every` steps and at the end of
    the epoch, as the JAX guard polls its device counter; a streak of
    `max_bad_steps` raises `DivergenceError`, which `cli/train.py`
    answers by restoring the last good checkpoint and replaying. It
    raises at the step the JAX guard raises at, for the same flags.
  * Preemption: after each step, the flag (a signal or the chaos drill)
    stops the epoch; the step in flight finishes first. Under several
    ranks (`multihost`) the flag is agreed across them after every step
    (`PreemptionHandler.requested_any_host`), so all stop after the same
    step; the divergence flags need no agreement, as every rank's step
    reads the same summed loss and gradients (parallel/trainer.py).
  * Chaos: `wrap_batches` applies the active `ChaosState` to the placed
    batches, keyed by the global step: the pod drills first (the targeted
    rank dies hard with HOST_KILL_EXIT_CODE, or hangs, before its batch
    reaches the step, so its peers meet the loss in their next collective
    or guarded barrier), then a simulated preemption, and NaN inputs
    (`ChaosState.corrupt_batch`).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from mgproto_tpu_torch.resilience.chaos import HOST_KILL_EXIT_CODE, ChaosState
from mgproto_tpu_torch.resilience.preemption import PreemptionHandler


class DivergenceError(RuntimeError):
    """K consecutive non-finite steps: the run should roll back."""

    def __init__(self, streak: int, step: int, epoch: int):
        super().__init__(
            f"{streak} consecutive non-finite train steps at step {step} "
            f"(epoch {epoch}); rolling back to the last good checkpoint")
        self.streak = streak
        self.step = step
        self.epoch = epoch


class EpochGuard:
    """One epoch's recovery policy (construct one per epoch).

    Args:
      max_bad_steps: consecutive non-finite steps before DivergenceError
        (0 disables the divergence policy; the skipped steps are still
        counted).
      check_every: the cadence (steps) of the streak poll.
      chaos: the active ChaosState or None.
      preemption: the PreemptionHandler (None disables preemption checks).
      already_done: batches of this epoch applied by a previous run (a
        mid-epoch resume), so `batches_done` is the position in the epoch.
      multihost: agree on the preemption flag across the ranks after each
        step (a collective: every rank's guard must have it).
    """

    def __init__(self, max_bad_steps: int = 3, check_every: int = 8,
                 chaos: Optional[ChaosState] = None,
                 preemption: Optional[PreemptionHandler] = None, already_done: int = 0,
                 multihost: bool = False):
        self.max_bad_steps = int(max_bad_steps)
        self.check_every = max(int(check_every), 1)
        self.chaos = chaos
        self.preemption = preemption
        self.already_done = int(already_done)
        self.multihost = multihost
        self.epoch = -1
        self.preempted = False
        self.bad_total = 0
        self._base_step = 0
        self._steps = 0
        self._streak = 0

    def begin_epoch(self, epoch: int, state) -> None:
        self.epoch = int(epoch)
        self._base_step = int(state.step)  # chaos events key on the global step
        self._steps = 0
        self._streak = 0
        self.bad_total = 0
        self.preempted = False

    @property
    def batches_done(self) -> int:
        """The position in the epoch (a preempt checkpoint's metadata)."""
        return self.already_done + self._steps

    def wrap_batches(self, batches):
        """The chaos drill on the stream of placed batches: the batch of
        global step s is drawn right before step s runs, so a preemption
        due at s lets step s finish and stops the epoch after it."""
        if self.chaos is None:
            return batches

        from mgproto_tpu_torch.parallel.mesh import world

        def _gen():
            for i, batch in enumerate(batches):
                step = self._base_step + i
                rank = world()[0]
                if self.chaos.host_kill_due(step, rank):
                    os._exit(HOST_KILL_EXIT_CODE)  # a crash, not a shutdown
                if self.chaos.host_wedge_due(step, rank):
                    while True:  # a stuck host: alive, silent, not stepping
                        time.sleep(3600)
                if self.chaos.preempt_due(step) and self.preemption is not None:
                    self.preemption.request("chaos preempt_at_step")
                yield self.chaos.corrupt_batch(step, batch)

        return _gen()

    def after_step(self, train_metrics) -> bool:
        """Observe one finished step; True = stop the epoch (preemption).
        Raises DivergenceError when the streak reaches the limit at a poll."""
        self._steps += 1
        bad = bool(train_metrics.nonfinite)
        self._streak = self._streak + 1 if bad else 0
        self.bad_total += int(bad)
        if self._steps % self.check_every == 0:
            # divergence first: a rollback anchors before a preemption
            # saves, and the flag survives the replay
            self._poll_streak()
        if self._check_preempt():
            self.preempted = True
            return True
        return False

    def end_epoch(self) -> int:
        """The final streak poll and preemption check; returns the skipped
        (non-finite) steps of the epoch."""
        if not self.preempted:
            self._poll_streak()
            if self._check_preempt():
                self.preempted = True
        return self.bad_total

    def _poll_streak(self) -> None:
        if self.max_bad_steps > 0 and self._streak >= self.max_bad_steps:
            raise DivergenceError(streak=self._streak, step=self._base_step + self._steps,
                                  epoch=self.epoch)

    def _check_preempt(self) -> bool:
        if self.preemption is None:
            return False
        if self.multihost:
            return self.preemption.requested_any_host()
        return self.preemption.requested()
