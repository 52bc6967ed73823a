"""Preemption: a signal flag, the marker file, and the graceful stop
(counterpart of mgproto_tpu/resilience/preemption.py, single process).

A scheduler that preempts a machine sends SIGTERM and allows a short grace
window. The handler only SETS A FLAG; the training loop
(`resilience.guard.EpochGuard` inside `Trainer.train_epoch`) checks it
after each step, lets the in-flight step finish, and `cli/train.py`
checkpoints the whole state with its position in the epoch, writes the
marker and returns, so the next run with `resume="auto"` continues bit for
bit.

Signal handlers are installed only by `install_handlers()`, which the CLI's
`main` calls after parsing its arguments, never at import: a library
import that took over SIGINT would break every embedding program's Ctrl-C.
The chaos drill raises the same flag (`PreemptionHandler.request`), so a
simulated preemption takes the path a real SIGTERM takes.

Under several ranks (parallel/) a signal reaches one of them, but every
rank must stop after the same step, or the next collective waits forever:
`requested_any_host` agrees on the flag across the ranks, and the guard
asks it after every step.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Optional

MARKER_FILE = "PREEMPTED.json"


class PreemptionHandler:
    """The process's preemption flag (thread- and signal-safe)."""

    def __init__(self):
        self._event = threading.Event()
        self.reason: Optional[str] = None

    def request(self, reason: str = "requested") -> None:
        # the reason first: a checker that sees the flag must see why
        self.reason = reason
        self._event.set()

    def requested(self) -> bool:
        return self._event.is_set()

    def requested_any_host(self) -> bool:
        """True when ANY rank has the flag. A collective: every rank calls
        it at the same point; the local flag in one process."""
        from mgproto_tpu_torch.parallel.multihost import any_across_hosts

        return any_across_hosts(self.requested())

    def reset(self) -> None:
        """Clear the flag (each run_training call starts clean)."""
        self._event.clear()
        self.reason = None


_HANDLER = PreemptionHandler()


def get_handler() -> PreemptionHandler:
    return _HANDLER


def install_handlers(signums=(signal.SIGTERM, signal.SIGINT), handler=None):
    """Install the graceful-preemption signal handlers.

    First signal: set the flag, so training checkpoints and exits cleanly.
    A second signal of the same kind restores the previous disposition and
    raises it again, so a stuck run can still be killed from a terminal.

    Returns an `uninstall()` callable that restores the previous handlers."""
    h = handler if handler is not None else _HANDLER
    previous = {}

    def _on_signal(signum, frame):
        if h.requested():  # second signal: give the process back to the user
            prev = previous.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev if callable(prev) or prev in (
                signal.SIG_DFL, signal.SIG_IGN) else signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        h.request(f"signal {signal.Signals(signum).name}")

    for signum in signums:
        previous[signum] = signal.signal(signum, _on_signal)

    def uninstall():
        for signum, prev in previous.items():
            signal.signal(signum, prev)

    return uninstall


def marker_path(model_dir: str) -> str:
    return os.path.join(model_dir, MARKER_FILE)


def write_marker(model_dir: str, checkpoint_path: str, reason: str = "",
                 extra: Optional[dict] = None) -> str:
    """Record that the run stopped on a preemption and where to resume
    from; a completed resume clears it."""
    path = marker_path(model_dir)
    payload = {"checkpoint": os.path.abspath(checkpoint_path), "reason": reason,
               "time": time.time()}
    if extra:
        payload.update(extra)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def read_marker(model_dir: str) -> Optional[dict]:
    path = marker_path(model_dir)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def clear_marker(model_dir: str) -> None:
    try:
        os.unlink(marker_path(model_dir))
    except FileNotFoundError:
        pass
