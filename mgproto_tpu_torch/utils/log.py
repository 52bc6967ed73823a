"""Run logs (the port's trimmed copy of mgproto_tpu/utils/log.py): a text log
echoed to stdout, a JSONL stream of scalars, and wall-clock spans that also
record a tracing span (telemetry/tracing.py), so a run with a telemetry
session gets its epoch / train / test / push spans in trace.json;
`profiler_trace`, the `--profile_dir` trace of a run's first epoch."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Any, Dict, Optional

from mgproto_tpu_torch.telemetry.tracing import trace_span


FLUSH_EVERY = 10


class _LineFile:
    """Append-only text file, flushed and fsynced every FLUSH_EVERY lines and
    on close. Writes after close are dropped."""

    def __init__(self, path: Optional[str]):
        self._f = open(path, "a") if path else None
        self._pending = 0

    def write(self, line: str) -> None:
        if self._f is None:
            return
        self._f.write(line + "\n")
        self._pending += 1
        if self._pending >= FLUSH_EVERY:
            self._sync()

    def _sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._pending = 0

    def close(self) -> None:
        if self._f is not None:
            self._sync()
            self._f.close()
            self._f = None


class Logger:
    """`log(message)`: print it and append it to `log_path` (train.log)."""

    def __init__(self, log_path: Optional[str]):
        self.path = log_path
        self._w = _LineFile(log_path)

    def log(self, message: str) -> None:
        print(message)
        sys.stdout.flush()
        self._w.write(message)

    __call__ = log

    def close(self) -> None:
        self._w.close()


class MetricsWriter:
    """One JSON object per `write(step, scalars)` (metrics.jsonl), stamped
    with the step and the wall time. Numbers become floats; strings, bools,
    None, lists and dicts pass as they are."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._w = _LineFile(path)

    def write(self, step: int, scalars: Dict[str, Any]) -> None:
        rec: Dict[str, Any] = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            if isinstance(v, (str, bool, type(None), dict, list, tuple)):
                rec[k] = v
            else:
                try:
                    rec[k] = float(v)
                except (TypeError, ValueError):
                    rec[k] = str(v)
        self._w.write(json.dumps(rec))

    def close(self) -> None:
        self._w.close()


@contextlib.contextmanager
def timed_span(logger: Logger, name: str):
    """Log `name`'s wall time on exit; the dict it yields receives the
    seconds under "s" (also when the body raises). The block is a span of
    the process-current tracer too."""
    span: Dict[str, float] = {}
    t0 = time.perf_counter()
    with trace_span(name):
        try:
            yield span
        finally:
            span["s"] = time.perf_counter() - t0
            logger.log(f"\t{name} time: \t{span['s']:.2f}s")


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str], device=None):
    """A torch.profiler trace of a block, written to
    `logdir/epoch.trace.json`; a no-op when `logdir` is falsy. The JAX
    package's `profiler_trace` (its `--profile_dir` trace of the first
    epoch). On the card the CPU and CUDA activities, and the trace must
    start and must hold device events (obs/profiler.py: no fallback); on
    the CPU, which a caller asks for by naming it, the CPU activity alone.
    On an exception in the block the profiler is stopped, nothing is
    written, and a stop failure never masks the block's exception."""
    if not logdir:
        yield
        return
    from mgproto_tpu_torch.obs.profiler import start_profiler, stop_profiler

    os.makedirs(logdir, exist_ok=True)
    prof = start_profiler(device)
    try:
        yield
    except BaseException:
        with contextlib.suppress(Exception):
            prof.stop()
        raise
    stop_profiler(prof, os.path.join(logdir, "epoch.trace.json"), device)
