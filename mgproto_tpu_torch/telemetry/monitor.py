"""StepMonitor: per-step runtime instrumentation around step calls
(counterpart of mgproto_tpu/telemetry/monitor.py; imports no torch).

Records into the metric registry, per observed step, under the JAX
package's names:

  * `step_time_seconds` histogram + `step_time_ema_seconds` gauge: host
    wall time per step. `Trainer.train_epoch` measures each step from the
    end of the previous one to the end of this one, after the one device
    read the step already makes (the bank update's gate; in async mode the
    trunk's finiteness), so the intervals sum to the epoch's wall time and
    the monitor adds no synchronization of its own.
  * `images_per_sec` gauge (from the EMA) + `images_total` / `steps_total`
    counters.
  * `jit_recompiles_total` counter + `jit_cache_size` gauge: the port's
    cold paths, read from watched counts (`watch`). The port compiles no
    program; what JAX counts as a compile is, here, a component's first
    dispatch at an input shape or bucket (cuDNN's first-call heuristics,
    allocator growth) and a kernel library built after the first step
    (ops/_build.py `builds`): `ColdPaths` counts both for the trainer, the
    serving engine counts its warmed buckets and its dispatches at an
    unwarmed one, the consolidator its first batch and its steady
    recompiles. As in JAX the first of each counts, so a steady run shows
    exactly its number of shapes and any later growth is a cold path.
  * `host_transfer_bytes_total` counter: host-to-device bytes of the
    step's operands (`Trainer.put_batch`'s count; the uint8 wire shows as
    a ~4x drop).
  * `loader_wait_fraction` gauge: the share of the epoch's wall time the
    step loop spent blocked fetching the next batch.
  * `bank_dispatch_overlap_fraction` gauge: the share of the epoch's wall
    time a dispatched async bank phase was in flight beside trunk work,
    from JAX's host dispatch clock (`Trainer.bank_overlap_step_s`: from
    one held bank dispatch to the end of the next trunk's dispatch, an
    upper bound on the device overlap); 0 in sync mode.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from mgproto_tpu_torch.telemetry.registry import MetricRegistry, default_registry


def kernel_builds() -> int:
    """Kernel libraries this process built with nvcc (ops/_build.py
    `builds`): 0 until a kernel wrapper has been imported."""
    import sys

    mod = sys.modules.get("mgproto_tpu_torch.ops._build")
    return 0 if mod is None else int(mod.builds)


class ColdPaths:
    """A component's cumulative cold paths: each input shape the first time
    `note` meets it, plus the kernel libraries built after the first
    `note` (the first dispatch builds or loads what it needs). `total` is
    what a StepMonitor watches."""

    def __init__(self):
        self._shapes: set = set()
        self._builds0: Optional[int] = None

    def note(self, shape) -> None:
        """After a dispatch at `shape` (host-side, no device work)."""
        self._shapes.add(tuple(shape))
        if self._builds0 is None:
            self._builds0 = kernel_builds()

    @property
    def shapes(self) -> int:
        return len(self._shapes)

    def total(self) -> int:
        builds = 0 if self._builds0 is None else kernel_builds() - self._builds0
        return len(self._shapes) + builds


class StepMonitor:
    """Observes steps the caller has timed: `observe_step(n_images,
    seconds, ...)`."""

    def __init__(
        self,
        registry: Optional[MetricRegistry] = None,
        ema_alpha: float = 0.1,
        phase: str = "train",
    ):
        self.registry = registry if registry is not None else default_registry()
        self.ema_alpha = float(ema_alpha)
        self.phase = phase
        self._watched: List[Callable[[], int]] = []
        self._last: dict = {}
        self._ema: Optional[float] = None
        self._epoch_images = 0
        self._epoch_seconds = 0.0
        r = self.registry
        self._h_step = r.histogram("step_time_seconds", "per-step host wall time")
        self._g_ema = r.gauge("step_time_ema_seconds", "EMA of per-step wall time")
        self._g_ips = r.gauge(
            "images_per_sec", "instantaneous throughput (from the step EMA)"
        )
        self._c_steps = r.counter("steps_total", "steps observed")
        self._c_images = r.counter("images_total", "images processed")
        self._c_recompiles = r.counter(
            "jit_recompiles_total",
            "jit cache misses on watched step functions (first compiles "
            "included)",
        )
        self._g_cache = r.gauge(
            "jit_cache_size", "total compiled variants across watched jits"
        )
        self._c_transfer = r.counter(
            "host_transfer_bytes_total", "host->device bytes for step operands"
        )
        self._epoch_wait = 0.0
        self._g_wait_frac = r.gauge(
            "loader_wait_fraction",
            "fraction of epoch wall time the step loop spent blocked on "
            "the input pipeline (batch fetch wait / step time, cumulative "
            "over the epoch)",
        )
        self._g_wait_frac.set(0.0, phase=phase)
        self._epoch_bank_overlap = 0.0
        self._g_bank_overlap = r.gauge(
            "bank_dispatch_overlap_fraction",
            "fraction of epoch wall time the async bank program overlapped "
            "trunk compute (host dispatch-clock estimate; 0 in sync mode)",
        )
        self._g_bank_overlap.set(0.0, phase=phase)

    # ------------------------------------------------------------ cold paths
    def watch(self, *counts: Callable[[], int]) -> "StepMonitor":
        """Watch zero-arg callables that return a cumulative cold-path count
        (module docstring); `check_recompiles` adds their growth."""
        self._watched.extend(counts)
        return self

    def check_recompiles(self) -> int:
        """Growth of the watched counts since the last check; increments
        `jit_recompiles_total` and returns it."""
        new = total = 0
        for fn in self._watched:
            size = int(fn())
            total += size
            prev = self._last.get(id(fn), 0)
            if size > prev:
                new += size - prev
            self._last[id(fn)] = size
        self._g_cache.set(total, phase=self.phase)
        if new:
            self._c_recompiles.inc(new, phase=self.phase)
        return new

    @property
    def recompile_count(self) -> int:
        return int(self._c_recompiles.value(phase=self.phase))

    # ------------------------------------------------------------------ steps
    def observe_step(
        self,
        n_images: int,
        seconds: float,
        transfer_bytes: int = 0,
        check_recompiles: bool = True,
        wait_seconds: float = 0.0,
        bank_overlap_seconds: float = 0.0,
    ) -> None:
        ph = self.phase
        self._h_step.observe(seconds, phase=ph)
        self._ema = (
            seconds
            if self._ema is None
            else self.ema_alpha * seconds + (1 - self.ema_alpha) * self._ema
        )
        self._g_ema.set(self._ema, phase=ph)
        if self._ema > 0:
            self._g_ips.set(n_images / self._ema, phase=ph)
        self._c_steps.inc(1, phase=ph)
        self._c_images.inc(n_images, phase=ph)
        if transfer_bytes:
            self._c_transfer.inc(transfer_bytes, phase=ph)
        self._epoch_images += int(n_images)
        self._epoch_seconds += float(seconds)
        self._epoch_wait += float(wait_seconds)
        if self._epoch_seconds > 0:
            self._g_wait_frac.set(
                min(1.0, self._epoch_wait / self._epoch_seconds), phase=ph
            )
        self._epoch_bank_overlap += float(bank_overlap_seconds)
        if self._epoch_seconds > 0:
            self._g_bank_overlap.set(
                min(1.0, self._epoch_bank_overlap / self._epoch_seconds), phase=ph
            )
        if check_recompiles:
            self.check_recompiles()

    @property
    def ema_seconds(self) -> Optional[float]:
        return self._ema

    # ------------------------------------------------------------------ epoch
    def begin_epoch(self) -> None:
        self._epoch_images = 0
        self._epoch_seconds = 0.0
        self._epoch_wait = 0.0
        self._epoch_bank_overlap = 0.0

    @property
    def epoch_images(self) -> int:
        return self._epoch_images

    @property
    def epoch_seconds(self) -> float:
        return self._epoch_seconds
