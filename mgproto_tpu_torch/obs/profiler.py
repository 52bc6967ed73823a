"""Programmatic profiler windows: capture the trace when it matters
(counterpart of mgproto_tpu/obs/profiler.py).

`ProfilerWindow` opens a `torch.profiler` capture either

  * for a CONFIGURED STEP RANGE (`--profile_steps A:B`), or
  * AUTOMATICALLY when a trigger fires (`--profile_on_anomaly`):
      - step-time spike: a step slower than `spike_factor` x the window's
        own EMA (after `min_steps` of settling),
      - recompile: the watched StepMonitor's `jit_recompiles_total` grew
        mid-run (the port's cold paths: a new batch shape, a kernel library
        built late; telemetry/monitor.py),
      - loader-wait: the step blocked on the input pipeline for more than
        `wait_fraction` of its wall time.

A step-range capture is ONE window spanning the whole range (a bare step
captures one step); anomaly captures each run `capture_steps` steps. Every
capture writes one directory under `out_dir` (`trace_<reason>_step<N>/`)
with at most `max_captures` anomaly captures per run and a
`cooldown_steps` refractory period, as in JAX.

ON THE CARD a capture is a real trace: `arm` starts `torch.profiler` with
the CPU and CUDA activities (after a synchronize, so the window holds its
own steps' kernels), `disarm` synchronizes before it stops (so none is cut
off) and exports `trace_<reason>.trace.json` (what `obs/stall.py`
`load_chrome_trace` finds) beside `capture_meta.json`. There is no
fallback there: a window that cannot start the profiler raises, as does a
capture that recorded no device event. Only one profiler runs in a
process: a window asked to arm while another is active raises
(`ProfilerError`); windows do not nest. A caller that holds a profiler
of its own open over some steps (`cli.train --profile_dir`, the trace of
the first epoch) says so with `ProfilerWindow.held`: a capture that falls
due inside it is skipped, logged once and recorded, and training goes on.

ON THE CPU, which a caller asks for by naming the device (the tests do),
a capture takes JAX's cost-only path: the `cost_provider` (obs/stall.py
`step_costs`, one counted step of the production program) runs once and
its report is written as `cost_analysis.json` beside the meta. It is never
a stand-in for a trace on the card.

Every arm and disarm is recorded on the flight recorder. Imports torch
only where a capture starts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, List, Optional, Tuple

from mgproto_tpu_torch.obs.flightrec import record_event

META_FILE = "capture_meta.json"
COST_FILE = "cost_analysis.json"


class ProfilerError(RuntimeError):
    """A capture on the card that could not be taken: the profiler would
    not start, another one is active, or it recorded no device event."""


def parse_step_range(raw: str) -> Optional[Tuple[int, int]]:
    """'120:130' -> (120, 130); '' -> None. A bare 'N' captures one step."""
    raw = (raw or "").strip()
    if not raw:
        return None
    start, sep, end = raw.partition(":")
    a = int(start)
    b = int(end) if sep and end else a + 1
    if b <= a:
        raise ValueError(f"empty profile step range {raw!r}")
    return a, b


def device_type(device) -> str:
    """'cuda' for None (the port's entry-point rule) or a CUDA device,
    else the device's type."""
    return "cuda" if device is None else str(device).split(":", 1)[0]


def trace_supported(device=None) -> bool:
    """A device trace is taken on CUDA; the CPU takes the cost-only path."""
    return device_type(device) == "cuda"


def start_profiler(device=None):
    """A started `torch.profiler.profile` for `device`'s activities (CPU
    and CUDA on the card, CPU alone on the CPU). Raises ProfilerError when
    another profiler is active or this one does not start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.autograd._profiler_enabled():
        raise ProfilerError("another profiler is active in this process; profiler "
                            "windows do not nest")
    cuda = trace_supported(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    try:
        if cuda:
            torch.cuda.synchronize()  # the window holds its own steps' kernels
        prof.start()
    except Exception as e:  # no CUDA, a missing CUPTI, a second session, ...
        raise ProfilerError(f"torch.profiler did not start on {device_type(device)}: "
                            f"{type(e).__name__}: {e}") from e
    return prof


def stop_profiler(prof, path: str, device=None) -> dict:
    """Stop `prof` (after a synchronize on the card) and export its Chrome
    trace to `path`; returns {"device_events", "trace_bytes", "export_s"}.
    On the card a trace without a device event raises ProfilerError."""
    import torch

    from mgproto_tpu_torch.obs.stall import device_events

    cuda = trace_supported(device)
    if cuda:
        torch.cuda.synchronize()
    prof.stop()
    t0 = time.perf_counter()
    prof.export_chrome_trace(path)
    export_s = time.perf_counter() - t0
    with open(path) as f:
        data = json.load(f)
    n = len(device_events(data.get("traceEvents", []) if isinstance(data, dict) else data))
    if cuda and n == 0:
        raise ProfilerError(f"the capture {path} recorded no device event")
    return {"device_events": n, "trace_bytes": os.path.getsize(path), "export_s": export_s}


@dataclasses.dataclass(frozen=True)
class Triggers:
    """Anomaly-trigger knobs (see module docstring)."""

    spike_factor: float = 3.0
    min_steps: int = 20  # EMA settle time before the spike trigger arms
    wait_fraction: float = 0.5
    recompile: bool = True
    ema_alpha: float = 0.1


class ProfilerWindow:
    """Step-driven capture controller; `on_step` is the only per-step hook
    (engine/train.py calls it after each step). `device`: the run's device,
    CUDA unless the caller names another (module docstring)."""

    def __init__(
        self,
        out_dir: str,
        steps: Optional[Tuple[int, int]] = None,
        on_anomaly: bool = False,
        triggers: Optional[Triggers] = None,
        capture_steps: int = 3,
        max_captures: int = 2,
        cooldown_steps: int = 50,
        monitor=None,
        cost_provider: Optional[Callable[[], dict]] = None,
        log: Optional[Callable[[str], None]] = None,
        device=None,
    ):
        kind = device_type(device)
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"a profiler window runs on cuda or cpu, not {device}")
        self.out_dir = out_dir
        self.steps = steps
        self.on_anomaly = bool(on_anomaly)
        self.triggers = triggers if triggers is not None else Triggers()
        self.capture_steps = max(int(capture_steps), 1)
        self.max_captures = max(int(max_captures), 1)
        self.cooldown_steps = max(int(cooldown_steps), 0)
        self.monitor = monitor
        self.cost_provider = cost_provider
        self.log = log
        self.device = device
        self.captures: List[dict] = []  # {dir, reason, step, fallback, ...}
        self._step = 0  # steps observed by THIS window (this invocation)
        self._ema: Optional[float] = None
        self._armed_reason: Optional[str] = None
        self._armed_at = 0
        self._prof = None  # the live torch.profiler session on the card
        self._cooldown_until = -1
        self._held: Optional[str] = None  # why no capture may open now
        self.skipped: List[dict] = []  # {reason, step, held}: captures held off
        self._last_recompiles = (
            monitor.recompile_count if monitor is not None else 0
        )

    # ------------------------------------------------------------------ state
    @property
    def armed(self) -> bool:
        return self._armed_reason is not None

    @property
    def steps_observed(self) -> int:
        return self._step

    # ------------------------------------------------------------------- hook
    def on_step(self, seconds: float, wait_fraction: float = 0.0) -> None:
        """Observe one completed step; decides arm/disarm. `seconds` is the
        step's host wall time, `wait_fraction` the loader-blocked share of
        it. Step indices count THIS window's observations (a resumed run
        restarts at 0)."""
        step = self._step
        self._step += 1

        if self.armed:
            # an explicit step range is ONE window: it stays open until the
            # range ends; anomaly windows run capture_steps steps
            if self._armed_reason == "steps":
                if self.steps is None or step >= self.steps[1]:
                    self.disarm()
            elif step - self._armed_at + 1 >= self.capture_steps:
                self.disarm()
            return

        reason = self._due(step, seconds, wait_fraction)
        # EMA updates AFTER the spike check so the spike that arms the
        # window does not immediately poison its own baseline
        a = self.triggers.ema_alpha
        self._ema = (
            seconds if self._ema is None
            else a * seconds + (1 - a) * self._ema
        )
        if reason is None:
            return
        if self._held is not None:
            self._skip(reason)
        else:
            self.arm(reason)

    @contextlib.contextmanager
    def held(self, why: str):
        """No capture opens inside the block: another profiler owns the
        process (`why` says which). A capture that falls due is skipped
        instead of raising; on every device, so the CPU decides as the
        card does."""
        self._held = why
        try:
            yield
        finally:
            self._held = None

    def _skip(self, reason: str) -> None:
        first = not any(s["held"] == self._held for s in self.skipped)
        self.skipped.append({"reason": reason, "step": self._step, "held": self._held})
        record_event("profiler_skip", reason=reason, step=self._step, held=self._held)
        if self.log and first:
            self.log(f"profiler: {reason} capture at step {self._step} skipped while "
                     f"{self._held} (captures due in it are skipped)")

    def _due(
        self, step: int, seconds: float, wait_fraction: float
    ) -> Optional[str]:
        if self.steps is not None and self.steps[0] <= step < self.steps[1]:
            return "steps"
        if not self.on_anomaly:
            return None
        if len(self.captures) >= self.max_captures:
            return None
        if step < self._cooldown_until:
            return None
        t = self.triggers
        if t.recompile and self.monitor is not None:
            count = self.monitor.recompile_count
            if count > self._last_recompiles:
                self._last_recompiles = count
                return "recompile"
            self._last_recompiles = count
        if (
            self._ema is not None
            and step >= t.min_steps
            and seconds > t.spike_factor * self._ema
        ):
            return "spike"
        if wait_fraction >= t.wait_fraction and step >= t.min_steps:
            return "loader_wait"
        return None

    # ----------------------------------------------------------- arm / disarm
    def arm(self, reason: str) -> str:
        """Open a capture window NOW (also the public entry for one-shot
        captures, e.g. serve warmup). Returns the capture directory."""
        if self.armed:
            return self.captures[-1]["dir"]
        path = os.path.join(self.out_dir, f"trace_{reason}_step{self._step:06d}")
        os.makedirs(path, exist_ok=True)
        fallback = not trace_supported(self.device)
        if not fallback:
            self._prof = start_profiler(self.device)  # raises: no fallback on the card
        self._armed_reason = reason
        self._armed_at = self._step
        capture = {"dir": path, "reason": reason, "step": self._step, "fallback": fallback}
        self.captures.append(capture)
        record_event("profiler_arm", reason=reason, step=self._step, dir=path,
                     fallback=fallback)
        if self.log:
            self.log(f"profiler: armed ({reason}) at step {self._step} -> {path}")
        self._write_meta(capture)
        if fallback:
            self._write_cost_analysis(capture)
        return path

    def disarm(self) -> None:
        """Close the open window (stop and export the device trace if one
        is live)."""
        if not self.armed:
            return
        reason = self._armed_reason
        self._armed_reason = None
        self._cooldown_until = self._step + self.cooldown_steps
        capture = self.captures[-1]
        capture["steps"] = self._step - self._armed_at
        if self._prof is not None:
            prof, self._prof = self._prof, None
            t0 = time.perf_counter()
            path = os.path.join(capture["dir"], f"trace_{reason}.trace.json")
            capture.update(stop_profiler(prof, path, self.device), trace=path)
            capture["capture_s"] = time.perf_counter() - t0
            self._write_meta(capture)
        record_event("profiler_disarm", reason=reason, step=self._step)
        if self.log:
            self.log(f"profiler: capture closed at step {self._step}")

    def close(self) -> None:
        """End-of-run safety: never leave a device trace open."""
        self.disarm()

    # --------------------------------------------------------------- files
    def _write_meta(self, capture: dict) -> None:
        meta = {
            "profiler_capture": True,
            "reason": capture["reason"],
            "step": capture["step"],
            "backend": device_type(self.device),
            "fallback": capture["fallback"],
            "capture_steps": self.capture_steps,
            "wall_time": time.time(),
        }
        for k in ("steps", "device_events", "trace_bytes", "capture_s"):
            if k in capture:
                meta[k] = capture[k]
        if not capture["fallback"]:
            import torch

            meta["device_name"] = torch.cuda.get_device_name()
        with open(os.path.join(capture["dir"], META_FILE), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)

    def _write_cost_analysis(self, capture: dict) -> None:
        """The CPU's capture: one counted cost report of the production
        program, so the capture still feeds trace_report's roofline."""
        if self.cost_provider is None:
            return
        try:
            costs = self.cost_provider()
        except Exception as e:
            costs = {"error": f"{type(e).__name__}: {e}"}
            if self.log:
                self.log(f"profiler: cost_provider failed ({e})")
        with open(os.path.join(capture["dir"], COST_FILE), "w") as f:
            json.dump(costs, f, indent=2, sort_keys=True)


@contextlib.contextmanager
def profile_block(
    out_dir: str,
    cost_provider: Optional[Callable[[], dict]] = None,
    reason: str = "block",
    log: Optional[Callable[[str], None]] = None,
    device=None,
):
    """One-shot capture around a block (serve warmup uses this): a device
    trace on the card, the cost-only capture on the CPU. No-op when
    `out_dir` is falsy."""
    if not out_dir:
        yield None
        return
    window = ProfilerWindow(out_dir, cost_provider=cost_provider, log=log, device=device)
    path = window.arm(reason)
    try:
        yield path
    finally:
        window.disarm()
