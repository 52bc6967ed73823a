"""Process-wide metric registry: counters, gauges, histograms with labels
(a copy of mgproto_tpu/telemetry/registry.py; imports no torch).

The registry is the one place run-time scalars accumulate; sinks render it
(Prometheus text for scrapers and people, JSONL snapshots for
`cli.telemetry summarize`). Everything is host-side and thread-safe: device
values must be host floats before they reach a metric.

A metric has a name, a type, a help string and a family of label-keyed
series, in the order they were registered. Histograms use fixed cumulative
buckets, so percentile estimates survive a snapshot round trip
(`percentile_from_buckets`, which `cli/telemetry.py` and the autoscaler
share). The Prometheus text and the snapshot schema equal the JAX
package's on the same series, timestamps aside. `JsonlWriter` is the file
core of the snapshot stream and the health stream: one JSON object a line,
a flush and fsync every `flush_every` lines, and writes after `close()`
dropped and counted instead of raised.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# step latencies span ~1 ms (tiny CPU configs) to minutes (first compile)
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

_INVALID_NAME = set(" \t\n{}\",=")


def _check_name(name: str) -> str:
    if not name or _INVALID_NAME & set(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Base: one named family of label-keyed series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}
        self._lock = threading.Lock()

    def _labels(self) -> Iterable[Tuple[Tuple[Tuple[str, str], ...], Any]]:
        with self._lock:
            return list(self._series.items())


class Counter(_Metric):
    """Monotonically increasing value (resets only with the process)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Last-write-wins scalar. A series never set reads 0.0 here (None in
    the JAX package; the port's serving plane has always read it so)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class _HistSeries:
    __slots__ = ("bucket_counts", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * (n_buckets + 1)  # +1 for +Inf
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: `le` upper bounds)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ):
        super().__init__(name, help)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.bounds))
            i = 0
            while i < len(self.bounds) and value > self.bounds[i]:
                i += 1
            s.bucket_counts[i] += 1
            s.count += 1
            s.sum += value
            s.min = min(s.min, value)
            s.max = max(s.max, value)

    def snapshot_series(self, **labels) -> Optional[Dict[str, Any]]:
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None:
                return None
            return _hist_dict(self.bounds, s)

    def percentile(self, p: float, **labels) -> Optional[float]:
        snap = self.snapshot_series(**labels)
        if snap is None:
            return None
        return percentile_from_buckets(snap, p)


def _hist_dict(bounds: Sequence[float], s: _HistSeries) -> Dict[str, Any]:
    return {
        "bounds": list(bounds),
        "bucket_counts": list(s.bucket_counts),
        "count": s.count,
        "sum": s.sum,
        "min": None if s.count == 0 else s.min,
        "max": None if s.count == 0 else s.max,
    }


def percentile_from_buckets(hist: Dict[str, Any], p: float) -> Optional[float]:
    """Prometheus-style percentile estimate from a histogram snapshot dict
    ({'bounds', 'bucket_counts', 'count', 'min', 'max'}): linear
    interpolation within the bucket containing the target rank, clamped to
    the observed [min, max] so tiny runs don't report a bucket bound no
    sample ever reached."""
    count = hist.get("count", 0)
    if not count:
        return None
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    bounds = list(hist["bounds"]) + [math.inf]
    target = p / 100.0 * count
    cum = 0
    for i, n in enumerate(hist["bucket_counts"]):
        prev_cum = cum
        cum += n
        if cum >= target and n > 0:
            lo = bounds[i - 1] if i > 0 else hist.get("min") or 0.0
            hi = bounds[i]
            if math.isinf(hi):
                hi = hist.get("max") or lo
            frac = (target - prev_cum) / n
            est = lo + (hi - lo) * frac
            lo_clamp = hist.get("min")
            hi_clamp = hist.get("max")
            if lo_clamp is not None:
                est = max(est, lo_clamp)
            if hi_clamp is not None:
                est = min(est, hi_clamp)
            return est
    return hist.get("max")


class MetricRegistry:
    """Collection of metrics; `default_registry()` is the process-wide one."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help=help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # ------------------------------------------------------------------ sinks
    def snapshot(self) -> Dict[str, Any]:
        """Nested dict of every metric's current series — the JSONL payload."""
        out: Dict[str, Any] = {}
        for m in self.metrics():
            series = []
            for key, val in m._labels():
                entry: Dict[str, Any] = {"labels": dict(key)}
                if isinstance(m, Histogram):
                    entry.update(_hist_dict(m.bounds, val))
                else:
                    entry["value"] = val
                series.append(entry)
            out[m.name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one scrape's worth)."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, val in m._labels():
                if isinstance(m, Histogram):
                    cum = 0
                    for bound, n in zip(
                        list(m.bounds) + ["+Inf"], val.bucket_counts
                    ):
                        cum += n
                        le = bound if bound == "+Inf" else repr(float(bound))
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_prom_labels(key, extra=('le', le))} {cum}"
                        )
                    lines.append(
                        f"{m.name}_sum{_prom_labels(key)} {_prom_num(val.sum)}"
                    )
                    lines.append(f"{m.name}_count{_prom_labels(key)} {val.count}")
                else:
                    lines.append(f"{m.name}{_prom_labels(key)} {_prom_num(val)}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> None:
        """Atomic overwrite (a half-written scrape file is worse than stale)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_prometheus())
        os.replace(tmp, path)


def _prom_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _prom_labels(
    key: Tuple[Tuple[str, str], ...], extra: Optional[Tuple[str, str]] = None
) -> str:
    items = list(key)
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    def esc(v: str) -> str:
        return str(v).replace("\\", "\\\\").replace('"', '\\"')

    body = ",".join(f'{k}="{esc(v)}"' for k, v in items)
    return "{" + body + "}"


_DEFAULT = MetricRegistry()
_CURRENT = _DEFAULT


def default_registry() -> MetricRegistry:
    """The process-current registry: the process-wide default, or whatever a
    live TelemetrySession installed (sessions install a fresh registry so a
    second run in the same process starts its counters from zero instead of
    inheriting the first run's totals)."""
    return _CURRENT


def set_current_registry(registry: Optional[MetricRegistry]) -> MetricRegistry:
    """Install `registry` as process-current (None -> the process default);
    returns the previously current registry so callers can restore it."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = registry if registry is not None else _DEFAULT
    return prev


class JsonlWriter:
    """Append-only JSONL file with batched flush+fsync and a closed-guard.

    The file core under the registry snapshot sink and the health
    recorder: one JSON object per `write()`, an OS-level flush + fsync
    every `flush_every` lines (not per line: a per-line fsync is a
    measurable tax at step cadence), and writes after `close()` drop
    (counted in `.dropped`) instead of raising on a closed file."""

    def __init__(self, path: Optional[str], flush_every: int = 10):
        self.path = path
        self.flush_every = max(int(flush_every), 1)
        self.dropped = 0
        self._count = 0
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
    @property
    def closed(self) -> bool:
        return self._f is None

    def write(self, obj: Dict[str, Any]) -> None:
        self.write_line(json.dumps(obj))

    def write_line(self, line: str) -> None:
        """Raw-line variant."""
        if self._f is None:
            if self.path is not None:
                self.dropped += 1
            return
        self._f.write(line + "\n")
        self._count += 1
        if self._count % self.flush_every == 0:
            self._flush_fsync()

    def _flush_fsync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._flush_fsync()
            self._f.close()
            self._f = None


def write_jsonl_snapshot(
    registry: MetricRegistry,
    writer: JsonlWriter,
    step: Optional[int] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """One registry snapshot as one JSONL line (the summarize input)."""
    rec: Dict[str, Any] = {"time": time.time()}
    if step is not None:
        rec["step"] = int(step)
    if extra:
        rec.update(extra)
    rec["metrics"] = registry.snapshot()
    writer.write(rec)
