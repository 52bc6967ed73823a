"""Hierarchical wall-clock tracing spans with Chrome-trace export (a copy of
mgproto_tpu/telemetry/tracing.py; imports no torch).

Spans nest (each records its depth and parent at open time), carry
attributes, and the whole recording exports as Chrome trace JSON
(`chrome://tracing` / Perfetto "traceEvents"), so a run's epoch / train /
test / push structure shows on a timeline. Device work inside a span is
measured as the wall time the host spent launching and waiting. The
process-current tracer is the one a live TelemetrySession installed (else
the process default); per-thread span stacks keep nesting right under
threaded loaders. `add_span` records a span with explicit timestamps.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class SpanRecord(dict):
    """A completed span: name, ts/dur (seconds since tracer epoch), depth,
    parent index (-1 for roots), tid, attrs. Plain dict subclass so tests
    and exporters can treat records as data."""


class Tracer:
    """Records completed spans; bounded so a forgotten tracer cannot eat the
    host (`dropped` counts what the cap discarded)."""

    def __init__(self, max_spans: int = 200_000):
        self.max_spans = max_spans
        self.dropped = 0
        self._spans: List[SpanRecord] = []
        self._epoch = time.perf_counter()
        self._next_id = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Context manager: records a complete span on exit (exceptions
        included — the span closes and the error propagates). Yields the
        attrs dict so the body can attach results, e.g.
        `with tracer.span("em") as a: a["active"] = n`."""
        stack = self._stack()
        depth = len(stack)
        parent = stack[-1] if stack else -1
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        stack.append(span_id)
        t0 = time.perf_counter()
        try:
            yield attrs
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            rec = SpanRecord(
                id=span_id,
                name=str(name),
                ts=t0 - self._epoch,
                dur=dur,
                depth=depth,
                parent=parent,
                tid=threading.get_ident(),
                attrs={k: _jsonable(v) for k, v in attrs.items()},
            )
            with self._lock:
                if len(self._spans) < self.max_spans:
                    self._spans.append(rec)
                else:
                    self.dropped += 1

    def add_span(
        self,
        name: str,
        ts: float,
        dur: float = 0.0,
        tid: int = 0,
        **attrs,
    ) -> None:
        """Record a span with explicit timestamps (seconds, in the caller's
        own clock domain) instead of wall-clocking a `with` block, e.g. a
        request's stages stamped with a virtual clock. `dur=0` renders as
        an instant marker."""
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return
            span_id = self._next_id
            self._next_id += 1
            self._spans.append(SpanRecord(
                id=span_id,
                name=str(name),
                ts=float(ts),
                dur=max(float(dur), 0.0),
                depth=0,
                parent=-1,
                tid=int(tid),
                attrs={k: _jsonable(v) for k, v in attrs.items()},
            ))

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # ----------------------------------------------------------------- export
    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON ('X' complete events, microsecond ts)."""
        pid = os.getpid()
        events = []
        for rec in self.spans():
            events.append({
                "name": rec["name"],
                "ph": "X",
                "ts": rec["ts"] * 1e6,
                "dur": rec["dur"] * 1e6,
                "pid": pid,
                "tid": rec["tid"],
                "args": {**rec["attrs"], "depth": rec["depth"]},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)


def _jsonable(v: Any):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    try:
        return float(v)  # numpy and 0-d tensor scalars
    except (TypeError, ValueError):
        return str(v)


_DEFAULT = Tracer()
_CURRENT = _DEFAULT


def default_tracer() -> Tracer:
    """The process-current tracer: the process-wide default, or whatever a
    live TelemetrySession installed (sessions install a fresh tracer so a
    second run in the same process doesn't export the first run's spans)."""
    return _CURRENT


def set_current_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install `tracer` as process-current (None -> the process default);
    returns the previously current tracer so callers can restore it."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer if tracer is not None else _DEFAULT
    return prev


def trace_span(name: str, **attrs):
    """Span on the process-current tracer: routed into the live
    TelemetrySession's trace when one is active."""
    return _CURRENT.span(name, **attrs)
