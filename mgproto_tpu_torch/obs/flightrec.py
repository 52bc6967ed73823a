"""Flight recorder: a bounded ring of recent structured events
(counterpart of the recording half of mgproto_tpu/obs/flightrec.py).

The online plane and the tenant directory record their drift breaches,
rebases, republish attempts, mounts and swaps here (`record_event`).
Recording is always on and cheap: one small dict appended to a
`deque(maxlen=...)` under a lock. The process-current recorder follows the
install/restore pattern of the metric registry (`set_recorder`). Events
carry `host` (0: the port runs in one process) and `pid`. The JAX
package's dump to JSONL on a failure has no caller in the port yet; it
comes with the rest of obs (ROADMAP A item 7).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 512


def _jsonable(v: Any):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    try:
        return float(v)  # numpy and 0-d tensor scalars
    except (TypeError, ValueError):
        return str(v)


class FlightRecorder:
    """Ring buffer of recent events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock=time.time, host: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self.host = int(host)
        self.pid = os.getpid()
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0  # total events recorded (survives ring eviction)

    def record(self, kind: str, **fields) -> None:
        """Append one event; a field that is not a JSON scalar is stored as
        a float where it converts, else as its str."""
        evt: Dict[str, Any] = {"ts": float(self.clock()), "kind": str(kind),
                               "host": self.host, "pid": self.pid}
        for k, v in fields.items():
            evt[k] = _jsonable(v)
        with self._lock:
            evt["seq"] = self._seq
            self._seq += 1
            self._events.append(evt)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    @property
    def recorded_total(self) -> int:
        with self._lock:
            return self._seq


_DEFAULT = FlightRecorder()
_CURRENT = _DEFAULT


def get_recorder() -> FlightRecorder:
    """The process-current recorder (always exists)."""
    return _CURRENT


def set_recorder(recorder: Optional[FlightRecorder]) -> FlightRecorder:
    """Install `recorder` as process-current (None -> the process default);
    returns the previously current one."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = recorder if recorder is not None else _DEFAULT
    return prev


def record_event(kind: str, **fields) -> None:
    """Record on the current ring."""
    _CURRENT.record(kind, **fields)
