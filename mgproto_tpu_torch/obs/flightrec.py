"""Flight recorder: a bounded ring of recent structured events, dumped
to JSONL on a failure (counterpart of mgproto_tpu/obs/flightrec.py).

The online plane and the tenant directory record their drift breaches,
rebases, republish attempts, mounts and swaps here (`record_event`); the
training run its rollbacks, preemptions, elastic restores and barrier
timeouts. Recording is always on and cheap: one small dict appended to a
`deque(maxlen=...)` under a lock. The process-current recorder follows the
install/restore pattern of the metric registry (`set_recorder`).

Every event and dump header carries `host`, this process's rank in the
default process group (0 outside one; read when recorded, as the default
recorder exists before the group does), and `pid`. `maybe_dump` writes
only when a `dump_dir` is set (`cli/train.py` sets `model_dir/telemetry`):
`flightrec_<reason>_<n>.jsonl` on rank 0 (and in one process) and
`flightrec_<reason>_<n>.h<rank>.jsonl` on every other rank, so the
survivors of a peer loss dumping into one shared directory never
collide. Imports no torch (torch.distributed is asked
for the rank only where torch is already loaded).
"""

from __future__ import annotations

import json
import os
import sys
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


def _rank_and_world() -> tuple:
    """(rank, world size) of the default process group; (0, 1) outside
    one, or in a process that never loaded torch."""
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None) if torch is not None else None
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


class FlightRecorder:
    """Ring buffer of recent events and their dump to JSONL. `host=None`
    reads this process's rank at each event."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock=time.time,
                 dump_dir: Optional[str] = None, host: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self.dump_dir = dump_dir
        self._host = None if host is None else int(host)
        self.pid = os.getpid()
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0  # total events recorded (survives ring eviction)
        self._dumps = 0
        self.dumped: List[str] = []  # paths written by maybe_dump

    @property
    def host(self) -> int:
        return self._rank_world()[0]

    def _rank_world(self) -> tuple:
        rank, world = _rank_and_world()
        return (rank, world) if self._host is None else (self._host, max(world, self._host + 1))

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

    def dump(self, path: str, reason: str) -> str:
        """Write the ring as JSONL: a header record (reason, wall time,
        counts, host, pid), then one line per event, oldest first; through
        a temporary file and a rename, so a crash mid-dump leaves no torn
        file."""
        events = self.events()
        header = {"flight_recorder": True, "reason": str(reason), "dumped_at": time.time(),
                  "events": len(events), "recorded_total": self.recorded_total,
                  "capacity": self.capacity, "host": self.host, "pid": self.pid}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(header) + "\n")
            for evt in events:
                f.write(json.dumps(evt) + "\n")
        os.replace(tmp, path)
        return path

    def maybe_dump(self, reason: str) -> Optional[str]:
        """Dump into `dump_dir` when one is set (else None), each dump to a
        numbered file of its own: `flightrec_<reason>_<n>.jsonl`, with
        `.h<rank>` before the extension on a rank other than 0."""
        if not self.dump_dir:
            return None
        with self._lock:
            n = self._dumps
            self._dumps += 1
        rank, _ = self._rank_world()
        suffix = f".h{rank}" if rank > 0 else ""
        path = os.path.join(self.dump_dir, f"flightrec_{reason}_{n:03d}{suffix}.jsonl")
        out = self.dump(path, reason)
        self.dumped.append(out)
        return out


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
