"""Asyncio HTTP frontend: the network boundary of the serving plane
(counterpart of mgproto_tpu/serving/frontend.py, without request tracing).
Stdlib only (asyncio and json).

  * the SOCKETS: a minimal HTTP/1.1 server (`asyncio.start_server`), one
    JSON request and response per connection;
  * the PUMP: one task feeds submitted requests into the `ReplicaSet`,
    turns its `poll()` (micro-batching, supervision) and the autoscaler's
    `tick()` when one is configured, and resolves each request's future
    when its typed response comes. All ReplicaSet access
    happens on the pump, one step at a time, so the plane needs no locks;
    the step runs in the default executor, so the event loop stays
    responsive while the card works;
  * the DRAIN: on stop (`request_stop()`, or the preemption handler's
    SIGTERM/SIGINT flag) the pump stops admitting, answers or sheds every
    queued request typed (`ReplicaSet.drain`) and resolves every
    outstanding future before `run_until_drained` returns.

Endpoints:

  POST /v1/predict   {"id"?, "image": nested lists, "deadline_ms"?,
                     "tenant"?} -> one ServeResponse JSON; 200 predict/abstain, 400 reject
                     (503 for circuit_open/device_error: retryable), 429
                     shed (503 for shutdown).
  GET  /healthz      liveness: 200 {"alive": true, "draining": ...}.
  GET  /readyz       200 when a replica is ready, else 503; per-replica
                     probe detail in the body.
  GET  /metrics      Prometheus text of the process-current registry.
  POST /admin/swap   {"artifact": path} -> blue/green hot swap
                     (serving/swap.py): 200 committed, 409 rejected.
  GET  /admin/autoscale  the autoscaler's status (serving/autoscale.py);
                     501 when none is configured.

A client that announces a body and stalls gets 408; a request head beyond
`max_head_bytes` gets 400. `await asyncio.sleep`/`wait_for` are the only
waits here.
"""

from __future__ import annotations

import asyncio
import json
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from mgproto_tpu_torch.obs import reqtrace as _reqtrace
from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.serving.replica import ReplicaSet
from mgproto_tpu_torch.serving.response import (
    OUTCOME_ABSTAIN,
    OUTCOME_PREDICT,
    OUTCOME_REJECT,
    OUTCOME_SHED,
    REASON_CIRCUIT_OPEN,
    REASON_DEVICE_ERROR,
    REASON_SHUTDOWN,
    ServeResponse,
    shed_response,
)

_RETRYABLE_REJECTS = (REASON_CIRCUIT_OPEN, REASON_DEVICE_ERROR)
_MAX_BODY_BYTES = 64 * 1024 * 1024  # a 518x518x3 f32 image is ~13 MB of JSON
_MAX_HEAD_BYTES = 64 * 1024  # request line + headers, cumulative
_REASONS = {200: b"OK", 400: b"Bad Request", 404: b"Not Found", 408: b"Request Timeout",
            409: b"Conflict", 429: b"Too Many Requests", 501: b"Not Implemented",
            503: b"Service Unavailable"}


def http_status_for(resp: ServeResponse) -> int:
    """The one outcome -> status map."""
    if resp.outcome in (OUTCOME_PREDICT, OUTCOME_ABSTAIN):
        return 200
    if resp.outcome == OUTCOME_REJECT:
        return 503 if resp.reason in _RETRYABLE_REJECTS else 400
    # shed: overload backpressure, except shutdown, which is going away
    return 503 if resp.reason == REASON_SHUTDOWN else 429


class Frontend:
    def __init__(self, replicas: ReplicaSet, host: str = "127.0.0.1", port: int = 0,
                 poll_interval_s: float = 0.002, request_timeout_s: float = 30.0,
                 io_timeout_s: float = 10.0, max_head_bytes: int = _MAX_HEAD_BYTES,
                 preemption_handler=None,
                 swap_factory_builder: Optional[Callable[[str], Callable]] = None,
                 require_calibrated_swap: bool = True, autoscaler=None):
        """`swap_factory_builder(path)` returns an engine factory for the
        artifact at `path`; without it /admin/swap answers 501.
        `require_calibrated_swap=False` (the CLI's --allow-uncalibrated)
        lets an operator who opted into degraded serving promote an
        uncalibrated artifact. `autoscaler` (serving/autoscale.py) ticks on
        the pump, where all ReplicaSet access happens."""
        self.replicas = replicas
        self.host = host
        self.port = int(port)  # 0 = ephemeral; the real port after start()
        self.poll_interval_s = float(poll_interval_s)
        self.request_timeout_s = float(request_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self.max_head_bytes = int(max_head_bytes)
        self.preemption_handler = preemption_handler
        self.swap_factory_builder = swap_factory_builder
        self.require_calibrated_swap = bool(require_calibrated_swap)
        self.autoscaler = autoscaler
        self._server: Optional[asyncio.AbstractServer] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._inbox: Deque[Tuple[Any, str, Optional[float], Optional[str]]] = deque()
        self._admin: Deque[Tuple[Callable[[], Any], asyncio.Future]] = deque()
        self._pending: Dict[str, asyncio.Future] = {}
        self._kick: Optional[asyncio.Event] = None
        self._swap_lock: Optional[asyncio.Lock] = None
        self._stop = False
        self._seq = 0
        self.outcomes: Dict[str, int] = {}  # resolved responses by outcome
        # json.loads seconds of the latest predict bodies (bounded: a server
        # runs for days)
        self.decode_s: Deque[float] = deque(maxlen=4096)

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        self._kick = asyncio.Event()
        self._swap_lock = asyncio.Lock()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._pump_task = asyncio.create_task(self._pump())

    def request_stop(self) -> None:
        self._stop = True
        if self._kick is not None:
            self._kick.set()

    async def run_until_drained(self) -> None:
        """Serve until stopped, then finish the graceful drain."""
        if self._server is None:
            await self.start()
        await self._pump_task
        self._server.close()
        await self._server.wait_closed()

    # ----------------------------------------------------------------- pump
    def _stopping(self) -> bool:
        return self._stop or (self.preemption_handler is not None
                              and self.preemption_handler.requested())

    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopping():
            work = list(self._inbox)
            self._inbox.clear()
            admin = list(self._admin)
            self._admin.clear()

            def step():
                out: List[ServeResponse] = []
                admin_results = [fn() for fn, _fut in admin]
                for payload, rid, deadline_s, tenant in work:
                    out.extend(self.replicas.submit(payload, request_id=rid,
                                                    deadline_s=deadline_s, tenant=tenant))
                out.extend(self.replicas.poll())
                if self.autoscaler is not None:
                    decision = self.autoscaler.tick()
                    if decision is not None:
                        out.extend(decision.responses)
                return out, admin_results

            responses, admin_results = await loop.run_in_executor(None, step)
            for (_fn, fut), result in zip(admin, admin_results):
                if not fut.done():
                    fut.set_result(result)
            self._resolve(responses)
            if not work and not admin and not responses:
                self._kick.clear()
                try:
                    await asyncio.wait_for(self._kick.wait(), timeout=self.poll_interval_s)
                except asyncio.TimeoutError:
                    pass
        await self._graceful_drain(loop)

    async def _graceful_drain(self, loop) -> None:
        """Stop admitting; answer or shed everything typed, then resolve any
        future the drain missed (a pending future would hang its socket)."""
        work = list(self._inbox)
        self._inbox.clear()
        admin = list(self._admin)
        self._admin.clear()

        def final():
            out = [shed_response(rid, REASON_SHUTDOWN, tenant=tenant)
                   for _payload, rid, _dl, tenant in work]
            out.extend(self.replicas.drain(REASON_SHUTDOWN))
            return out

        self._resolve(await loop.run_in_executor(None, final))
        for _fn, fut in admin:
            if not fut.done():
                fut.set_result({"ok": False, "reason": REASON_SHUTDOWN})
        for rid in list(self._pending):
            self._resolve([shed_response(rid, REASON_SHUTDOWN)])

    def _resolve(self, responses: List[ServeResponse]) -> None:
        for resp in responses:
            self.outcomes[resp.outcome] = self.outcomes.get(resp.outcome, 0) + 1
            fut = self._pending.pop(resp.request_id, None)
            if fut is not None and not fut.done():
                fut.set_result(resp)

    # -------------------------------------------------------------- routing
    async def _handle(self, reader, writer) -> None:
        status, body, ctype = 400, b'{"error": "bad_request"}', None
        try:
            method, target, headers = await self._read_head(reader)
            length = int(headers.get("content-length", "0"))
            if length > _MAX_BODY_BYTES:
                raise ValueError("body too large")
            # a client that announces a body and stalls must not hold the
            # handler and its socket open forever
            raw = (await asyncio.wait_for(reader.readexactly(length), timeout=self.io_timeout_s)
                   if length else b"")
            status, body, ctype = await self._route(method, target, raw)
        except (asyncio.IncompleteReadError, ValueError, UnicodeDecodeError):
            pass  # malformed HTTP: the 400 default answers
        except asyncio.TimeoutError:
            status, body = 408, b'{"error": "timeout"}'
        try:
            writer.write(b"HTTP/1.1 %d %s\r\nContent-Type: %s\r\nContent-Length: %d\r\n"
                         b"Connection: close\r\n\r\n"
                         % (status, _REASONS.get(status, b"Status"),
                            ctype or b"application/json", len(body)))
            writer.write(body)
            await writer.drain()
        except (ConnectionError, OSError):
            pass  # the client went away; its request was still accounted
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_head(self, reader):
        line = await asyncio.wait_for(reader.readline(), timeout=self.io_timeout_s)
        parts = line.decode("ascii").split()
        if len(parts) < 2:
            raise ValueError("bad request line")
        method, target = parts[0].upper(), parts[1]
        headers = {}
        head_bytes = 0
        while True:
            h = await asyncio.wait_for(reader.readline(), timeout=self.io_timeout_s)
            if h in (b"\r\n", b"\n", b""):
                break
            # a cumulative cap: drip-fed headers must not grow this forever
            head_bytes += len(h)
            if head_bytes > self.max_head_bytes:
                raise ValueError("request head too large")
            key, _, value = h.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        return method, target, headers

    async def _route(self, method, target, raw):
        target = target.split("?", 1)[0]
        if method == "POST" and target == "/v1/predict":
            return await self._predict(raw)
        if method == "GET" and target == "/healthz":
            return 200, json.dumps({"alive": True, "draining": self._stopping()}).encode(), None
        if method == "GET" and target == "/readyz":
            return self._readyz()
        if method == "GET" and target == "/metrics":
            return (200, _m.default_registry().to_prometheus().encode(),
                    b"text/plain; version=0.0.4")
        if method == "POST" and target == "/admin/swap":
            return await self._swap(raw)
        if method == "GET" and target == "/admin/autoscale":
            if self.autoscaler is None:
                return 501, json.dumps({"error": "autoscaler_not_configured"}).encode(), None
            return 200, json.dumps(self.autoscaler.status()).encode(), None
        return 404, b'{"error": "not_found"}', None

    # ------------------------------------------------------------- handlers
    async def _predict(self, raw: bytes):
        loop = asyncio.get_running_loop()
        try:
            t0 = time.perf_counter()
            rec = json.loads(raw)
            self.decode_s.append(time.perf_counter() - t0)
            payload = rec["image"]
            # the tenant id on the wire; absent = the single-tenant path
            tenant = rec.get("tenant")
            tenant = str(tenant) if tenant is not None else None
            deadline_ms = rec.get("deadline_ms")
            # parsed inside the guard: a non-numeric deadline is malformed
            deadline_s = float(deadline_ms) / 1000.0 if deadline_ms is not None else None
        except (ValueError, KeyError, TypeError):
            return 400, json.dumps({"outcome": OUTCOME_REJECT, "reason": "malformed"}).encode(), None
        self._seq += 1
        rid = str(rec.get("id", f"h{self._seq}"))
        if rid in self._pending:  # a duplicate in flight: keep ids unique
            rid = f"{rid}#{self._seq}"
        if _reqtrace.enabled():
            # tracing starts at the HTTP boundary, on the PLANE's clock, so
            # the frontend span holds the pump and inbox wait that the
            # engine-side stages cannot see
            _reqtrace.mint(rid, self.replicas.clock())
        if self._stopping():
            resp = shed_response(rid, REASON_SHUTDOWN)
            return http_status_for(resp), json.dumps(resp.to_dict()).encode(), None
        fut: asyncio.Future = loop.create_future()
        self._pending[rid] = fut
        self._inbox.append((payload, rid, deadline_s, tenant))
        self._kick.set()
        try:
            resp = await asyncio.wait_for(fut, timeout=self.request_timeout_s)
        except asyncio.TimeoutError:
            # a backstop only: every admitted request is answered by poll or
            # drain. Not recorded: its real response is the one account.
            self._pending.pop(rid, None)
            resp = ServeResponse(request_id=rid, outcome=OUTCOME_SHED, reason="timeout")
        return http_status_for(resp), json.dumps(resp.to_dict()).encode(), None

    def _readyz(self):
        detail = [{"name": rep.name, "state": rep.state,
                   "readiness": rep.probe.readiness() if rep.probe is not None else None}
                  for rep in self.replicas.replicas]
        ready = bool(self.replicas.ready_replicas()) and not self._stopping()
        return (200 if ready else 503), json.dumps({"ready": ready, "replicas": detail}).encode(), None

    async def _swap(self, raw: bytes):
        if self.swap_factory_builder is None:
            return 501, json.dumps({"ok": False, "reason": "swap_not_configured"}).encode(), None
        try:
            artifact = str(json.loads(raw)["artifact"])
        except (ValueError, KeyError, TypeError):
            return 400, json.dumps({"ok": False, "reason": "malformed"}).encode(), None
        from mgproto_tpu_torch.serving.swap import flip_fleet, stage_fleet

        factory = self.swap_factory_builder(artifact)
        loop = asyncio.get_running_loop()
        async with self._swap_lock:  # one swap stages at a time
            if self._stopping():
                return 503, json.dumps({"ok": False, "reason": REASON_SHUTDOWN}).encode(), None
            # staging (artifact load, warmup) runs off the pump: it touches
            # no live state, so traffic flows while the green fleet warms.
            # One standby per replica slot, so a replica that restarts
            # meanwhile still finds a green engine at the flip.
            slots = len(self.replicas.replicas)
            standbys, rejection = await loop.run_in_executor(
                None, lambda: stage_fleet(slots, factory,
                                          require_calibrated=self.require_calibrated_swap))
            if rejection is not None:
                return 409, json.dumps(rejection.to_dict()).encode(), None
            if self._stopping():
                # the pump may have drained its admin inbox already: an
                # append now would never be consumed
                return 503, json.dumps({"ok": False, "reason": REASON_SHUTDOWN}).encode(), None
            # only the flip (queue transfer and adopt) runs on the pump
            fut: asyncio.Future = loop.create_future()
            self._admin.append((lambda: flip_fleet(self.replicas, factory, standbys), fut))
            self._kick.set()
            report = await asyncio.wait_for(fut, timeout=600.0)
        if isinstance(report, dict):  # the shutdown raced the swap
            return 503, json.dumps(report).encode(), None
        return (200 if report.ok else 409), json.dumps(report.to_dict()).encode(), None
