"""Thin stdlib JSON-over-HTTP transport for :class:`AsyncSolveService`.
Port of ``repro.serve.server``.

No new dependencies: ``http.server.ThreadingHTTPServer`` handles
connections on worker threads and bridges every call onto the service's
asyncio loop via ``asyncio.run_coroutine_threadsafe`` (the
:class:`ServiceRunner` owns that loop on a dedicated thread, so the same
runner also serves in-process callers — benchmarks, tests, notebooks —
without HTTP in the way).

Endpoints (all JSON):

- ``POST /v1/requests``                  — submit ``{problem, inputs,
  cfg?, options?, chaos?}``; 202 with ``{id, status}``, 503 with
  ``retriable: true`` when admission control refuses, 400 when the
  request is malformed.
- ``GET  /v1/requests/<id>``             — status record.
- ``GET  /v1/requests/<id>/result``      — terminal result (costs,
  convergence, timing percentiles, optional ``?include_x=1`` payload as
  lossless array records, ``serve.codec``); 409 while the request is
  still queued/running.
- ``POST /v1/requests/<id>/cancel``      — cancel a queued request.
- ``GET  /v1/requests/<id>/events``      — progress stream: newline-
  delimited JSON chunk events relayed live from the driver's
  ``progress_fn``, terminated by a ``{"kind": "end", ...}`` line.
- ``GET  /v1/metrics`` / ``GET /v1/healthz`` — metrics snapshot (incl.
  per-workload breaker states) / liveness (+ drain/crash state).
- ``GET  /v1/readyz``                    — readiness: 200 when the
  service can usefully take traffic, 503 (with detail) while draining,
  crashed, queue-full, or a workload breaker is open.
- ``POST /v1/admin/drain``               — graceful drain (in-flight
  finishes, queued rejected retriable).

Input arrays arrive as lossless array records (``serve.codec``, what
``serve.client`` sends), as nested JSON lists decoded as float32, or as
``{"data": ..., "dtype": "..."}``; workload configs arrive as plain
dicts and are decoded through the port's per-workload config dataclass.
The codecs live in ``serve.codec`` (shared with the request journal) and
are re-exported here.  The service runs its solves on ``device``
(``None``: ``"cuda"``), or across ``mesh=``: then this process is rank 0
of the mesh and every other rank runs ``serve.follow(mesh)``; the
metrics add ``input_broadcast_s``, the seconds of each dispatch's
broadcast to the followers.
"""
from __future__ import annotations

import asyncio
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

# re-exported: the journal shares these codecs (see serve.codec)
from repro_torch.serve.codec import (decode_config,  # noqa: F401
                                     decode_inputs, decode_options,
                                     encode_tree)
from repro_torch.serve.service import (AsyncSolveService, RequestRejected,
                                       RequestRecord, ServeConfig,
                                       SolveRequest)


def decode_request(payload: dict) -> SolveRequest:
    if "problem" not in payload or "inputs" not in payload:
        raise ValueError('request body needs "problem" and "inputs"')
    problem = payload["problem"]
    deadline = payload.get("deadline_s")
    return SolveRequest(
        problem=problem,
        inputs=decode_inputs(payload["inputs"]),
        cfg=decode_config(problem, payload.get("cfg")),
        options=decode_options(payload.get("options")),
        chaos_spec=payload.get("chaos"),
        deadline_s=float(deadline) if deadline is not None else None)


def encode_result(rec: RequestRecord, include_x: bool = False) -> dict:
    """The result's JSON; ``include_x`` adds the iterate as lossless
    array records."""
    out = rec.public()
    sol = rec.solution
    if sol is not None:
        out["costs"] = [float(c) for c in sol.log.costs]
        out["converged_at"] = sol.log.converged_at
        out["iters_run"] = sol.log.iters_run
        out["time_percentiles_s"] = sol.percentiles()
        if include_x:
            out["x"] = encode_tree(sol.x)
    # prefer the per-request ledger (sliced from the bucket's
    # shared report, or attached by the quarantine solo re-run) over
    # the raw Solution report
    rep = rec.recovery if rec.recovery is not None else \
        (sol.recovery if sol is not None else None)
    if rep is not None:
        out["recovery"] = rep.to_json()
    return out


class ServiceRunner:
    """Owns an event loop on a daemon thread and runs one
    :class:`AsyncSolveService` on it; every method is thread-safe, so
    HTTP handler threads (and plain synchronous callers) can drive the
    asyncio core directly."""

    def __init__(self, config: Optional[ServeConfig] = None, *,
                 service: Optional[AsyncSolveService] = None,
                 mesh=None, device=None):
        self.service = service or AsyncSolveService(config, mesh=mesh,
                                                    device=device)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, daemon=True,
            name="repro-serve-loop")
        self._thread.start()
        self.call(self.service.start())

    def call(self, coro, timeout: Optional[float] = None):
        return asyncio.run_coroutine_threadsafe(
            coro, self._loop).result(timeout)

    # thin sync facade over the service coroutines
    def submit(self, request: SolveRequest) -> RequestRecord:
        return self.call(self.service.submit(request))

    def record(self, request_id: str) -> RequestRecord:
        return self.service.record(request_id)

    def result(self, request_id: str,
               timeout: Optional[float] = None) -> RequestRecord:
        return self.call(self.service.result(request_id, timeout))

    def wait_events(self, request_id: str, cursor: int,
                    timeout: float = 0.5):
        return self.call(
            self.service.wait_events(request_id, cursor, timeout))

    def cancel(self, request_id: str) -> bool:
        return self.call(self.service.cancel(request_id))

    def drain(self) -> dict:
        return self.call(self.service.drain())

    def shutdown(self) -> None:
        """Drain the service, stop the loop thread."""
        self.call(self.service.close())
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.0: the events endpoint streams until EOF with no chunked
    # framing, which every stdlib/urllib client reads correctly
    protocol_version = "HTTP/1.0"
    server_version = "repro-serve/1.0"

    # ------------------------------------------------------- plumbing
    @property
    def runner(self) -> ServiceRunner:
        return self.server.runner            # type: ignore[attr-defined]

    def log_message(self, fmt, *args):       # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b"{}"
        return json.loads(raw.decode() or "{}")

    def _split(self):
        path, _, query = self.path.partition("?")
        q = dict(p.partition("=")[::2] for p in query.split("&") if p)
        return [p for p in path.split("/") if p], q

    # --------------------------------------------------------- routes
    def do_GET(self) -> None:  # noqa: N802  (stdlib handler contract)
        parts, q = self._split()
        try:
            if parts == ["v1", "metrics"]:
                svc = self.runner.service
                snap = svc.metrics.snapshot()
                snap["breakers"] = svc.breaker_states()
                if svc.mesh is not None:
                    snap["input_broadcast_s"] = list(svc.broadcast_s)
                return self._json(200, snap)
            if parts == ["v1", "healthz"]:
                svc = self.runner.service
                return self._json(200, {
                    "ok": not svc.crashed, "draining": svc.draining,
                    "crashed": svc.crashed,
                    "queue_depth": svc.metrics.queue_depth})
            if parts == ["v1", "readyz"]:
                ok, detail = self.runner.service.ready()
                return self._json(200 if ok else 503,
                                  {"ready": ok, **detail})
            if len(parts) == 3 and parts[:2] == ["v1", "requests"]:
                rec = self.runner.record(parts[2])
                return self._json(200, rec.public())
            if len(parts) == 4 and parts[:2] == ["v1", "requests"] \
                    and parts[3] == "result":
                return self._result(parts[2], q)
            if len(parts) == 4 and parts[:2] == ["v1", "requests"] \
                    and parts[3] == "events":
                return self._stream_events(parts[2])
        except KeyError as e:
            return self._json(404, {"error": str(e)})
        self._json(404, {"error": f"no route for GET {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        parts, _ = self._split()
        try:
            if parts == ["v1", "requests"]:
                return self._submit()
            if len(parts) == 4 and parts[:2] == ["v1", "requests"] \
                    and parts[3] == "cancel":
                ok = self.runner.cancel(parts[2])
                return self._json(200 if ok else 409,
                                  {"id": parts[2], "cancelled": ok})
            if parts == ["v1", "admin", "drain"]:
                return self._json(200, self.runner.drain())
        except KeyError as e:
            return self._json(404, {"error": str(e)})
        self._json(404, {"error": f"no route for POST {self.path}"})

    # -------------------------------------------------- route bodies
    def _submit(self) -> None:
        try:
            request = decode_request(self._read_body())
        except (ValueError, TypeError, KeyError,
                json.JSONDecodeError) as e:
            return self._json(400, {"error": f"{e}", "retriable": False})
        try:
            rec = self.runner.submit(request)
        except RequestRejected as e:
            # admission refusal: 503 + retriable when load/drain-shaped
            code = 503 if e.retriable else 400
            return self._json(code, {
                "id": e.record.id, "status": e.record.status,
                "error": e.record.error, "retriable": e.retriable})
        self._json(202, {"id": rec.id, "status": rec.status})

    def _result(self, rid: str, q: dict) -> None:
        rec = self.runner.record(rid)
        if not rec.done.is_set():
            return self._json(409, {
                "id": rid, "status": rec.status,
                "error": "request not finished; poll status or stream "
                         "events"})
        include_x = q.get("include_x", "0") not in ("0", "", "false")
        code = {"done": 200, "cancelled": 410,
                "rejected": 503 if rec.retriable else 400}.get(
                    rec.status, 500)
        self._json(code, encode_result(rec, include_x=include_x))

    def _stream_events(self, rid: str) -> None:
        rec = self.runner.record(rid)       # 404 before headers go out
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        cursor = 0
        while True:
            events, done, cursor = self.runner.wait_events(
                rid, cursor, timeout=0.5)
            for e in events:
                self.wfile.write((json.dumps(e) + "\n").encode())
            self.wfile.flush()
            if done and cursor >= len(rec.events):
                end = {"kind": "end", "status": rec.status,
                       "error": rec.error}
                self.wfile.write((json.dumps(end) + "\n").encode())
                self.wfile.flush()
                return


class ServerHandle:
    """A running HTTP frontend; ``close()`` is the graceful-shutdown
    path (stop accepting connections, drain the service)."""

    def __init__(self, httpd: ThreadingHTTPServer, runner: ServiceRunner,
                 thread: threading.Thread, owns_runner: bool):
        self.httpd = httpd
        self.runner = runner
        self._thread = thread
        self._owns_runner = owns_runner

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)
        if self._owns_runner:
            self.runner.shutdown()

    def __enter__(self) -> "ServerHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_http(config: Optional[ServeConfig] = None, *,
               runner: Optional[ServiceRunner] = None,
               host: str = "127.0.0.1", port: int = 0,
               verbose: bool = False, mesh=None,
               device=None) -> ServerHandle:
    """Start the HTTP frontend on a daemon thread (``port=0`` binds an
    ephemeral port — read it back from ``handle.address``).  Pass an
    existing ``runner`` to share a service between transports; otherwise
    one is created and owned (and drained) by the returned handle.
    ``mesh=``: this is rank 0 of the mesh, the other ranks run
    ``serve.follow(mesh)`` until the handle closes."""
    owns = runner is None
    runner = runner or ServiceRunner(config, mesh=mesh, device=device)
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.runner = runner                    # type: ignore[attr-defined]
    httpd.verbose = verbose                  # type: ignore[attr-defined]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="repro-serve-http")
    thread.start()
    return ServerHandle(httpd, runner, thread, owns_runner=owns)
