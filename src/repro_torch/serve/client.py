"""Minimal stdlib client for the ``repro_torch.serve`` HTTP frontend.
Port of ``repro.serve.client``.

``urllib`` only — the client mirrors the transport's endpoint set
(submit / status / result / cancel / events / metrics) and adds the two
conveniences every caller wants: blocking ``result()`` polling and a
line-iterator over the progress stream.  Arrays and tensors go over the
wire as lossless array records (``serve.codec``: raw bytes in base64,
dtype and shape beside them), an instance's draws dict as a draws
record; ``result(include_x=True)`` brings the iterate back the same way,
as numpy arrays (``as_tensors=True``: CPU tensors).
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, Optional, Sequence

from repro_torch.serve import codec


class ServeError(RuntimeError):
    """Non-2xx response; ``status`` is the HTTP code, ``payload`` the
    decoded JSON body (``retriable`` inside it marks admission-control
    refusals safe to resubmit)."""

    def __init__(self, status: int, payload: dict):
        super().__init__(f"HTTP {status}: {payload.get('error')}")
        self.status = status
        self.payload = payload

    @property
    def retriable(self) -> bool:
        return bool(self.payload.get("retriable"))


class ServeClient:
    def __init__(self, base_url: str, timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # ------------------------------------------------------ transport
    def _call(self, method: str, path: str,
              body: Optional[dict] = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            payload = {}
            try:
                payload = json.loads(e.read().decode())
            except (ValueError, UnicodeDecodeError):
                payload = {"error": str(e)}
            raise ServeError(e.code, payload) from None

    # ------------------------------------------------------ endpoints
    def submit(self, problem: str, inputs: Sequence[Any], *,
               cfg: Optional[dict] = None,
               options: Optional[dict] = None,
               chaos: Optional[str] = None,
               deadline_s: Optional[float] = None) -> str:
        """Submit one request; returns its id.  ``cfg``/``options`` are
        plain dicts (see ``serve.codec``); ``deadline_s`` is a
        wall-clock budget from admission — past it, a running request
        is frozen at the next chunk boundary and fails with a deadline
        error.  Raises :class:`ServeError` with ``retriable=True`` on
        admission refusal (queue full, drain, or open breaker)."""
        body = {"problem": problem,
                "inputs": [codec.encode_input(x) for x in inputs]}
        if cfg is not None:
            body["cfg"] = cfg
        if options is not None:
            body["options"] = options
        if chaos is not None:
            body["chaos"] = chaos
        if deadline_s is not None:
            body["deadline_s"] = float(deadline_s)
        return self._call("POST", "/v1/requests", body)["id"]

    def status(self, request_id: str) -> dict:
        return self._call("GET", f"/v1/requests/{request_id}")

    def result(self, request_id: str, *, include_x: bool = False,
               as_tensors: bool = False, poll_s: float = 0.05,
               timeout: Optional[float] = None) -> dict:
        """Poll until the request is terminal, then fetch the result;
        with ``include_x`` its ``"x"`` is the iterate (numpy arrays, or
        CPU tensors with ``as_tensors``; a tuple for SCDL's pair)."""
        deadline = None if timeout is None else time.time() + timeout
        suffix = "/result" + ("?include_x=1" if include_x else "")
        while True:
            try:
                out = self._call("GET",
                                 f"/v1/requests/{request_id}{suffix}")
                if "x" in out:
                    out["x"] = codec.decode_tree(out["x"],
                                                 as_tensor=as_tensors)
                return out
            except ServeError as e:
                if e.status != 409:          # 409 = still running
                    raise
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(
                    f"request {request_id} not finished after "
                    f"{timeout}s")
            time.sleep(poll_s)

    def cancel(self, request_id: str) -> bool:
        try:
            return bool(self._call(
                "POST", f"/v1/requests/{request_id}/cancel")["cancelled"])
        except ServeError as e:
            if e.status == 409:
                return False
            raise

    def events(self, request_id: str) -> Iterator[Dict]:
        """Iterate live progress events (newline-delimited JSON); the
        final item is the ``{"kind": "end", ...}`` terminal marker."""
        req = urllib.request.Request(
            self.base_url + f"/v1/requests/{request_id}/events")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            for line in r:
                line = line.strip()
                if line:
                    yield json.loads(line.decode())

    def metrics(self) -> dict:
        return self._call("GET", "/v1/metrics")

    def health(self) -> dict:
        return self._call("GET", "/v1/healthz")

    def ready(self) -> dict:
        """Readiness probe; the 503-while-not-ready response body is
        returned (not raised) so callers can inspect the detail."""
        try:
            return self._call("GET", "/v1/readyz")
        except ServeError as e:
            if e.status == 503:
                return e.payload
            raise

    def drain(self) -> dict:
        return self._call("POST", "/v1/admin/drain")
