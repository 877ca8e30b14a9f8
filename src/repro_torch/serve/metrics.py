"""Serving metrics registry.  Port of ``repro.serve.metrics``.

One thread-safe accumulator per service: request counters, a queue-depth
gauge, dispatch batch occupancy, and end-to-end request latencies
summarized by the same :func:`repro_torch.core.driver.percentiles` helper
a ``RunLog``/``Solution`` uses for per-iteration wall times — a server
and a single run report p50/p99 the same way.

Everything is plain counters and bounded deques: ``record_*`` calls are
cheap enough for the request hot path (they run on the service loop and
on executor worker threads, hence the lock), and ``snapshot()`` returns
a JSON-ready dict for the ``/v1/metrics`` endpoint.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from repro_torch.core.driver import percentiles

#: counters every service exposes; ``rejected`` counts admission-control
#: refusals (queue full / draining) — those are retriable by contract.
#: resilience counters: ``shed`` (circuit-breaker refusals, a
#: subset of ``rejected``), ``expired`` (deadline exceeded in flight),
#: ``quarantined`` (poison buckets re-dispatched solo), ``replayed``
#: (requests re-admitted from the journal on restart), and ``hung``
#: (dispatches reaped by the watchdog timeout)
COUNTERS = ("submitted", "accepted", "rejected", "cancelled",
            "dispatched", "completed", "failed",
            "shed", "expired", "quarantined", "replayed", "hung")


class Metrics:
    """Thread-safe serving metrics for one :class:`AsyncSolveService`."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._counters: Dict[str, int] = {k: 0 for k in COUNTERS}
        self._queue_depth = 0
        # bounded sample windows: latency in seconds (submit -> done),
        # occupancy in requests per dispatched batch
        self._latencies = deque(maxlen=window)
        self._batch_sizes = deque(maxlen=window)

    # ------------------------------------------------------- recording
    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def queue_delta(self, delta: int) -> None:
        """Adjust the queued+running depth gauge."""
        with self._lock:
            self._queue_depth += delta

    def record_batch(self, size: int) -> None:
        with self._lock:
            self._counters["dispatched"] += 1
            self._batch_sizes.append(int(size))

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self._latencies.append(float(seconds))

    # ------------------------------------------------------- reporting
    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._queue_depth

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters[name]

    def snapshot(self, now: Optional[float] = None) -> dict:
        """JSON-ready view: counters, depth gauge, throughput over the
        service's lifetime, batch-occupancy stats, latency percentiles."""
        with self._lock:
            uptime = max((now or time.perf_counter()) - self._t0, 1e-9)
            sizes = list(self._batch_sizes)
            lats = list(self._latencies)
            counters = dict(self._counters)
            depth = self._queue_depth
        return {
            "uptime_s": round(uptime, 3),
            "counters": counters,
            "queue_depth": depth,
            "requests_per_s": round(counters["completed"] / uptime, 3),
            "batch_occupancy": {
                "mean": (round(sum(sizes) / len(sizes), 3)
                         if sizes else None),
                "max": max(sizes) if sizes else None,
                "batches": len(sizes),
            },
            "latency_s": {k: round(v, 6) for k, v in
                          percentiles(lats, (50, 90, 99)).items()},
        }
