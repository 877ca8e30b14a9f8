"""Per-workload circuit breaker for load shedding.  Port of
``repro.serve.breaker`` (stdlib only, unchanged).

A sliding window of recent dispatch outcomes drives the classic
closed → open → half-open state machine:

- **closed** — normal service; every outcome lands in the window.  When
  the window holds at least ``min_samples`` outcomes and the error rate
  reaches ``error_threshold``, the breaker trips open.
- **open** — submits for this workload are shed with the *retriable*
  rejection (clients back off; siblings on other workloads are
  unaffected).  After ``cooldown_s`` the next ``allow()`` admits one
  probe request and moves to half-open.
- **half-open** — exactly one probe in flight; its success closes the
  breaker (window cleared — stale failures must not re-trip it), its
  failure re-opens and restarts the cooldown.

All methods are called from the service's event loop (or its executor
callbacks holding the GIL); the breaker itself is lock-free.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    def __init__(self, *, window: int = 32, min_samples: int = 8,
                 error_threshold: float = 0.5, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.error_threshold = float(error_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._outcomes: deque = deque(maxlen=self.window)   # bools: ok?
        self._latencies: deque = deque(maxlen=self.window)
        self._state = CLOSED
        self._opened_at: Optional[float] = None
        self._probe_inflight = False

    @property
    def state(self) -> str:
        return self._state

    def allow(self) -> bool:
        """May a new request for this workload be admitted now?"""
        if self._state == CLOSED:
            return True
        if self._state == OPEN:
            if (self._clock() - self._opened_at) < self.cooldown_s:
                return False
            self._state = HALF_OPEN
            self._probe_inflight = True
            return True
        # half-open: one probe at a time
        if self._probe_inflight:
            return False
        self._probe_inflight = True
        return True

    def record(self, ok: bool,
               latency_s: Optional[float] = None) -> None:
        """Feed one dispatch outcome.  ``ok`` means the request is not
        evidence of service trouble — completions, cancels and deadline
        expiries count as ok; solver/infrastructure failures do not."""
        if latency_s is not None:
            self._latencies.append(float(latency_s))
        if self._state == HALF_OPEN:
            self._probe_inflight = False
            if ok:
                self._state = CLOSED
                self._outcomes.clear()
            else:
                self._state = OPEN
                self._opened_at = self._clock()
            return
        self._outcomes.append(bool(ok))
        if self._state == CLOSED and self._tripped():
            self._state = OPEN
            self._opened_at = self._clock()

    def _tripped(self) -> bool:
        n = len(self._outcomes)
        if n < self.min_samples:
            return False
        errs = sum(1 for ok in self._outcomes if not ok)
        return (errs / n) >= self.error_threshold

    def snapshot(self) -> dict:
        n = len(self._outcomes)
        errs = sum(1 for ok in self._outcomes if not ok)
        return {"state": self._state, "samples": n, "errors": errs,
                "error_rate": (errs / n) if n else 0.0,
                "cooldown_remaining_s": (
                    max(0.0, self.cooldown_s
                        - (self._clock() - self._opened_at))
                    if self._state == OPEN else 0.0)}
