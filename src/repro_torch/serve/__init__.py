"""Asynchronous batched solves as a service.  Port of ``repro.serve``.

An asyncio core (:class:`AsyncSolveService`) admits, coalesces and
batches solve requests onto :func:`repro_torch.core.problem.solve_many`
on one device — with poison-bucket quarantine, per-request deadlines,
breaker-based load shedding and a crash-safe request journal — plus a
stdlib JSON-over-HTTP transport (``serve.server``) and client
(``serve.client``).

    from repro_torch.serve import AsyncSolveService, ServeConfig, SolveRequest
    from repro_torch.serve.server import serve_http, ServiceRunner
    from repro_torch.serve.client import ServeClient

``python -m repro_torch.serve.drill`` runs the three serving drills.
"""
from repro_torch.serve.breaker import CircuitBreaker
from repro_torch.serve.journal import (ReplayPlan, RequestJournal,
                                       journal_pending)
from repro_torch.serve.metrics import Metrics
from repro_torch.serve.service import (AsyncSolveService, RequestRecord,
                                       RequestRejected, ServeConfig,
                                       SolveRequest)

__all__ = [
    "AsyncSolveService", "CircuitBreaker", "Metrics", "ReplayPlan",
    "RequestJournal", "RequestRecord", "RequestRejected", "ServeConfig",
    "SolveRequest", "journal_pending",
]
