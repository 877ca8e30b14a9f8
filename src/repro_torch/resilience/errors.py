"""Error taxonomy for the supervised solve loop.  Port of
``repro.resilience.errors``.

Every exception that escapes a chunk dispatch goes through
:func:`classify` before the supervisor decides what to do with it:

- ``"transient"`` — worth retrying from the chunk-start snapshot:
  injected chaos faults, host I/O errors, and runtime errors whose
  message carries one of the retryable status markers.
  ``ResilienceConfig.transient_types`` extends the set per run.
- ``"fatal"`` — a programming or configuration error, or a failure of
  the card that a retry cannot cure: re-raised at once.  On the card
  two kinds are fatal by type, before any marker is looked at:
  ``torch.cuda.OutOfMemoryError`` (the JAX package's
  ``RESOURCE_EXHAUSTED`` is fatal too, being no transient marker), and
  the kernels' launch-error ``RuntimeError("<kernel>: CUDA error N
  (...)")`` (``kernels.common.check``): after a sticky CUDA error the
  context cannot be used again, so a retry would only pretend.

Divergence (a non-finite state or cost at a chunk boundary) is neither:
it is raised as :class:`DivergenceError` and handled by rollback.

Under a mesh a fault that one rank meets alone after its chunk issued a
collective cannot be retried (its peers are past that collective): it
becomes the fatal :class:`MeshFaultError` on every rank.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

import torch


class ResilienceError(RuntimeError):
    """Base class for everything the resilience subsystem raises."""


class InjectedFault(ResilienceError):
    """A chaos-harness fault (``resilience.chaos``): deterministic,
    seeded, and always transient, so the recovery path is what runs."""

    def __init__(self, point: str, *, step: Optional[int] = None,
                 tag: Optional[str] = None):
        self.point = point
        self.step = step
        self.tag = tag
        where = f" at step {step}" if step is not None else ""
        what = f"{point}:{tag}" if tag else point
        super().__init__(f"injected chaos fault '{what}'{where}")


class DivergenceError(ResilienceError):
    """Non-finite state or objective seen at a chunk boundary — the
    iterate diverged (or a chaos injector poisoned it)."""

    def __init__(self, message: str, *, step: Optional[int] = None):
        self.step = step
        super().__init__(message)


class ResilienceExhausted(ResilienceError):
    """Recovery budget spent: retries beyond ``max_retries``, or
    rollbacks beyond ``max_rollbacks`` with no snapshot or valid
    checkpoint left to fall back to."""


class MeshFaultError(ResilienceError):
    """Under a mesh: a fault one rank met alone after its chunk had
    issued a collective (the other ranks did not vote to retry within
    the bounded wait), or a peer's such fault.  The rank that met it
    tears the process groups down (``core.compat.tear_down``) so that
    its peers raise instead of waiting in a collective.  Fatal: recover
    with ``solve(..., resume=True)`` from the sharded checkpoints, in a
    new process group."""


#: exception types retried without further inspection
_TRANSIENT_TYPES: Tuple[type, ...] = (InjectedFault, OSError,
                                      TimeoutError, ConnectionError)

#: substrings marking a retryable runtime failure (status codes of a
#: remote runtime surface in the message, not the type)
_TRANSIENT_MARKERS: Tuple[str, ...] = ("UNAVAILABLE", "DEADLINE_EXCEEDED",
                                       "DATA_LOSS", "ABORTED",
                                       "connection reset")

#: the message ``kernels.common.check`` gives a failed launch
_LAUNCH_ERROR = re.compile(r": CUDA error \d+ \(")


def _card_fatal(exc: BaseException) -> bool:
    """The card's own failures, which no retry cures."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(exc, RuntimeError) and \
        _LAUNCH_ERROR.search(str(exc)) is not None


def classify(exc: BaseException, extra_transient: Tuple[type, ...] = ()
             ) -> str:
    """``"transient"`` (retry from the snapshot) or ``"fatal"``
    (re-raise).  Divergence and an exhausted budget are the
    supervisor's own control flow and never retried."""
    if isinstance(exc, (DivergenceError, ResilienceExhausted,
                        MeshFaultError)):
        return "fatal"
    if _card_fatal(exc):
        return "fatal"
    if isinstance(exc, _TRANSIENT_TYPES + tuple(extra_transient)):
        return "transient"
    msg = str(exc)
    if any(marker in msg for marker in _TRANSIENT_MARKERS):
        return "transient"
    return "fatal"
