"""Resilient solves: fault injection, supervised recovery, the error
taxonomy.  Port of ``repro.resilience``:

- :mod:`repro_torch.resilience.chaos` — deterministic seeded fault
  injection at named points (``ChaosConfig`` / ``REPRO_CHAOS``);
- :mod:`repro_torch.resilience.errors` — transient, fatal, divergence
  (:func:`classify`), with the card's own fatal failures;
- :mod:`repro_torch.resilience.recovery` — ``ResilienceConfig`` and the
  ``RecoveryReport`` returned on ``Solution.recovery``;
- :mod:`repro_torch.resilience.supervisor` — the snapshot ring, retry
  and rollback engine the drivers engage for ``solve(...,
  resilience=ResilienceConfig(...))`` and ``solve_many``.

The drivers import ``supervisor`` only when resilience is asked for.
"""
from repro_torch.resilience.chaos import ChaosConfig, active_chaos
from repro_torch.resilience.errors import (DivergenceError, InjectedFault,
                                           ResilienceError,
                                           ResilienceExhausted, classify)
from repro_torch.resilience.recovery import RecoveryReport, ResilienceConfig

__all__ = ["ChaosConfig", "DivergenceError", "InjectedFault",
           "RecoveryReport", "ResilienceConfig", "ResilienceError",
           "ResilienceExhausted", "active_chaos", "classify"]
