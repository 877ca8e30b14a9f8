"""The supervised chunk loop's recovery engine.  Port of
``repro.resilience.supervisor``, with the batched driver's supervisor
(the JAX package's ``core.driver._BatchSupervisor``) beside it.

The drivers stay in charge of *what* runs; this module owns *what
happens when it fails*:

- :meth:`Supervisor.begin_chunk` pushes the chunk-start carry onto the
  snapshot ring — as references to its tensors on the card.  The JAX
  package copies every snapshot to the host, because donation consumes
  its buffers; the port's steps write out of place and donate nothing
  (``core.persistence.assert_out_of_place``), so the tensors a chunk
  started from are still intact when it fails, and a snapshot costs no
  copy and no host sync.  A fault raised partway through enqueuing a
  chunk leaves work on the stream that writes only into fresh tensors,
  so the retry from the ring is exact;
- :meth:`Supervisor.dispatch` wraps one chunk in classify → bounded
  retry with exponential backoff and seeded jitter, restarting from the
  newest snapshot;
- :meth:`Supervisor.validate` turns a non-finite objective or state at
  the chunk boundary into a :class:`DivergenceError`.  The state's
  verdict is one device reduction (:func:`finite_flag`) that reaches the
  host in the same transfer as the chunk's costs
  (:func:`host_costs_and_flag`), so supervision keeps one host sync per
  chunk; the leaf-by-leaf search for the message runs only once the
  flag has read false;
- :meth:`Supervisor.rollback` recovers from divergence: the newest ring
  entry first (consumed, so repeated divergence walks back in time),
  then the newest *valid* checkpoint on disk, with the optional
  step-size backoff on the broadcast state.

``kernel_fallbacks`` stays empty: the port retries a failed kernel, it
never degrades one (``kernels/common.py``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import checks as _checks
from repro_torch.core.bundle import Bundle
from repro_torch.core.checks import leaves_with_path
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience.errors import (DivergenceError,
                                           ResilienceExhausted, classify)
from repro_torch.resilience.recovery import RecoveryReport, ResilienceConfig


def _leaf_finite(x: torch.Tensor) -> torch.Tensor:
    """0-d bool: ``x`` holds no NaN and no infinity.  One reading pass
    and no full-size temporary: the extremes propagate NaN, and an
    infinity is an extreme (a complex leaf through its real view)."""
    if x.is_complex():
        x = torch.view_as_real(x)
    lo, hi = torch.aminmax(x)
    return torch.isfinite(lo) & torch.isfinite(hi)


def finite_flag(tree: Any) -> Optional[torch.Tensor]:
    """A 0-d bool tensor on the tree's device: every floating or complex
    leaf holds only finite values.  Enqueued, not read: ``None`` when
    the tree has no such leaf."""
    flags = [_leaf_finite(x) for _, x in leaves_with_path(tree)
             if isinstance(x, torch.Tensor) and x.numel()
             and (x.is_floating_point() or x.is_complex())]
    if not flags:
        return None
    return torch.stack(flags).all()


def host_costs_and_flag(trace, flag: Optional[torch.Tensor]
                        ) -> Tuple[np.ndarray, bool]:
    """The chunk's one host sync under supervision: its cost trace and
    the state's finite flag in one transfer."""
    costs = trace["cost"] if isinstance(trace, dict) else trace
    if flag is None:
        return costs.detach().cpu().numpy(), True
    both = torch.cat([costs.detach().reshape(-1),
                      flag.reshape(1).to(costs.dtype)]).cpu().numpy()
    return both[:-1].reshape(tuple(costs.shape)), bool(both[-1] != 0)


def _validate(costs, finite: bool, state, what: str, it: int) -> None:
    """Raise :class:`DivergenceError` for a NaN or -inf objective, or a
    state whose finite flag read false (then the state is searched on
    the host for the message)."""
    try:
        _checks.assert_costs_finite(costs, f"resilience: {what} ending at "
                                           f"iteration {it}")
        if not finite:
            _checks.assert_all_finite(state, f"resilience: {what} state "
                                             f"after iteration {it}")
            raise _checks.CheckError(
                f"resilience: {what} state after iteration {it} is not "
                f"finite (device reduction)")
    except _checks.CheckError as e:
        raise DivergenceError(str(e), step=it) from e


class _Budget:
    """Retry with backoff and the rollback budget, shared by both
    supervisors."""

    def __init__(self, cfg: ResilienceConfig):
        self.cfg = cfg
        self.report = RecoveryReport()
        self.ring: deque = deque(maxlen=cfg.ring)
        # the chaos seed wins during a drill, so a report replays exactly
        seed = _chaos.active_seed()
        self.rng = np.random.default_rng(cfg.seed if seed is None
                                         else seed)
        self._rollbacks_done = 0
        self._last_restored_it: Optional[int] = None

    def _backoff(self, attempt: int) -> float:
        base = self.cfg.backoff_s * self.cfg.backoff_factor ** attempt
        return base * (1.0 + self.cfg.jitter
                       * float(self.rng.uniform(-1.0, 1.0)))

    def _retry(self, fn: Callable, args: Tuple, i: int, restart: Callable,
               what: str):
        """``fn(*args)`` with classify → bounded retry; each retry
        starts over from ``restart()``, the newest snapshot's args."""
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                return fn(*args)
            except Exception as e:
                kind = classify(e, self.cfg.transient_types)
                self.report.record_fault("dispatch", i, e)
                self.report.wall_time_lost_s += time.perf_counter() - t0
                if kind != "transient":
                    raise
                if attempt >= self.cfg.max_retries:
                    raise self._exhausted(
                        f"{what} at iteration {i} still failing after "
                        f"{attempt} retries: {e}") from e
                t1 = time.perf_counter()
                self.report.retries += 1
                time.sleep(self._backoff(attempt))
                args = restart()
                self.report.wall_time_lost_s += time.perf_counter() - t1
                attempt += 1

    def _next_rollback(self, err: DivergenceError, it_of: Callable):
        """Book one rollback and return the ring entry to restore, or
        ``None`` when the ring is dry (the caller goes to disk)."""
        self.report.record_fault("divergence", err.step, err)
        if self._rollbacks_done >= self.cfg.max_rollbacks:
            raise self._exhausted(
                f"rollback budget ({self.cfg.max_rollbacks}) exhausted; "
                f"latest divergence: {err}") from err
        self._rollbacks_done += 1
        self.report.rollbacks += 1
        # the replayed chunk pushed its start again; when that boundary
        # already failed once (and no rescale changes the replay),
        # restoring it again would loop on the same divergence
        if (self.ring and self.cfg.rollback_rescale is None
                and it_of(self.ring[-1]) == self._last_restored_it):
            self.ring.pop()
        return self.ring.pop() if self.ring else None

    def _latest_on_disk(self, err: DivergenceError) -> Tuple[str, int]:
        if self.cfg.checkpoint_dir is None:
            raise self._exhausted(
                "snapshot ring exhausted and no checkpoint_dir to fall "
                "back to; latest divergence: " + str(err)) from err
        from repro_torch.checkpoint import checkpointer as ckpt
        step, _skipped = ckpt.latest_valid_step(self.cfg.checkpoint_dir)
        if step is None:
            raise self._exhausted(
                f"snapshot ring exhausted and no valid checkpoint under "
                f"{self.cfg.checkpoint_dir!r}; latest divergence: {err}"
            ) from err
        return self.cfg.checkpoint_dir, step

    def _exhausted(self, msg: str) -> ResilienceExhausted:
        """A budget-exhaustion error carrying the ledger, so the serving
        layer's quarantine can attribute the failure per request."""
        err = ResilienceExhausted(msg)
        err.report = self.finalize()
        return err

    def finalize(self) -> RecoveryReport:
        return self.report


@dataclass(frozen=True)
class _Snapshot:
    """The chunk-start carry (references to its tensors) and the log
    length at that boundary."""
    it: int
    n_logged: int
    data: Any
    rep: Any
    last: Any


class Supervisor(_Budget):
    """Per-run recovery engine; one per ``IterativeDriver.run``."""

    def __init__(self, cfg: ResilienceConfig, bundle: Bundle, *,
                 start_iter: int = 0):
        super().__init__(cfg)
        self.bundle = bundle
        self.start_iter = start_iter

    def begin_chunk(self, data, rep, last, it: int, n_logged: int) -> None:
        """Push the chunk-start carry onto the ring (no copy)."""
        self.ring.append(_Snapshot(it=it, n_logged=n_logged, data=data,
                                   rep=rep, last=last))

    def dispatch(self, fn: Callable, data, rep, last, i: int, k: int):
        """``fn(data, rep, last, i, k)`` with classify → bounded retry,
        every retry from the chunk-start snapshot."""
        def restart():
            s = self.ring[-1]
            return s.data, s.rep, s.last, i, k

        return self._retry(fn, (data, rep, last, i, k), i, restart,
                           "chunk dispatch")

    def validate(self, data, rep, costs, finite: bool, it: int) -> None:
        _validate(costs, finite, {"data": data, "replicated": rep},
                  "chunk", it)

    def rollback(self, err: DivergenceError, log) -> Tuple[Any, Any, Any,
                                                           int]:
        """Restore the newest ring entry (consumed) or, the ring dry, the
        newest valid checkpoint; rewind ``log`` to that boundary.
        Returns ``(data, replicated, last, iteration)``."""
        snap = self._next_rollback(err, lambda s: s.it)
        t0 = time.perf_counter()
        if snap is not None:
            data, rep, last = snap.data, snap.rep, snap.last
            it, n_logged = snap.it, snap.n_logged
        else:
            data, rep, last, it, n_logged = self._restore_from_disk(err)
        self._last_restored_it = it
        del log.costs[n_logged:]
        del log.times[n_logged:]
        if self.cfg.rollback_rescale is not None:
            rep = self.cfg.rollback_rescale(rep, self._rollbacks_done)
        self.report.wall_time_lost_s += time.perf_counter() - t0
        return data, rep, last, it

    def _restore_from_disk(self, err: DivergenceError):
        from repro_torch.checkpoint import checkpointer as ckpt
        directory, step = self._latest_on_disk(err)
        state, _ = ckpt.restore(directory, step,
                                {"data": self.bundle.data,
                                 "replicated": self.bundle.replicated})
        self.report.checkpoint_restores += 1
        # the carried output restarts from its +inf seed, as after a
        # resume
        return (state["data"], state["replicated"], None, step,
                max(step - self.start_iter, 0))


class BatchSupervisor(_Budget):
    """Retry and rollback for one ``solve_many`` bucket.  A bucket's
    recovery state also spans the active mask, the per-instance counters
    and logs, the slot map and the retired lanes, so its ring entries
    hold those beside the state's tensors (references again).  The disk
    fallback restores the full-bucket checkpoint payload
    (``BatchedDriver.snapshot_payload``)."""

    def __init__(self, cfg: ResilienceConfig, driver):
        super().__init__(cfg)
        self.driver = driver

    def begin_chunk(self, it: int) -> None:
        d = self.driver
        self.ring.append({
            "it": it, "state": d.state,
            "slots": d.slots.copy(), "active": d.active.copy(),
            "iters": d.iters_run.copy(), "conv": d.converged_at.copy(),
            "logs_len": [len(log.costs) for log in d.logs],
            "retired": dict(d.retired)})

    def dispatch(self, fn: Callable, state, mask, i: int, k: int):
        def restart():
            return self.ring[-1]["state"], mask, i, k

        return self._retry(fn, (state, mask, i, k), i, restart,
                           "bucket chunk dispatch")

    def validate(self, state, costs, finite: bool, it: int) -> None:
        _validate(costs, finite, {"data": state["d"],
                                  "replicated": state["r"]},
                  "bucket chunk", it)

    def _restore(self, snap) -> int:
        d = self.driver
        d.slots = snap["slots"].copy()
        d.active = snap["active"].copy()
        d.iters_run = snap["iters"].copy()
        d.converged_at = snap["conv"].copy()
        d.retired = dict(snap["retired"])
        for row in range(d.B0):
            log = d.logs[row]
            n = snap["logs_len"][row]
            del log.costs[n:]
            del log.times[n:]
            log.iters_run = int(d.iters_run[row])
            log.converged_at = (int(d.converged_at[row])
                                if d.converged_at[row] >= 0 else None)
        d.state = snap["state"]
        return snap["it"]

    def rollback(self, err: DivergenceError) -> int:
        snap = self._next_rollback(err, lambda s: s["it"])
        t0 = time.perf_counter()
        it = (self._restore(snap) if snap is not None
              else self._restore_from_disk(err))
        self._last_restored_it = it
        if self.cfg.rollback_rescale is not None:
            d = self.driver
            d.state = dict(d.state, r=self.cfg.rollback_rescale(
                d.state["r"], self._rollbacks_done))
        self.report.wall_time_lost_s += time.perf_counter() - t0
        return it

    def _restore_from_disk(self, err: DivergenceError) -> int:
        from repro_torch.checkpoint import checkpointer as ckpt
        directory, step = self._latest_on_disk(err)
        d = self.driver
        payload, _ = ckpt.restore(directory, step, d.payload_template(),
                                  device=d.device)
        d.load_payload(payload, rewind_logs=True)
        self.report.checkpoint_restores += 1
        return step
