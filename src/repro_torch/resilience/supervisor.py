"""The chunk loop's recovery engine.  Port of
``repro.resilience.supervisor``; one :class:`Supervisor` serves both
drivers (the JAX package's ``core.driver._BatchSupervisor`` included).

The drivers stay in charge of *what* runs and of their own state; this
module owns *what happens when it fails*, and reaches the driver through
its snapshot and restore hooks only:

- :meth:`Supervisor.begin_chunk` pushes the driver's chunk-start
  snapshot onto the ring — references to its tensors on the card.  The
  JAX package copies every snapshot to the host, because donation
  consumes its buffers; the port's steps write out of place and donate
  nothing (``core.persistence.assert_out_of_place``), so the tensors a
  chunk started from are still intact when it fails, and a snapshot
  costs no copy and no host sync.  A fault raised partway through
  enqueuing a chunk leaves work on the stream that writes only into
  fresh tensors, so the retry from the chunk's start is exact;
- :meth:`Supervisor.dispatch` wraps one chunk in classify → bounded
  retry with exponential backoff and seeded jitter;
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

Under a mesh (SPMD: one process per rank, ``core.compat``) every
recovery decision is one decision of every rank, taken on the mesh's
control plane on the host (``compat.Control``), never by a rank alone:

- the finite flag is per rank; :func:`mesh_flag` sums the ranks' flags
  in one all-reduce on the device group before the chunk's one host
  sync, so every rank reads the same verdict (and which ranks' shards
  were not finite) with the same global costs, and rolls back to the
  same ring entry (each entry holds the rank's own shard references);
- a transient fault a rank catches before its chunk issued any
  collective (``compat.COLLECTIVES``) is retried on that rank alone:
  its peers wait in the chunk's first collective, and the retry issues
  the same sequence.  Caught after a collective (or not to be retried),
  it goes to a vote on the control plane with a bounded wait
  (:data:`VOTE_TIMEOUT_S`): when every rank votes the same (the
  replicated chaos plan fires on every rank at the same call) they act
  together; otherwise the rank raises
  :class:`~repro_torch.resilience.errors.MeshFaultError` and tears the
  process groups down (``compat.tear_down``), and its peers raise it
  too: on gloo from the collective they were in, on NCCL once the
  mesh's watch has aborted their communicators (that chunk's values are
  void, so each chunk's end under a mesh checks ``Control.aborted``, a
  host flag);
- the disk fallback restores the newest step every rank finds valid
  (agreed over the control plane), each rank its own records;
- the :class:`RecoveryReport` is merged over the control plane when the
  run ends (``RecoveryReport.merged``): the same on every rank.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import checks as _checks
from repro_torch.core import compat
from repro_torch.core.checks import leaves_with_path
from repro_torch.core.spans import span
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience.errors import (DivergenceError, MeshFaultError,
                                           ResilienceExhausted, classify)
from repro_torch.resilience.recovery import RecoveryReport, ResilienceConfig

# how long a rank that met a fault past a collective waits for the other
# ranks' votes under a mesh (seconds)
VOTE_TIMEOUT_S = 10.0


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


def mesh_flag(flag: Optional[torch.Tensor], axes, device) -> torch.Tensor:
    """Every rank's verdict: a (size,) tensor, entry r 1 when rank r's
    state is not finite — this rank's :func:`finite_flag` at its index,
    summed over ``axes`` in one all-reduce.  Enqueued, not read."""
    bad = torch.zeros(axes.size, dtype=torch.float32, device=device)
    if flag is not None:
        bad[axes.rank] = (~flag).to(bad.dtype)
    return compat.psum(bad, axes)


def host_costs_and_flag(trace, flag: Optional[torch.Tensor]):
    """The chunk's one host sync under supervision: its cost trace and
    the state's finite flag in one transfer.  The verdict is a bool for
    a 0-d flag, and for a :func:`mesh_flag` the tuple of the ranks'
    verdicts (``True``: finite)."""
    costs = trace["cost"] if isinstance(trace, dict) else trace
    with span("driver.sync"):
        if flag is None:
            return costs.detach().cpu().numpy(), True
        both = torch.cat([costs.detach().reshape(-1),
                          flag.reshape(-1).to(costs.dtype)]).cpu().numpy()
    n = flag.numel()
    head = both[:-n].reshape(tuple(costs.shape))
    if flag.dim() == 0:
        return head, bool(both[-1] != 0)
    return head, tuple(bool(v == 0) for v in both[-n:])


def _validate(costs, finite, state, what: str, it: int,
              rank: int = 0) -> None:
    """Raise :class:`DivergenceError` for a NaN or -inf objective, or a
    state whose finite flag read false (then the state is searched on
    the host for the message).  Under a mesh ``finite`` holds every
    rank's verdict: each rank searches its own shard, and one whose
    shard is finite names the ranks whose shards are not.  The error's
    ``local`` tells whether this rank's own costs or state showed the
    divergence (the merged report keeps such a rank's message)."""
    ranks = finite if isinstance(finite, tuple) else (bool(finite),)
    bad = [r for r, ok in enumerate(ranks) if not ok]
    named = f" (not finite on rank(s) {bad} of {len(ranks)})" \
        if len(ranks) > 1 and bad else ""
    local = True
    try:
        _checks.assert_costs_finite(costs, f"resilience: {what} ending at "
                                           f"iteration {it}")
        if rank in bad:
            _checks.assert_all_finite(state, f"resilience: {what} state "
                                             f"after iteration {it}")
            raise _checks.CheckError(
                f"resilience: {what} state after iteration {it} is not "
                f"finite (device reduction)")
        if bad:
            local = False
            raise _checks.CheckError(f"resilience: {what} state after "
                                     f"iteration {it} is not finite")
    except _checks.CheckError as e:
        err = DivergenceError(str(e) + named, step=it)
        err.local = local
        raise err from e


class _MeshPlane:
    """A supervisor's collective side under a mesh: the control plane,
    the run's key, the votes and the disk agreement."""

    def __init__(self, axes):
        self.ctl = axes.control
        if self.ctl is None:
            raise ValueError("supervision under a mesh needs the mesh's "
                             "control plane (axes from compat.axes_of)")
        self.run = self.ctl.next_id()

    def check_peers(self, err: Optional[BaseException] = None) -> None:
        """Raise :class:`MeshFaultError` when a rank declared a fault:
        after an error, which the torn-down groups then explain (the
        store is read), or, with ``err`` None, after a chunk whose NCCL
        work this rank's watch aborted (a host flag: no store read)."""
        reason = self.ctl.aborted
        if reason is None and err is not None:
            reason = self.ctl.fault()
        if reason is not None:
            compat.tear_down(reason)
            raise MeshFaultError(f"rank {self.ctl.rank}: a peer met a "
                                 f"fault alone: {reason}") from err

    def agree(self, key: tuple, ballot: str, err: BaseException,
              what: str) -> None:
        """Every rank votes ``ballot`` under ``key`` within the bounded
        wait, or this rank tears the mesh down and raises."""
        if self.ctl.vote(self.ctl.key("run", self.run, *key), ballot,
                         VOTE_TIMEOUT_S):
            return
        reason = (f"rank {self.ctl.rank}: {what} ({type(err).__name__}: "
                  f"{err}); the other ranks did not vote {ballot!r} "
                  f"within {VOTE_TIMEOUT_S} s")
        compat.tear_down(reason)
        raise MeshFaultError(reason) from err

    def agreed_step(self, directory) -> Optional[int]:
        """The newest checkpoint step that every rank finds valid."""
        from repro_torch.checkpoint import checkpointer as ckpt
        bound = None
        while True:
            mine, _ = ckpt.latest_valid_step(directory, at_most=bound)
            steps = self.ctl.gather(mine)
            if any(s is None for s in steps):
                return None
            low = min(steps)
            if all(s == low for s in steps):
                return low
            bound = low


class Supervisor:
    """Per-run recovery engine; one per driver run.

    It sees the driver through four hooks, so the ring holds whatever
    the driver's snapshot returns and the rewind is the driver's own:

    - ``driver.snapshot()``: the chunk-start entry of the ring
      (references to the carry's tensors, and what the driver's
      bookkeeping needs to rewind to that boundary);
    - ``driver.restore(entry)``: rewind to a ring entry;
    - ``driver.restore_checkpoint(directory, step)``: rewind to the
      checkpoint of iteration ``step``;
    - ``driver.map_replicated(fn)``: apply the step-size backoff to the
      broadcast state.

    ``axes`` is the mesh the run spans (``compat.NO_AXES`` without one),
    ``what`` names the run's chunk in messages ("chunk", "bucket
    chunk")."""

    def __init__(self, cfg: ResilienceConfig, driver, axes, what: str):
        self.cfg = cfg
        self.driver = driver
        self.what = what
        self.report = RecoveryReport()
        # (iteration, driver snapshot) per chunk start
        self.ring: deque = deque(maxlen=cfg.ring)
        # the chaos seed wins during a drill, so a report replays exactly
        seed = _chaos.active_seed()
        self.rng = np.random.default_rng(cfg.seed if seed is None
                                         else seed)
        self._rollbacks_done = 0
        self._last_restored_it: Optional[int] = None
        self.mesh = _MeshPlane(axes) if axes else None
        self.rank = axes.rank if axes else 0
        # chunks begun: the same count on every rank of a mesh
        self._seq = 0
        self._merged: Optional[RecoveryReport] = None

    def _tag(self, kind: int, attempt: int, **extra) -> None:
        """Under a mesh, key the newest fault for the merged report."""
        if self.mesh is not None:
            self.report.faults[-1].update(key=(self._seq, kind, attempt),
                                          **extra)

    def _backoff(self, attempt: int) -> float:
        base = self.cfg.backoff_s * self.cfg.backoff_factor ** attempt
        return base * (1.0 + self.cfg.jitter
                       * float(self.rng.uniform(-1.0, 1.0)))

    def begin_chunk(self, it: int) -> None:
        """Push the chunk-start snapshot onto the ring (no copy of the
        carry)."""
        self._seq += 1
        self.ring.append((it, self.driver.snapshot()))

    def dispatch(self, fn: Callable, i: int, k: int):
        """``fn(i, k)`` with classify → bounded retry.  The driver
        commits a chunk's carry only once its dispatch returns, so every
        retry starts from the chunk-start carry, the ring's newest
        entry."""
        what = f"{self.what} dispatch"
        attempt = 0
        while True:
            t0 = time.perf_counter()
            n0 = compat.COLLECTIVES["launches"]
            try:
                out = fn(i, k)
                if self.mesh is not None:
                    self.mesh.check_peers()
                return out
            except MeshFaultError:
                raise
            except Exception as e:
                if self.mesh is not None:
                    self.mesh.check_peers(e)
                kind = classify(e, self.cfg.transient_types)
                again = kind == "transient" and \
                    attempt < self.cfg.max_retries
                self.report.record_fault("dispatch", i, e)
                self._tag(0, attempt, retried=again)
                issued = compat.COLLECTIVES["launches"] - n0
                if self.mesh is not None and (issued or not again):
                    # past a collective the peers cannot follow this
                    # rank alone: every rank acts together or none
                    self.mesh.agree(
                        ("dispatch", self._seq, attempt),
                        f"{issued}:{'retry' if again else 'raise'}", e,
                        f"{what} at iteration {i} failed after {issued} "
                        f"collectives of the chunk")
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
                self.report.wall_time_lost_s += time.perf_counter() - t1
                attempt += 1

    def validate(self, costs, finite, state, it: int) -> None:
        """Raise :class:`DivergenceError` for a non-finite objective or
        state (``state``: the tree the finite flag read)."""
        _validate(costs, finite, state, self.what, it, self.rank)

    def _next_rollback(self, err: DivergenceError):
        """Book one rollback and return the ring entry to restore, or
        ``None`` when the ring is dry (the caller goes to disk)."""
        self.report.record_fault("divergence", err.step, err)
        self._tag(1, 0, local=getattr(err, "local", True))
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
                and self.ring[-1][0] == self._last_restored_it):
            self.ring.pop()
        return self.ring.pop() if self.ring else None

    def rollback(self, err: DivergenceError) -> int:
        """Rewind the driver to the newest ring entry (consumed) or, the
        ring dry, to the newest valid checkpoint, then apply the optional
        step-size backoff.  Returns the iteration restored."""
        entry = self._next_rollback(err)
        t0 = time.perf_counter()
        if entry is not None:
            it, snap = entry
            self.driver.restore(snap)
        else:
            directory, it = self._latest_on_disk(err)
            self.driver.restore_checkpoint(directory, it)
            self.report.checkpoint_restores += 1
        self._last_restored_it = it
        if self.cfg.rollback_rescale is not None:
            self.driver.map_replicated(
                lambda rep: self.cfg.rollback_rescale(
                    rep, self._rollbacks_done))
        self.report.wall_time_lost_s += time.perf_counter() - t0
        return it

    def _latest_on_disk(self, err: DivergenceError) -> Tuple[str, int]:
        if self.cfg.checkpoint_dir is None:
            raise self._exhausted(
                "snapshot ring exhausted and no checkpoint_dir to fall "
                "back to; latest divergence: " + str(err)) from err
        from repro_torch.checkpoint import checkpointer as ckpt
        if self.mesh is not None:
            step = self.mesh.agreed_step(self.cfg.checkpoint_dir)
        else:
            step, _skipped = ckpt.latest_valid_step(
                self.cfg.checkpoint_dir)
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
        """The run's report; under a mesh merged over the control plane
        (every rank calls this at the same point: the run's end, or a
        budget every rank exhausted together)."""
        if self.mesh is None:
            return self.report
        if self._merged is None:
            self._merged = RecoveryReport.merged(
                self.mesh.ctl.gather(self.report))
        return self._merged
