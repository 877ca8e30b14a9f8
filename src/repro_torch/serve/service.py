"""AsyncSolveService: the serving core.  Port of
``repro.serve.service``.

One asyncio event loop owns all scheduling state (no locks on the hot
path); the solves run on a small worker executor so the loop stays
responsive:

- **submit** — admission control first: a draining service, a full
  queue, or an open circuit breaker rejects with a *retriable* status
  (the client's signal to back off or go elsewhere), everything else is
  journaled and enqueued for coalescing.
- **micro-batch scheduler** — requests are grouped by a compatibility
  key (workload + config fingerprint + run-option fingerprint) and then
  offered to an incremental
  :class:`~repro_torch.core.batching.OpenBucketPlanner`
  (same static-signature grouping and waste-budget rule as the offline
  ``solve_many`` planner).  The first request into an open bucket arms a
  deadline timer (``batch_window_s``, tightened toward the earliest
  member ``deadline_s``); the bucket dispatches when the window expires,
  when it reaches ``max_batch`` occupancy, or when a drain flushes it.
- **dispatch** — a closed bucket runs as ONE ``solve_many`` call (a
  single-member bucket takes the plain ``solve`` path) on the executor,
  with per-request ``RunOptions`` — including ``resilience=`` — passed
  straight through.  The driver's ``progress_fn`` chunk events are
  relayed onto the loop and fanned out per request; the relay's control
  *return* is how the service reaches INTO a running batch: expired or
  cancelled lanes are frozen at the next chunk boundary exactly like
  converged ones, without perturbing sibling trajectories.
- **failure isolation** — a coalesced dispatch that fails as a unit
  (retry/rollback budget exhausted) is *quarantined*: every lane
  re-dispatches solo, so only the offending request fails (with the
  recovery ledger attached) while siblings complete with trajectory
  parity.  A hung dispatch is reaped by the watchdog after
  ``dispatch_timeout_s``.  Outcomes feed a per-workload circuit
  breaker (``serve.breaker``) that sheds load when a workload goes bad.
- **durability** — with ``journal_dir`` set, every admission, bucket
  assignment, and terminal state is logged to a crc-per-record WAL
  (``serve.journal``); a restarted service replays still-owed requests
  and re-dispatches journaled buckets in their original order, resuming
  from per-bucket checkpoints when ``checkpoint_dir`` has them.
- **drain** — stop admitting, *reject* still-queued requests with the
  retriable status, let in-flight batches finish.  ``close()`` drains
  and tears down the executor; ``abandon()`` is the simulated hard
  crash of the kill/restart drill.
- **the card** — every solve runs on the service's ``device`` (``None``
  means ``"cuda"``, resolved when the service is built, so a host
  without a card refuses at once): each worker thread enters
  ``torch.cuda.device`` around its dispatch, since the current device
  is per thread.
- **a mesh** — ``AsyncSolveService(mesh=)`` (a ``DeviceMesh`` from
  ``launch.mesh.make_mesh``) runs every solve across the mesh's ranks,
  on the mesh's device.  The port is SPMD, where the JAX package has one
  controller: rank 0 runs the service (and the HTTP server and the
  journal), every other rank runs :func:`follow`.  Each dispatch goes
  from rank 0 to the followers over the mesh's control plane on the
  host (``core.compat.Control``): its kind (a solo ``solve``, a
  bucket's ``solve_many``, a quarantine's solo re-dispatch, or the
  shutdown), the workload's name and config, the inputs in lane order
  (rank 0 broadcasts them once; ``broadcast_s`` keeps the seconds),
  the options and checkpoint arguments, and the request's chaos spec.
  Lane control (cancel, deadline, the crash freeze) is decided on rank
  0 at each chunk boundary and broadcast there, so every rank freezes
  the same lanes at the same boundary.  A failed call fails on every
  rank (its collectives do), and rank 0 quarantines as without a mesh.

A request carrying ``chaos_spec`` (the fault-injection drill)
always dispatches as its own singleton batch: chaos activation is
process-global, so an injected fault must never share a dispatch with
paying traffic.  Serving-layer chaos (``ServeConfig.chaos_spec``,
points ``serve_admit_drop`` / ``serve_bucket_poison`` /
``serve_crash``) instead lives on a service-owned counter state and
never touches the solve loop's global harness.
"""
from __future__ import annotations

import asyncio
import contextlib
import itertools
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import batching, compat
from repro_torch.core.problem import (Solution, _as_problem,
                                      _config_fingerprint, solve,
                                      solve_many)
from repro_torch.kernels.common import resolve_device
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience.errors import MeshFaultError
from repro_torch.serve.breaker import CircuitBreaker
from repro_torch.serve.metrics import Metrics

#: terminal request states — once here, a record never changes again
TERMINAL = ("done", "failed", "cancelled", "rejected")
#: every state a record can be in
STATES = ("queued", "running") + TERMINAL


@dataclass(frozen=True)
class ServeConfig:
    """Service-level knobs (per-request solver knobs ride each
    :class:`SolveRequest` instead).

    - ``max_queue`` — admission-control cap on queued+running requests;
      beyond it, submits are rejected retriable (closed-loop clients
      back off, the paper's Spark analogue would spill to another
      executor).
    - ``batch_window_s`` — coalescing deadline: how long the first
      request in an open bucket waits for compatible companions before
      the bucket dispatches anyway.  0 disables coalescing (every
      request dispatches solo).  A member with a tight ``deadline_s``
      shortens the wait: the bucket dispatches with at least half the
      request's remaining budget left for the solve.
    - ``max_batch`` — occupancy that dispatches an open bucket early.
    - ``workers`` — executor threads running solves.  The default of 1
      serializes device work (one card); more only help when solves
      block on I/O.
    - ``waste_budget`` — open-bucket padding budget (see
      ``core.batching``); serving defaults looser than ``solve_many``'s
      0.25 because coalescing wins usually beat padding waste.
    - ``quarantine`` — poison-bucket isolation: re-dispatch the lanes of
      a failed coalesced bucket solo so only the offending request
      fails.  Off, a bucket failure fails every member.
    - ``dispatch_timeout_s`` — hung-dispatch watchdog: an in-flight
      batch with no completion after this long is reaped (its requests
      fail, the breaker records the fault).  ``None`` disables.  The
      worker thread is not killed (a thread inside a CUDA call cannot
      be): its dispatch is abandoned and its lane frozen at its next
      chunk boundary.
    - ``breaker_*`` — per-workload circuit breaker (``serve.breaker``):
      sliding-window size, minimum samples before tripping, error-rate
      threshold, and open-state cooldown before the half-open probe.
    - ``journal_dir`` — crash-safe request journal (``serve.journal``):
      admissions/buckets/terminal states WAL'd here; a service started
      over an existing journal replays still-owed work.  ``None``
      disables durability.
    - ``checkpoint_dir`` / ``checkpoint_every`` — per-bucket
      checkpointing for coalesced dispatches (forwarded to
      ``solve_many``); with the journal this is what lets a restart
      *resume* an in-flight bucket instead of recomputing it.
    - ``chaos_spec`` — serving-layer chaos plan (the drills), same
      grammar as ``REPRO_CHAOS`` but only the ``serve_*`` points are
      consumed and the counter state is service-owned.
    """
    max_queue: int = 256
    batch_window_s: float = 0.05
    max_batch: int = 32
    workers: int = 1
    waste_budget: float = 0.5
    history_window: int = 2048
    quarantine: bool = True
    dispatch_timeout_s: Optional[float] = None
    breaker_window: int = 32
    breaker_min_samples: int = 8
    breaker_error_threshold: float = 0.5
    breaker_cooldown_s: float = 5.0
    journal_dir: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    chaos_spec: Optional[str] = None


@dataclass(frozen=True)
class SolveRequest:
    """One client request: exactly the arguments of a ``solve()`` call.

    ``options`` holds run-control overrides (``max_iter``, ``tol``,
    ``chunk``, ``cost_every``, ``resilience=ResilienceConfig(...)``,
    ...); step wiring is always derived from the Problem declaration.
    ``chaos_spec`` arms the fault-injection harness for this request
    only (dispatched solo, see module docstring).  ``deadline_s`` is a
    wall-clock budget from submission: a request still running past it
    is frozen at the next chunk boundary and fails with a deadline
    error (siblings in its bucket are unaffected).
    """
    problem: str
    inputs: Tuple[Any, ...]
    cfg: Any = None
    options: Dict[str, Any] = field(default_factory=dict)
    chaos_spec: Optional[str] = None
    deadline_s: Optional[float] = None


@dataclass
class RequestRecord:
    """Mutable server-side state of one request.

    Written by the service loop and (status/timestamps/result fields)
    by the executor worker running its batch; read by transports.
    ``retriable`` is only meaningful with status ``"rejected"``: the
    request never ran and can be resubmitted verbatim.  ``recovery``
    is the per-request recovery ledger (sliced from the bucket's shared
    report, or the solo re-run's after quarantine).
    """
    id: str
    request: SolveRequest
    status: str = "queued"
    retriable: bool = False
    error: Optional[str] = None
    solution: Optional[Solution] = None
    recovery: Optional[Any] = None
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    batch_size: int = 0
    bucket_key: Optional[str] = None
    replayed: bool = False
    quarantined: bool = False
    cancel_requested: bool = False
    events: List[dict] = field(default_factory=list)
    # loop-side plumbing (not part of the public record)
    done: asyncio.Event = field(default_factory=asyncio.Event, repr=False)
    _waiters: List[asyncio.Future] = field(default_factory=list,
                                           repr=False)
    _token: Optional[int] = field(default=None, repr=False)
    _open: Optional[batching.OpenBucket] = field(default=None, repr=False)
    _lane: Optional["_Lane"] = field(default=None, repr=False)
    # worker-side plumbing: why this lane froze mid-flight, the
    # quarantine solo re-run's failure, and chaos-poisoned inputs
    _frozen_reason: Optional[str] = field(default=None, repr=False)
    _solo_error: Optional[BaseException] = field(default=None, repr=False)
    _inputs_override: Optional[Tuple[Any, ...]] = field(default=None,
                                                        repr=False)

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def public(self) -> dict:
        """JSON-ready status view (no arrays, no Solution)."""
        return {
            "id": self.id, "status": self.status,
            "retriable": self.retriable, "error": self.error,
            "problem": self.request.problem,
            "batch_size": self.batch_size,
            "bucket_key": self.bucket_key,
            "submitted_at": self.submitted_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "latency_s": self.latency_s,
            "deadline_s": self.request.deadline_s,
            "replayed": self.replayed,
            "quarantined": self.quarantined,
            "n_events": len(self.events),
        }


class _Lane:
    """All open buckets of one compatibility key (workload + config +
    run options): requests only coalesce within a lane."""

    def __init__(self, key: str, problem, axes: batching.BatchAxes,
                 planner: batching.OpenBucketPlanner):
        self.key = key
        self.problem = problem          # prototype Problem instance
        self.axes = axes
        self.planner = planner
        # open bucket -> [bucket, records in admission order, timer]
        # (a list: the timer slot is re-armed when a tight-deadline
        # member joins)
        self.pending: Dict[int, List] = {}


class RequestRejected(RuntimeError):
    """Raised by :meth:`AsyncSolveService.submit` at admission time.
    ``retriable`` mirrors the record's flag: the request never ran."""

    def __init__(self, msg: str, record: RequestRecord):
        super().__init__(msg)
        self.record = record
        self.retriable = record.retriable


class AsyncSolveService:
    """The asyncio serving core.  All public coroutines must run on the
    loop that called :meth:`start`; transports on other threads bridge
    via ``asyncio.run_coroutine_threadsafe`` (see ``serve.server``).
    ``device`` is where every solve runs (``None``: ``"cuda"``); with
    ``mesh=`` every solve runs across the mesh, on its device, this
    service on rank 0 and :func:`follow` on the other ranks (module
    docstring)."""

    def __init__(self, config: Optional[ServeConfig] = None, *,
                 mesh=None, device=None):
        self.cfg = config or ServeConfig()
        self.mesh = mesh
        self._ctl = None
        # seconds of each dispatch's broadcast to the followers
        self.broadcast_s: List[float] = []
        if mesh is not None:
            self._ctl = compat.control_of(mesh)
            if self._ctl.rank != 0:
                raise ValueError("AsyncSolveService(mesh=) runs on rank 0 "
                                 "of the mesh; the other ranks run "
                                 "repro_torch.serve.follow(mesh)")
            if int(self.cfg.workers) > 1:
                raise ValueError("under a mesh one worker dispatches "
                                 "(every rank makes the same calls in "
                                 "the same order): workers=1")
            if device is None:
                device = compat.mesh_device(mesh)
        self.device = resolve_device(device)
        self.metrics = Metrics(window=self.cfg.history_window)
        self.records: Dict[str, RequestRecord] = {}
        self._lanes: Dict[str, _Lane] = {}
        # fut id -> (future, records, started_at monotonic)
        self._inflight: Dict[int, Tuple[Any, List[RequestRecord],
                                        float]] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._draining = False
        self._closed = False
        self._crashed = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._watchdog_task: Optional[asyncio.Task] = None
        self._executor = ThreadPoolExecutor(
            max_workers=max(int(self.cfg.workers), 1),
            thread_name_prefix="repro-serve")
        self._tokens = itertools.count()
        self._journal = None
        if self.cfg.journal_dir is not None:
            from repro_torch.serve.journal import RequestJournal
            self._journal = RequestJournal(self.cfg.journal_dir)
        self._chaos = None
        if self.cfg.chaos_spec:
            self._chaos = _chaos.ChaosState(
                _chaos.ChaosConfig.parse(self.cfg.chaos_spec))

    # ----------------------------------------------------------- setup
    async def start(self) -> "AsyncSolveService":
        self._loop = asyncio.get_running_loop()
        if self.cfg.dispatch_timeout_s:
            self._watchdog_task = self._loop.create_task(
                self._watchdog())
            self._watchdog_task.add_done_callback(self._task_exc)
        if self._journal is not None:
            self._replay_journal()
        return self

    @staticmethod
    def _task_exc(task: asyncio.Task) -> None:
        """Done-callback retrieving a background task's exception so it
        is never silently dropped."""
        if not task.cancelled() and task.exception() is not None:
            import traceback
            traceback.print_exception(task.exception())

    async def __aenter__(self) -> "AsyncSolveService":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def crashed(self) -> bool:
        return self._crashed

    # ----------------------------------------------------------- chaos
    def _chaos_fire(self, point: str, tag: Optional[str] = None) -> bool:
        st = self._chaos
        return st.should_fire(point, tag) if st is not None else False

    # ------------------------------------------------------- admission
    async def submit(self, request: SolveRequest) -> RequestRecord:
        """Admit one request: returns its (live) record, or raises
        :class:`RequestRejected` — with ``retriable=True`` when the
        refusal is load/drain-shaped rather than malformed input."""
        assert self._loop is not None, \
            "AsyncSolveService.submit before start()"
        self.metrics.incr("submitted")
        rec = RequestRecord(id=uuid.uuid4().hex[:12], request=request,
                            submitted_at=time.time())
        if self._crashed:
            return self._reject(rec, "service crashed", retriable=True)
        if self._draining or self._closed:
            return self._reject(rec, "service is draining",
                                retriable=True)
        depth = self.metrics.queue_depth
        if depth >= self.cfg.max_queue:
            return self._reject(
                rec, f"queue full ({depth} >= max_queue="
                     f"{self.cfg.max_queue})", retriable=True)
        # malformed requests fail loudly at admission, not in the batch:
        # building the prototype Problem validates workload key + config
        try:
            problem = _as_problem(request.problem, request.cfg)
            lane_key = self._lane_key(problem, request)
        except Exception as e:
            rec.error = f"{type(e).__name__}: {e}"
            return self._reject(rec, rec.error, retriable=False)
        breaker = self._breakers.get(request.problem)
        if breaker is not None and not breaker.allow():
            self.metrics.incr("shed")
            return self._reject(
                rec, f"circuit open for workload {request.problem!r} "
                     f"(recent dispatches failing); retry after "
                     f"cooldown", retriable=True)
        self.records[rec.id] = rec
        self.metrics.incr("accepted")
        self.metrics.queue_delta(+1)
        if self._journal is not None:
            self._journal.admit(rec.id, request)
        if self._chaos_fire("serve_admit_drop"):
            # the crash-between-journal-and-schedule fault: the request
            # is admitted and durable but never scheduled — only a
            # journal replay on restart can recover it
            return rec
        self._schedule(rec, problem, lane_key)
        return rec

    def _schedule(self, rec: RequestRecord, problem,
                  lane_key: str) -> None:
        if rec.request.chaos_spec or self.cfg.batch_window_s <= 0 \
                or self.cfg.max_batch <= 1:
            self._dispatch([rec], problem, bucket_key=None)
        else:
            self._enqueue(rec, problem, lane_key)

    def _reject(self, rec: RequestRecord, why: str,
                *, retriable: bool) -> RequestRecord:
        rec.status = "rejected"
        rec.retriable = retriable
        rec.error = rec.error or why
        rec.finished_at = time.time()
        rec.done.set()
        self.metrics.incr("rejected")
        self.records[rec.id] = rec
        raise RequestRejected(why, rec)

    def _lane_key(self, problem, request: SolveRequest) -> str:
        """Compatibility key: requests coalesce only when the same
        Problem runs under the same run options — one ``RunOptions``
        drives a whole ``solve_many`` call, and the bucket runs the lane's
        first Problem.  The config's ``max_iter`` and ``tol`` are run
        control that the checkpoint fingerprint leaves out, so they join
        the key here: two requests that differ only in them must not
        share a dispatch."""
        opts = ";".join(f"{k}={request.options[k]!r}"
                        for k in sorted(request.options))
        cfg = getattr(problem, "cfg", None)
        run = tuple(getattr(cfg, k, None) for k in ("max_iter", "tol"))
        return (f"{request.problem}|{_config_fingerprint(problem)}|"
                f"{run!r}|{opts}")

    # ---------------------------------------------------------- replay
    def _replay_journal(self) -> None:
        """Restart-and-replay: re-admit every journaled request
        without a terminal record; re-dispatch journaled buckets as a
        group in their original order (same order ⇒ ``solve_many``
        re-plans the same bucket ⇒ same per-bucket checkpoint directory
        to resume from); everything else re-enters coalescing."""
        from repro_torch.serve.journal import RequestJournal
        plan = RequestJournal.replay(self.cfg.journal_dir)
        if not plan.pending:
            return
        recs: Dict[str, RequestRecord] = {}
        for rid, request in plan.pending.items():
            rec = RequestRecord(id=rid, request=request,
                                submitted_at=time.time(), replayed=True)
            self.records[rid] = rec
            recs[rid] = rec
            self.metrics.incr("accepted")
            self.metrics.incr("replayed")
            self.metrics.queue_delta(+1)
        grouped = {rid for _, ids in plan.buckets for rid in ids}
        for key, ids in plan.buckets:
            ordered = [recs[rid] for rid in ids]
            problem = _as_problem(ordered[0].request.problem,
                                  ordered[0].request.cfg)
            for r in ordered:
                r.bucket_key = key
            if self._journal is not None:
                self._journal.bucket(key, ids)
            self._dispatch(ordered, problem, bucket_key=key,
                           resume=self._bucket_resume_available(
                               problem, ordered))
        for rid, rec in recs.items():
            if rid in grouped:
                continue
            try:
                problem = _as_problem(rec.request.problem,
                                      rec.request.cfg)
                lane_key = self._lane_key(problem, rec.request)
            except Exception as e:
                self._fail_now(rec, f"{type(e).__name__}: {e}")
                continue
            self._schedule(rec, problem, lane_key)

    def _bucket_resume_available(self, problem,
                                 recs: List[RequestRecord]) -> bool:
        """Would ``solve_many(resume=True)`` find checkpoints for this
        replayed group?  Pre-computed with the same plan/salt so the
        replay never trips solve_many's loud no-checkpoints error."""
        if not self.cfg.checkpoint_dir or not self.cfg.checkpoint_every:
            return False
        from repro_torch.checkpoint import checkpointer as ckpt
        axes = problem.batch_axes()
        salt = (f"{problem.name or type(problem).__name__}|"
                f"{_config_fingerprint(problem)}")
        plan = batching.plan_buckets(
            [r.request.inputs for r in recs], axes,
            waste_budget=self.cfg.waste_budget, salt=salt)
        return any(
            ckpt.latest_step(Path(self.cfg.checkpoint_dir)
                             / f"bucket_{b.key}") is not None
            for b in plan)

    def _fail_now(self, rec: RequestRecord, error: str) -> None:
        """Terminal failure applied directly on the loop (replay of a
        request that no longer validates, watchdog reaping)."""
        rec.status = "failed"
        rec.error = error
        rec.finished_at = time.time()
        self.metrics.incr("failed")
        self.metrics.queue_delta(-1)
        if self._journal is not None:
            self._journal.done(rec.id, "failed")
        rec.done.set()
        self._wake_waiters(rec)

    # ------------------------------------------------------ scheduling
    def _enqueue(self, rec: RequestRecord, problem, lane_key: str) -> None:
        lane = self._lanes.get(lane_key)
        if lane is None:
            axes = problem.batch_axes()
            salt = f"{lane_key}"
            lane = _Lane(lane_key, problem, axes,
                         batching.OpenBucketPlanner(
                             axes, waste_budget=self.cfg.waste_budget,
                             salt=salt, max_members=self.cfg.max_batch))
            self._lanes[lane_key] = lane
        token = next(self._tokens)
        deadline = (rec.submitted_at + rec.request.deadline_s
                    if rec.request.deadline_s is not None else None)
        bucket = lane.planner.offer(token, rec.request.inputs,
                                    deadline=deadline)
        rec._token, rec._open, rec._lane = token, bucket, lane
        delay = self.cfg.batch_window_s
        earliest = bucket.earliest_deadline
        if earliest is not None:
            # dispatch a tight-deadline bucket early, leaving at least
            # half the member's remaining budget for the solve itself
            delay = max(0.0, min(delay,
                                 (earliest - time.time()) / 2.0))
        entry = lane.pending.get(id(bucket))
        if entry is None:
            # first member arms the coalescing deadline
            timer = self._loop.call_later(
                delay, self._flush_bucket, lane, id(bucket))
            lane.pending[id(bucket)] = [bucket, [rec], timer]
        else:
            entry[1].append(rec)
            if deadline is not None and delay < self.cfg.batch_window_s:
                entry[2].cancel()
                entry[2] = self._loop.call_later(
                    delay, self._flush_bucket, lane, id(bucket))
        if len(bucket) >= self.cfg.max_batch:
            self._flush_bucket(lane, id(bucket))

    def _flush_bucket(self, lane: _Lane, bucket_id: int) -> None:
        entry = lane.pending.pop(bucket_id, None)
        if entry is None:
            return                       # already flushed or cancelled
        bucket, recs, timer = entry
        timer.cancel()
        closed = lane.planner.close(bucket)
        # solve_many receives instances in bucket order; map each back
        token_to_rec = {r._token: r for r in recs}
        ordered = [token_to_rec[t] for t in closed.indices]
        for r in ordered:
            r._open = r._lane = None
            r.bucket_key = closed.key
        if self._journal is not None and len(ordered) > 1:
            self._journal.bucket(closed.key, [r.id for r in ordered])
        self._dispatch(ordered, lane.problem, bucket_key=closed.key)

    def _dispatch(self, recs: List[RequestRecord], problem,
                  *, bucket_key: Optional[str],
                  resume: bool = False) -> None:
        for r in recs:
            r.batch_size = len(recs)
        self.metrics.record_batch(len(recs))
        fut = self._loop.run_in_executor(
            self._executor, self._run_batch, recs, problem, resume)
        key = id(fut)
        self._inflight[key] = (fut, recs, time.monotonic())
        fut.add_done_callback(
            lambda f, _recs=recs: self._on_batch_done(key, _recs, f))

    # -------------------------------------------------- executor side
    def _on_device(self):
        """This worker thread's current device, the service's card."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _run_batch(self, recs: List[RequestRecord], problem,
                   resume: bool = False) -> None:
        """Runs on a worker thread: one solve()/solve_many() for the
        whole batch on the service's device, progress relayed to the
        loop per request, lane control (cancel/deadline/crash) returned
        to the driver at chunk boundaries, and poison-bucket quarantine
        on batch failure."""
        with self._on_device():
            self._run_batch_here(recs, problem, resume)

    def _run_batch_here(self, recs: List[RequestRecord], problem,
                        resume: bool) -> None:
        now = time.time()
        for r in recs:
            r.status = "running"
            r.started_at = now
            if self._chaos_fire("serve_bucket_poison"):
                r._inputs_override = _poison_inputs(r.request.inputs)

        if len(recs) == 1:
            recs[0].solution = self._solve_one(recs[0], problem,
                                               self._relay_for(recs[0]))
            return
        opts = dict(recs[0].request.options)
        kwargs: Dict[str, Any] = {}
        if self.cfg.checkpoint_dir and self.cfg.checkpoint_every:
            opts.setdefault("checkpoint_every", self.cfg.checkpoint_every)
            kwargs["checkpoint_dir"] = self.cfg.checkpoint_dir
            kwargs["resume"] = resume
        kwargs["waste_budget"] = self.cfg.waste_budget
        inputs = [r._inputs_override or r.request.inputs for r in recs]
        self._announce("solve_many", recs[0].request, inputs, opts, kwargs)
        try:
            sols = solve_many(
                problem, inputs, device=self.device, mesh=self.mesh,
                progress_fn=self._relay_for_batch(recs), **kwargs, **opts)
        except Exception as err:
            if not self.cfg.quarantine or self._crashed or \
                    isinstance(err, MeshFaultError):
                raise
            self._quarantine(recs, problem, err)
            return
        for r, s in zip(recs, sols):
            r.solution = s

    def _solve_one(self, rec: RequestRecord, problem, relay,
                   kind: str = "solve") -> Solution:
        opts = dict(rec.request.options)
        inputs = rec._inputs_override or rec.request.inputs
        spec = rec.request.chaos_spec
        self._announce(kind, rec.request, [inputs], opts, {}, spec)
        with _chaos_context(spec):
            return solve(problem, *inputs, device=self.device,
                         mesh=self.mesh, progress_fn=relay, **opts)

    # ------------------------------------------------ the followers
    def _announce(self, kind: str, request: SolveRequest, inputs, opts,
                  kwargs, chaos_spec: Optional[str] = None) -> None:
        """Under a mesh, send the dispatch to the followers (module
        docstring); the inputs leave as host arrays, once."""
        if self._ctl is None:
            return
        self.broadcast_s.append(_send_dispatch(self._ctl, {
            "kind": kind, "problem": request.problem, "cfg": request.cfg,
            "inputs": [_host_inputs(x) for x in inputs],
            "options": opts, "kwargs": kwargs, "chaos": chaos_spec}))

    def _control(self, ctl):
        """Under a mesh, rank 0's lane control for this chunk boundary,
        broadcast so that every rank's driver gets the same."""
        if self._ctl is None:
            return ctl
        return self._ctl.broadcast(ctl)

    def _quarantine(self, recs: List[RequestRecord], problem,
                    err: BaseException) -> None:
        """Poison-bucket isolation: the coalesced dispatch failed
        as a unit, so re-dispatch each lane *solo* — only the offending
        request(s) fail, with the failure's recovery ledger attached,
        while siblings complete with trajectory parity (per-instance
        bundles are built unpadded, so a solo re-run replays the exact
        single-solve trajectory).  Runs inline on the worker thread."""
        self.metrics.incr("quarantined")
        bucket_report = getattr(err, "report", None)
        for r in recs:
            r.quarantined = True
            if self._crashed:
                return
            if r.status in TERMINAL or r._frozen_reason is not None:
                continue
            try:
                r.solution = self._solve_one(r, problem,
                                             self._relay_for(r),
                                             kind="quarantine")
            except MeshFaultError:
                raise
            except Exception as solo:
                r._solo_error = solo
                rep = getattr(solo, "report", None)
                r.recovery = rep if rep is not None else bucket_report

    # ------------------------------------------------ progress control
    def _relay_for(self, rec: RequestRecord):
        """Per-chunk relay + control for a solo dispatch: push the
        event to the loop, then tell the driver to stop when the
        service crashed (chaos drill), the request was cancelled, or
        its deadline expired.  Runs on the worker thread."""
        loop = self._loop

        def decide(event):
            loop.call_soon_threadsafe(self._push_event, rec, event)
            if self._chaos_fire("serve_crash"):
                self._crashed = True
            if self._crashed:
                return {"stop": True}
            if rec.status in TERMINAL:
                # reaped by the watchdog: stop burning compute
                return {"stop": True}
            if rec._frozen_reason is None:
                if rec.cancel_requested:
                    rec._frozen_reason = "cancelled"
                elif _deadline_exceeded(rec):
                    rec._frozen_reason = "expired"
            if rec._frozen_reason is not None:
                return {"stop": True}
            return None

        return lambda event: self._control(decide(event))

    def _relay_for_batch(self, recs: List[RequestRecord]):
        """Batched relay + control: fan the per-instance sections out
        per request, then return the set of lanes to freeze (cancelled
        or expired) — the driver retires them at this chunk boundary
        exactly like converged lanes, siblings unperturbed."""
        loop = self._loop

        def decide(event):
            base = {k: v for k, v in event.items()
                    if k != "instances"}
            for j, st in event.get("instances", {}).items():
                loop.call_soon_threadsafe(
                    self._push_event, recs[j], {**base, **st})
            if self._chaos_fire("serve_crash"):
                self._crashed = True
            if self._crashed:
                return {"stop": True}
            now = time.time()
            cancel = []
            for j, r in enumerate(recs):
                if r._frozen_reason is not None:
                    continue
                if r.status in TERMINAL:
                    # reaped by the watchdog: freeze the lane so it
                    # stops burning compute
                    r._frozen_reason = "reaped"
                    cancel.append(j)
                elif r.cancel_requested:
                    r._frozen_reason = "cancelled"
                    cancel.append(j)
                elif _deadline_exceeded(r, now):
                    r._frozen_reason = "expired"
                    cancel.append(j)
            return {"cancel_instances": cancel} if cancel else None

        return lambda event: self._control(decide(event))

    # ------------------------------------------------------- loop side
    def _push_event(self, rec: RequestRecord, event: dict) -> None:
        if rec.status in TERMINAL:
            return
        rec.events.append(event)
        self._wake_waiters(rec)

    def _wake_waiters(self, rec: RequestRecord) -> None:
        for w in rec._waiters:
            if not w.done():
                w.set_result(None)
        rec._waiters.clear()

    def _breaker(self, problem_name: str) -> CircuitBreaker:
        b = self._breakers.get(problem_name)
        if b is None:
            b = CircuitBreaker(
                window=self.cfg.breaker_window,
                min_samples=self.cfg.breaker_min_samples,
                error_threshold=self.cfg.breaker_error_threshold,
                cooldown_s=self.cfg.breaker_cooldown_s)
            self._breakers[problem_name] = b
        return b

    def breaker_states(self) -> Dict[str, dict]:
        return {k: b.snapshot() for k, b in self._breakers.items()}

    def ready(self) -> Tuple[bool, dict]:
        """Readiness verdict for ``/v1/readyz``: can this service
        usefully accept traffic right now?  (Liveness — ``/v1/healthz``
        — stays true while draining; readiness does not.)"""
        open_breakers = [k for k, b in self._breakers.items()
                         if b.state != "closed"]
        depth = self.metrics.queue_depth
        detail = {"draining": self._draining, "crashed": self._crashed,
                  "closed": self._closed,
                  "queue_depth": depth, "max_queue": self.cfg.max_queue,
                  "open_breakers": open_breakers}
        ok = (not self._draining and not self._closed
              and not self._crashed and depth < self.cfg.max_queue
              and not open_breakers)
        return ok, detail

    def _on_batch_done(self, key: int, recs: List[RequestRecord],
                       fut) -> None:
        self._inflight.pop(key, None)
        if self._crashed:
            # simulated hard crash: a real dead process journals and
            # finalizes nothing — restart-and-replay owns these records
            return
        err = None if fut.cancelled() else fut.exception()
        now = time.time()
        for r in recs:
            if r.status in TERMINAL:
                continue
            r.finished_at = now
            ok = True
            if r._frozen_reason == "cancelled":
                r.status = "cancelled"
                r.error = "cancelled in flight (lane frozen at chunk " \
                          "boundary)"
                self.metrics.incr("cancelled")
            elif r._frozen_reason == "expired":
                r.status = "failed"
                r.error = (f"deadline_s={r.request.deadline_s} exceeded "
                           f"(lane frozen at chunk boundary)")
                self.metrics.incr("expired")
                self.metrics.incr("failed")
            elif r._solo_error is not None:
                ok = False
                r.status = "failed"
                r.error = (f"{type(r._solo_error).__name__}: "
                           f"{r._solo_error}")
                self.metrics.incr("failed")
            elif err is not None:
                ok = False
                r.status = "failed"
                r.error = f"{type(err).__name__}: {err}"
                if r.recovery is None:
                    r.recovery = getattr(err, "report", None)
                self.metrics.incr("failed")
            else:
                r.status = "done"
                self.metrics.incr("completed")
                self.metrics.record_latency(r.latency_s)
                sol = r.solution
                if sol is not None and sol.recovery is not None \
                        and r.recovery is None:
                    # the bucket's report is shared across lanes: slice
                    # it to what this lane could have witnessed
                    last = (sol.log.converged_at
                            if sol.log.converged_at is not None
                            else sol.log.cancelled_at)
                    r.recovery = sol.recovery.for_range(last)
            if r.recovery is not None:
                # terminal, so _push_event would drop it — append
                # directly; the ndjson stream drains remaining events
                # before writing its end line
                r.events.append({"kind": "recovery",
                                 **r.recovery.to_json()})
            self._breaker(r.request.problem).record(ok, r.latency_s)
            if self._journal is not None:
                self._journal.done(r.id, r.status)
            self.metrics.queue_delta(-1)
            r.done.set()
            self._wake_waiters(r)

    # -------------------------------------------------------- watchdog
    async def _watchdog(self) -> None:
        """Reap hung dispatches: an in-flight batch older than
        ``dispatch_timeout_s`` fails its requests and feeds the breaker.
        The worker thread cannot be killed — one inside a CUDA call
        least of all — so its dispatch is abandoned: its relay stops the
        run at the next chunk boundary, and its eventual completion is a
        no-op against the already-terminal records."""
        timeout = float(self.cfg.dispatch_timeout_s)
        interval = max(min(timeout / 4.0, 1.0), 0.01)
        while not self._closed:
            await asyncio.sleep(interval)
            if self._crashed:
                continue
            now = time.monotonic()
            for key, (fut, recs, t0) in list(self._inflight.items()):
                if fut.done() or (now - t0) <= timeout:
                    continue
                self._inflight.pop(key, None)
                self.metrics.incr("hung")
                for r in recs:
                    if r.status in TERMINAL:
                        continue
                    self._breaker(r.request.problem).record(False)
                    self._fail_now(
                        r, f"hung dispatch: no completion after "
                           f"{now - t0:.1f}s (dispatch_timeout_s="
                           f"{timeout})")

    # --------------------------------------------------------- queries
    def record(self, request_id: str) -> RequestRecord:
        try:
            return self.records[request_id]
        except KeyError:
            raise KeyError(f"unknown request id {request_id!r}") from None

    async def result(self, request_id: str,
                     timeout: Optional[float] = None) -> RequestRecord:
        """Wait for a terminal state and return the record."""
        rec = self.record(request_id)
        await asyncio.wait_for(rec.done.wait(), timeout)
        return rec

    async def wait_events(self, request_id: str, cursor: int = 0,
                          timeout: float = 1.0
                          ) -> Tuple[List[dict], bool, int]:
        """Long-poll progress: events past ``cursor`` (possibly empty on
        timeout), whether the request is terminal, and the new cursor.
        This is the transport-friendly streaming primitive — the HTTP
        endpoint loops it and writes JSON lines."""
        rec = self.record(request_id)
        if cursor >= len(rec.events) and not rec.done.is_set():
            waiter = self._loop.create_future()
            rec._waiters.append(waiter)
            try:
                await asyncio.wait_for(waiter, timeout)
            except asyncio.TimeoutError:
                pass
            finally:
                if waiter in rec._waiters:
                    rec._waiters.remove(waiter)
        events = rec.events[cursor:]
        return events, rec.done.is_set(), cursor + len(events)

    async def cancel(self, request_id: str) -> bool:
        """Cancel a request.  Queued: withdrawn from its open bucket
        and terminal immediately.  Running: flagged — the dispatch
        relay freezes its lane at the next chunk boundary (siblings
        unperturbed) and the record goes terminal when the freeze
        lands.  Terminal: returns False."""
        rec = self.record(request_id)
        if rec.status == "running":
            if rec.cancel_requested or rec._frozen_reason is not None:
                return False
            rec.cancel_requested = True
            return True
        if rec.status != "queued" or rec._open is None:
            return False
        lane = rec._lane
        lane.planner.discard(rec._open, rec._token)
        entry = lane.pending.get(id(rec._open))
        if entry is not None:
            _, recs, timer = entry
            recs.remove(rec)
            if not recs:
                timer.cancel()
                lane.pending.pop(id(rec._open), None)
        rec._open = rec._lane = None
        rec.status = "cancelled"
        rec.finished_at = time.time()
        rec.done.set()
        self.metrics.incr("cancelled")
        self.metrics.queue_delta(-1)
        if self._journal is not None:
            self._journal.done(rec.id, "cancelled")
        self._wake_waiters(rec)
        return True

    # ----------------------------------------------------------- drain
    async def drain(self) -> dict:
        """Graceful shutdown of traffic: stop admitting, reject every
        still-queued request with the retriable status, and wait for
        in-flight batches to finish.  Returns a summary dict."""
        self._draining = True
        rejected = 0
        for lane in self._lanes.values():
            for bucket, recs, timer in list(lane.pending.values()):
                timer.cancel()
                for rec in recs:
                    lane.planner.discard(bucket, rec._token)
                    rec._open = rec._lane = None
                    rec.status = "rejected"
                    rec.retriable = True
                    rec.error = "service drained before dispatch"
                    rec.finished_at = time.time()
                    rec.done.set()
                    self.metrics.incr("rejected")
                    self.metrics.queue_delta(-1)
                    if self._journal is not None:
                        self._journal.done(rec.id, "rejected")
                    self._wake_waiters(rec)
                    rejected += 1
            lane.pending.clear()
        inflight = [f for (f, _, _) in self._inflight.values()]
        if inflight:
            await asyncio.gather(*inflight, return_exceptions=True)
        return {"rejected_queued": rejected,
                "finished_inflight": len(inflight)}

    async def close(self) -> None:
        """Drain, then tear down the worker executor; under a mesh the
        followers' :func:`follow` returns."""
        if not self._closed:
            await self.drain()
            self._closed = True
            if self._watchdog_task is not None:
                self._watchdog_task.cancel()
            if self._ctl is not None and self._ctl.fault() is None:
                self._executor.submit(_send_dispatch, self._ctl,
                                      {"kind": "shutdown"}).result()
            self._executor.shutdown(wait=True)
            if self._journal is not None:
                self._journal.close()

    async def abandon(self) -> None:
        """Simulated hard crash (the kill/restart drill): stop
        admitting, tell in-flight dispatches to stop at their next
        chunk boundary, and tear down WITHOUT journaling terminal
        states or rejecting queued work — a dead process writes
        nothing, so a service restarted over the same ``journal_dir``
        owes exactly what this one abandoned."""
        self._crashed = True
        self._closed = True
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
        inflight = [f for (f, _, _) in self._inflight.values()]
        if inflight:
            await asyncio.gather(*inflight, return_exceptions=True)
        self._executor.shutdown(wait=True)
        if self._journal is not None:
            self._journal.close()


def _chaos_context(spec: Optional[str]):
    return _chaos.active_chaos(_chaos.ChaosConfig.parse(spec)) \
        if spec else contextlib.nullcontext()


def _host_inputs(inputs: Tuple[Any, ...]) -> Tuple[Any, ...]:
    """An instance's inputs as host arrays (a trailing draws dict
    too)."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return x

    return tuple(host(x) for x in inputs)


def _send_dispatch(ctl, message: dict) -> float:
    """Rank 0: wake the followers (through the store, which waits without
    a time limit) and broadcast ``message`` on the control group;
    returns the broadcast's seconds."""
    ctl.next_dispatch()
    t0 = time.perf_counter()
    ctl.broadcast(message)
    return time.perf_counter() - t0


def follow(mesh, device=None) -> List[Tuple[str, Any]]:
    """Every rank of a served mesh but rank 0: make each call rank 0's
    service dispatches, on the same mesh, until it shuts down.  Returns
    what each dispatch did on this rank, in order: its kind and its
    Solution's log (a list of them for a bucket), or the exception the
    call raised (without its traceback).  Only the logs are kept: the
    Solutions are rank 0's to return, and a follower of a long-lived
    service would otherwise hold a copy of every result.

    A dispatch (module docstring) arrives over the mesh's control plane;
    its ``progress_fn`` takes rank 0's lane control at each chunk
    boundary, so this rank freezes the same lanes at the same boundary.
    A call that fails here fails on rank 0 too (the collectives do), and
    rank 0 goes on (quarantine); so does this rank.  A mesh fault ends
    the loop with :class:`~repro_torch.resilience.errors.MeshFaultError`.
    ``device=None`` means the mesh's card (``"cuda"``)."""
    ctl = compat.control_of(mesh)
    if ctl.rank == 0:
        raise ValueError("serve.follow runs on the ranks other than 0; "
                         "rank 0 runs the service (AsyncSolveService or "
                         "serve_http with mesh=)")
    dev = resolve_device(device)
    done: List[Tuple[str, Any]] = []
    while True:
        ctl.await_dispatch()
        msg = ctl.broadcast()
        if msg["kind"] == "shutdown":
            return done
        problem = _as_problem(msg["problem"], msg["cfg"])

        def control(event):
            return ctl.broadcast(None)

        try:
            with _chaos_context(msg["chaos"]):
                if msg["kind"] == "solve_many":
                    out = [s.log for s in solve_many(
                        problem, msg["inputs"], device=dev, mesh=mesh,
                        progress_fn=control, **msg["kwargs"],
                        **msg["options"])]
                else:
                    out = solve(problem, *msg["inputs"][0], device=dev,
                                mesh=mesh, progress_fn=control,
                                **msg["options"]).log
        except MeshFaultError:
            raise
        except Exception as err:
            if ctl.fault() is not None:
                raise
            # rank 0's call failed the same way: it carries on
            out, seen = err, set()
            while err is not None and id(err) not in seen:
                seen.add(id(err))
                err.__traceback__ = None    # its frames hold the run's tensors
                err = err.__cause__ or err.__context__
        done.append((msg["kind"], out))


def _deadline_exceeded(rec: RequestRecord,
                       now: Optional[float] = None) -> bool:
    d = rec.request.deadline_s
    if d is None:
        return False
    return ((now if now is not None else time.time())
            - rec.submitted_at) > d


def _poison_inputs(inputs: Tuple[Any, ...]) -> Tuple[Any, ...]:
    """NaN-poison the first float input (a numpy array or a tensor, on
    any device; a copy, the request's own input untouched) — the
    serve-level analogue of ``chaos.poison_tree``, applied to a
    request's inputs before dispatch (``serve_bucket_poison``).  The
    poison survives a quarantine re-dispatch: the lane is broken, not
    the bucket."""
    out = list(inputs)
    for i, x in enumerate(out):
        if isinstance(x, torch.Tensor):
            if not x.is_floating_point():
                continue
            t = x.detach().contiguous().clone()
            t.view(-1)[0] = float("nan")
            out[i] = t
            break
        if isinstance(x, dict):
            continue
        a = np.asarray(x)
        if np.issubdtype(a.dtype, np.floating):
            a = a.copy()
            a.reshape(-1)[0] = np.nan
            out[i] = a
            break
    return tuple(out)
