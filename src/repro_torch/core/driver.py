"""IterativeDriver and BatchedDriver: the paper's driver program on one
device.

Port of ``repro.core.driver``.  Both drivers run one loop over chunks
(:meth:`_ChunkLoop.run`): K iterations per dispatch through
``core.engine``'s scan steps, then one host sync that brings the
chunk's ``(K,)`` cost trace (``(K, B)`` for a bucket), and the chunk's
bookkeeping.  ``chunk=1`` runs the scan step of one iteration.

Kept exactly: the chunk clamped to ``max_iter``; the convergence rule
with its stride (costs ``cost_window x stride`` apart when the log
repeats skipped objectives); ``progress_fn`` and its ``{"stop": True}``
control; the straggler watchdog, which leaves each chunk length's first
call out (it includes the kernel build and FFT plan creation); the
runtime checks (``core.checks``: the initial state, the carry contract
on ``meta`` tensors before the first dispatch, then the costs and the
state at every host sync) and the checkpoint hook with its cadence rules
(clamped to ``max_iter``; a chunk that crosses a multiple of the cadence
checkpoints its final state).  Off, the checks add no operation and no
sync.

What differs between the drivers sits behind the loop's hooks: the
launch (under the ``driver.launch`` span, the ``dispatch`` fault point
first), the state the finite flag reads, the record of a chunk, the
checkpoint payload, the decision at the chunk's end, and the snapshot
and restore that a rollback uses.  :class:`IterativeDriver` runs one
solve: one log with the straggler watchdog, convergence and ``stop``.
:class:`BatchedDriver` runs one bucket of ``solve_many``: per-instance
logs and convergence, an active mask, re-compaction, the
``cancel_instances`` control and the full-bucket checkpoint payload.

Supervision (``RunOptions.resilience``, ``resilience.supervisor``):
each chunk's start is pushed onto a ring (the driver's snapshot, which
holds references), the dispatch is retried on transient faults, and a
non-finite objective or state rolls the run back (ring first, then the
newest valid checkpoint).  The state is judged by one device reduction
that reaches the host with the chunk's costs, so a supervised chunk
still syncs once; under a mesh the ranks' verdicts are summed in one
all-reduce before that transfer, and every recovery decision is taken
by every rank together.  The plain and the supervised dispatch are one
function that differs in the flag it carries with the costs; the chaos
fault points ``dispatch`` and ``carry_nan`` sit in it and, off, each
costs one ``is None`` check.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field, fields, replace
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import checks as _checks
from repro_torch.core import compat
from repro_torch.core import persistence as _persist
from repro_torch.core.bundle import Bundle
from repro_torch.core.compat import NO_AXES, Axes
from repro_torch.core.engine import (init_batched_cost_like,
                                     init_batched_out_like,
                                     make_batched_chunk_cost_step,
                                     make_batched_scan_step,
                                     make_chunk_cost_step, make_scan_step,
                                     state_axes)
from repro_torch.core.spans import span
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience.errors import DivergenceError
from repro_torch.resilience.recovery import ResilienceConfig
from repro_torch.resilience.supervisor import (Supervisor, finite_flag,
                                               host_costs_and_flag,
                                               mesh_flag)


@dataclass(frozen=True)
class RunOptions:
    """Everything the driver needs beyond ``(step_fn, bundle)``.

    Run control (iteration budget, convergence, chunking, observability)
    plus step wiring (the cost-free and objective-only step variants and
    the broadcast-update hook), as in the JAX package.  ``cost_every``
    is a positive int (requires ``step_fn_light`` when > 1) or
    ``"chunk"`` (one evaluation per chunk; requires ``step_fn_cost``).
    ``progress_fn`` is called at every chunk boundary with a progress
    event; a dict return ``{"stop": True}`` halts the run there (and, for
    a bucket, ``{"cancel_instances": [j, ...]}`` freezes those instances).
    ``checkpoint_fn(state, i)`` is called every ``checkpoint_every``
    iterations; ``checks`` turns on the runtime checks (also through
    ``REPRO_CHECKS`` in ``solve``); ``resilience`` supervises the run
    (retry, divergence rollback, ``RecoveryReport``).  Off, checks and
    supervision add no operation and no sync.
    """
    # run control
    max_iter: int = 300
    tol: float = 1e-4
    chunk: int = 8
    cost_every: Union[int, str] = 1
    cost_window: int = 3
    straggler_factor: float = 3.0
    checkpoint_every: int = 0
    checkpoint_fn: Optional[Callable] = None
    checks: bool = False
    resilience: Optional[ResilienceConfig] = None
    progress_fn: Optional[Callable] = None
    # step wiring
    step_fn_light: Optional[Callable] = None
    step_fn_cost: Optional[Callable] = None
    update_replicated: Optional[Callable] = None
    light_updates_replicated: bool = False

    def __post_init__(self):
        if isinstance(self.cost_every, str):
            if self.cost_every != "chunk":
                raise ValueError(
                    f'cost_every must be a positive int or the string '
                    f'"chunk", got {self.cost_every!r}')
        elif int(self.cost_every) <= 0:
            raise ValueError(
                f'cost_every must be a positive int or the string '
                f'"chunk", got {self.cost_every!r} (0 or negative would '
                f'never evaluate the objective)')
        if int(self.chunk) <= 0:
            raise ValueError(
                f"chunk must be a positive int (iterations fused per "
                f"dispatch), got {self.chunk!r}")

    def merged_with(self, **overrides) -> "RunOptions":
        """A copy with the non-None entries of ``overrides`` applied."""
        return replace(self, **{k: v for k, v in overrides.items()
                                if v is not None})


_RUN_OPTION_NAMES = tuple(f.name for f in fields(RunOptions))


def percentiles(values, qs=(50, 90, 99)) -> Dict[str, float]:
    """``{"p50": ..., "p90": ..., "p99": ...}`` summary of a sample;
    empty input gives an empty dict."""
    vals = np.asarray(list(values), dtype=np.float64)
    if vals.size == 0:
        return {}
    return {f"p{int(q) if float(q).is_integer() else q}":
            float(np.percentile(vals, q)) for q in qs}


@dataclass
class RunLog:
    costs: List[float] = field(default_factory=list)
    times: List[float] = field(default_factory=list)
    straggler_steps: List[int] = field(default_factory=list)
    converged_at: Optional[int] = None
    iters_run: Optional[int] = None
    # set when a progress_fn control return halted the run
    cancelled_at: Optional[int] = None

    @property
    def total_seconds(self) -> float:
        return float(np.sum(self.times)) if self.times else 0.0

    def percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        """Percentiles (seconds) of the per-iteration wall times (each
        chunk's time is spread over its iterations)."""
        return percentiles(self.times, qs)


def _host_costs(trace) -> np.ndarray:
    """The one host sync of a chunk: copy its cost trace to the host."""
    costs = trace["cost"] if isinstance(trace, dict) else trace
    with span("driver.sync"):
        return costs.detach().cpu().numpy()


class _ChunkLoop:
    """The loop over chunks that both drivers run (:meth:`run`), and the
    options it resolves once.  A driver keeps its carry in ``state`` and
    implements the loop's hooks:

    - ``_begin(start_iter)``: the checks before any dispatch, the start;
    - ``_live()``: whether anything is left to run;
    - ``_launch(i, k)``: enqueue the chunk under ``driver.launch``, the
      ``dispatch`` fault point first -> ``(state, device cost trace)``;
    - ``_poison(state, i)``: the ``carry_nan`` fault point;
    - ``_state_tree(state)``: the tree the finite flag and checks read,
      and ``_live_costs(costs)`` the costs the checks read;
    - ``_record(costs, dt, i, k, first_call)``: the chunk's log;
    - ``_checkpoint_payload()``: what ``checkpoint_fn`` receives;
    - ``_end_chunk(start, k, dt)``: the decision at the chunk's end;
    - ``_result(start_iter, i)``: what :meth:`run` returns;

    and the supervisor's, through which alone it rewinds a driver:
    ``snapshot()``, ``restore(snap)``, ``restore_checkpoint(directory,
    step)`` and ``map_replicated(fn)``."""

    #: what a run is called in the messages of the checks and the
    #: supervisor ("" for one solve, "bucket " for a bucket)
    _KIND = ""

    def __init__(self, options: RunOptions):
        self.options = o = options
        # a chunk longer than the whole run would never run whole —
        # clamp so the chunk that runs is the one that was asked for
        self.chunk = max(min(int(o.chunk), max(int(o.max_iter), 1)), 1)
        # the same clamp for the checkpoint cadence (0 stays off): a
        # cadence longer than the run would never fire, and the final
        # state is what a resume needs
        self.checkpoint_every = (min(int(o.checkpoint_every),
                                     max(int(o.max_iter), 1))
                                 if o.checkpoint_every else 0)
        if o.cost_every == "chunk":
            if o.step_fn_cost is None or o.step_fn_light is None:
                raise ValueError(
                    'cost_every="chunk" requires step_fn_cost (a '
                    "standalone objective over the post-iteration "
                    "state) AND step_fn_light (the cost-free step)")
            self.cost_every = 1
        else:
            if o.step_fn_cost is not None:
                raise ValueError(
                    "step_fn_cost is only consumed by the per-chunk "
                    'objective mode — pass cost_every="chunk" with it, '
                    f"not cost_every={o.cost_every!r}")
            self.cost_every = max(int(o.cost_every), 1)
        # the chunk-granular objective; a chunk of one iteration
        # evaluates it every iteration anyway, through the plain scan
        self._cost_per_chunk = o.cost_every == "chunk" and self.chunk > 1
        self._skips_cost = (self.cost_every > 1
                            and o.step_fn_light is not None)
        # with cost skipping the log repeats each evaluated objective:
        # the convergence rule compares costs cost_window *evaluations*
        # apart
        self._stride = (self.chunk if self._cost_per_chunk
                        else self.cost_every if self._skips_cost else 1)
        # the supervised run's RecoveryReport (None when unsupervised)
        self.recovery = None
        self._steps: Dict[int, Callable] = {}

    def _scan_step(self, k: int) -> Callable:
        """The K-iteration step, built once per chunk length."""
        if k not in self._steps:
            self._steps[k] = self._build_step(k)
        return self._steps[k]

    def _converged(self, costs: List[float]) -> bool:
        """The convergence rule over one log's costs: the relative change
        over ``cost_window`` evaluations is at most ``tol``."""
        tol = self.options.tol
        if not tol:
            return False
        w = self.options.cost_window * self._stride
        if len(costs) <= w:
            return False
        prev, cur = costs[-w - 1], costs[-1]
        return abs(prev - cur) <= tol * max(abs(prev), 1e-12)

    # -------------------------------------------------------------- run
    def run(self, start_iter: int = 0):
        """Run chunks from ``start_iter`` until ``max_iter``, convergence
        or a stop; one host sync a chunk."""
        o = self.options
        self._begin(start_iter)
        sup = None
        if o.resilience is not None:
            sup = Supervisor(o.resilience, self, self._mesh,
                             f"{self._KIND}chunk")
        seen_ks = set()
        i = start_iter
        while i < o.max_iter and self._live():
            k = min(self.chunk, o.max_iter - i)
            first_call = k not in seen_ks
            seen_ks.add(k)
            t0 = time.perf_counter()
            if sup is not None:
                # the snapshot, the dispatch with its retries, and the
                # verdict; a divergence rewinds the run and goes on from
                # the iteration restored
                sup.begin_chunk(i)
                try:
                    state, costs, finite = sup.dispatch(self._dispatch, i, k)
                    sup.validate(costs, finite, self._state_tree(state),
                                 i + k - 1)
                except DivergenceError as e:
                    sup.report.wall_time_lost_s += \
                        time.perf_counter() - t0
                    i = sup.rollback(e)
                    continue
            else:
                state, costs, _ = self._dispatch(i, k, flagged=False)
            self.state = state
            dt = time.perf_counter() - t0
            if o.checks:
                _checks.assert_costs_finite(
                    self._live_costs(costs),
                    f"{self._KIND}chunk ending at iteration {i + k - 1}")
                _checks.assert_all_finite(
                    self._state_tree(state),
                    f"{self._KIND}state after iteration {i + k - 1}")
            self._record(costs, dt, i, k, first_call)
            # a chunk that crosses a multiple of the cadence checkpoints
            # its final state
            if (self.checkpoint_every and o.checkpoint_fn is not None
                    and (i + k) // self.checkpoint_every
                    > i // self.checkpoint_every):
                o.checkpoint_fn(self._checkpoint_payload(), i + k - 1)
            self._end_chunk(i, k, dt)
            i += k
        if sup is not None:
            self.recovery = sup.finalize()
        return self._result(start_iter, i)

    def _dispatch(self, i: int, k: int, flagged: bool = True):
        """One chunk: its launch, the ``carry_nan`` fault point, and the
        chunk's one host sync, which brings its costs and, ``flagged``
        (supervised), the state's finite flag in the same transfer
        (under a mesh every rank's, summed in one all-reduce).  Returns
        ``(state, costs, finite)``; the driver's ``state`` is committed
        by the loop, so a retry starts again from the chunk's start."""
        state, costs = self._launch(i, k)
        if _chaos.is_active():
            state = self._poison(state, i)
        if not flagged:
            return state, _host_costs(costs), True
        flag = finite_flag(self._state_tree(state))
        if self._mesh:
            flag = mesh_flag(flag, self._mesh, self.device)
        costs, finite = host_costs_and_flag(costs, flag)
        return state, costs, finite

    def _live_costs(self, costs: np.ndarray) -> np.ndarray:
        return costs


class IterativeDriver(_ChunkLoop):
    """Drive ``step_fn(data, rep, axes) -> (data', out)`` until the
    relative cost change drops below ``tol`` or ``max_iter`` is hit.
    ``out`` is a scalar cost or a dict with a ``"cost"`` entry.

    The configuration is one :class:`RunOptions`.  The individual
    keyword arguments of old (``max_iter=``, ``step_fn_light=``, ...)
    are still taken, deprecated: they are mapped onto ``options`` with a
    ``DeprecationWarning``, and a name that is no field raises
    ``TypeError``.  The carry ``state`` is ``(data, replicated, last)``,
    ``last`` the carried output (``None``: the +inf seed)."""

    def __init__(self, step_fn: Callable, bundle: Bundle, *,
                 options: Optional[RunOptions] = None, **legacy):
        if legacy:
            unknown = set(legacy) - set(_RUN_OPTION_NAMES)
            if unknown:
                raise TypeError(
                    f"IterativeDriver got unexpected kwargs "
                    f"{sorted(unknown)}; valid RunOptions fields: "
                    f"{list(_RUN_OPTION_NAMES)}")
            warnings.warn(
                "passing IterativeDriver configuration as individual "
                f"kwargs ({sorted(legacy)}) is deprecated; pass "
                "options=RunOptions(...) instead", DeprecationWarning,
                stacklevel=2)
            options = replace(options or RunOptions(), **legacy)
        super().__init__(options or RunOptions())
        self.bundle = bundle
        self.step_fn = step_fn
        self.device = bundle.device
        self._mesh = bundle.axes
        self.log = RunLog()

    def _build_step(self, k: int) -> Callable:
        o = self.options
        if self._cost_per_chunk:
            return make_chunk_cost_step(
                o.step_fn_light, o.step_fn_cost, chunk=k,
                update_replicated=o.update_replicated, axes=self.bundle.axes)
        return make_scan_step(
            self.step_fn, chunk=k, update_replicated=o.update_replicated,
            fn_light=o.step_fn_light, cost_every=self.cost_every,
            light_updates_replicated=o.light_updates_replicated,
            axes=self.bundle.axes)

    def _progress_event(self, start: int, k: int, dt: float) -> dict:
        return {"kind": "chunk", "start": int(start), "iters": int(k),
                "done": int(start + k),
                "cost": (self.log.costs[-1] if self.log.costs else None),
                "dt_s": float(dt),
                "converged_at": self.log.converged_at}

    def _assert_contracts(self, start_iter: int) -> None:
        """checks=True before the first dispatch: the initial state is
        finite, and the scan step's carry keeps its structure, shapes and
        dtypes — found by running the step on ``meta`` tensors."""
        data, rep = self.bundle.data, self.bundle.replicated
        _checks.assert_all_finite({"data": data, "replicated": rep},
                                  "initial bundle state")
        k = min(self.chunk, max(self.options.max_iter - start_iter, 1))
        step = self._scan_step(k)
        if self._cost_per_chunk or self._skips_cost:
            out = _checks.eval_step_spec(
                lambda d, r: step(d, r, start_iter, None), data, rep)
        else:
            out = _checks.eval_step_spec(
                lambda d, r: step(d, r, start_iter), data, rep)
        _checks.assert_carry_stable(
            (data, rep), (out[0], out[1]),
            "chunked scan carry (meta tensors, before any dispatch)")

    @property
    def _checkpoints_stragglers(self) -> bool:
        """A straggling chunk checkpoints its state, except under a mesh:
        each rank times its own chunks, and a step that one rank alone
        writes is never complete."""
        return self.options.checkpoint_fn is not None and not self._mesh

    @property
    def _parts(self):
        """``carry_nan``'s layout of the data under a mesh: this rank's
        block of each leaf's records."""
        b = self.bundle
        if not b.axes:
            return None
        return b.axes.rank, b.axes.size, lambda path: b.record_axis(path[0])

    # ------------------------------------------------------ loop hooks
    def _begin(self, start_iter: int) -> None:
        if self.options.checks:
            self._assert_contracts(start_iter)
        self.state = (self.bundle.data, self.bundle.replicated, None)
        self._start_iter = start_iter
        self._ema = None
        self._halted = False

    def _live(self) -> bool:
        return not self._halted

    def _launch(self, i: int, k: int):
        """Enqueue one K-iteration dispatch; the ``dispatch`` fault point
        fires before any of its work is enqueued."""
        data, rep, last = self.state
        with span("driver.launch"):
            _chaos.maybe_raise("dispatch", step=i)
            step = self._scan_step(k)
            if self._cost_per_chunk or self._skips_cost:
                data, rep, last, trace = step(data, rep, i, last)
            else:
                data, rep, trace = step(data, rep, i)
        return (data, rep, last), trace

    def _poison(self, state, i: int):
        data, rep, last = state
        return (_chaos.poison_tree("carry_nan", data, step=i,
                                   parts=self._parts), rep, last)

    def _state_tree(self, state) -> Dict[str, Any]:
        return {"data": state[0], "replicated": state[1]}

    def _record(self, costs, dt: float, i: int, k: int,
                first_call: bool) -> None:
        self.log.times.extend([dt / k] * k)
        self.log.costs.extend(float(c) for c in np.ravel(costs))
        # a chunk length's first call builds kernels and FFT plans —
        # keep it out of the straggler watchdog and its EMA
        if first_call:
            return
        if self._ema is not None and \
                dt > self.options.straggler_factor * self._ema:
            self.log.straggler_steps.append(i)
            if self._checkpoints_stragglers:
                self.options.checkpoint_fn(self._checkpoint_payload(),
                                           i + k - 1)
        self._ema = dt if self._ema is None else 0.9 * self._ema + 0.1 * dt

    def _checkpoint_payload(self) -> Bundle:
        """The bundle at the current state."""
        data, rep, _ = self.state
        return self.bundle.with_data(data, replicated=rep)

    def _end_chunk(self, start: int, k: int, dt: float) -> None:
        """Convergence, then ``progress_fn`` and its ``stop``."""
        done = start + k
        conv = self._converged(self.log.costs)
        if conv:
            self.log.converged_at = done - 1
        if self.options.progress_fn is not None:
            ctl = self.options.progress_fn(
                self._progress_event(start, k, dt))
            # only a dict return is a control signal
            if isinstance(ctl, dict) and ctl.get("stop"):
                self.log.cancelled_at = done - 1
                self._halted = True
        self._halted = self._halted or conv

    def _result(self, start_iter: int, i: int) -> Bundle:
        self.log.iters_run = (self.log.iters_run or 0) + (i - start_iter)
        return self._checkpoint_payload()

    # ------------------------------------------------- supervisor hooks
    def snapshot(self):
        """The chunk-start carry (references, no copy) and the log length
        at that boundary."""
        return self.state, len(self.log.costs)

    def restore(self, snap) -> None:
        self.state, n_logged = snap
        self._rewind_log(n_logged)

    def restore_checkpoint(self, directory, step: int) -> None:
        """The checkpoint of iteration ``step``; the carried output
        restarts from its +inf seed, as after a resume."""
        from repro_torch.checkpoint import checkpointer as ckpt
        b = self.bundle
        state, _ = ckpt.restore(directory, step,
                                {"data": b.data, "replicated": b.replicated},
                                records=b.record_range if b.axes else None)
        self.state = (state["data"], state["replicated"], None)
        self._rewind_log(max(step - self._start_iter, 0))

    def _rewind_log(self, n_logged: int) -> None:
        del self.log.costs[n_logged:]
        del self.log.times[n_logged:]
        self._ema = None            # times across a rollback don't compare

    def map_replicated(self, fn: Callable) -> None:
        data, rep, last = self.state
        self.state = (data, fn(rep), last)


# --------------------------------------------------------------------
# Batched multi-instance execution (solve_many)
# --------------------------------------------------------------------

def _on_device(mask: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host index or mask array on ``device``, through pinned memory
    so the copy does not wait for the device."""
    t = torch.from_numpy(np.ascontiguousarray(mask))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class BatchedDriver(_ChunkLoop):
    """Drive one bucket of stacked instances to per-instance convergence.

    The same options and loop as :class:`IterativeDriver`, over the
    batched state ``{"d", "r"[, "last"]}`` (``core.engine``: every
    leaf carries the instance axis; ``data_axes`` names the data leaves
    whose instance axis is not 0) beside the bucket-shared replicated
    tree ``shared``:

    - each instance has its own :class:`RunLog` (costs, times,
      ``converged_at``, ``iters_run``);
    - a converged (or cancelled) instance's lane is frozen by the active
      mask and stops counting ``iters_run``; its lane still computes
      until re-compaction;
    - when the live share drops below ``recompact_below`` the bucket
      re-compacts at the chunk boundary, which has already synced: the
      retired lanes go to the host, the live ones are re-stacked on the
      device by ``index_select``;
    - checkpoints use the full-bucket layout (:meth:`snapshot_payload`),
      so restoring does not depend on when compaction happened;
    - ``RunOptions.resilience`` wraps each chunk in the single driver's
      retry and rollback discipline, its ring holding the bucket's
      bookkeeping beside its state (:meth:`snapshot`).

    ``orig_indices`` maps each stacked row to its position in the
    caller's list of instances; ``-1`` marks a filler lane, inactive
    from the start and never reported.  One host sync per chunk: the
    (K, B) cost trace.

    Under a mesh (``lane_axes``, the mesh's data axes) ``state`` holds
    this rank's block of lanes and the bookkeeping covers every rank's:
    the chunk's (K, B_local) costs are all-gathered before the one host
    sync, so every rank logs every lane and takes the same convergence,
    cancellation and re-compaction decisions.  Re-compaction keeps each
    rank's lanes on that rank (no state moves between ranks): each keeps
    its live lanes, padded with its frozen ones to the largest live
    count of any rank.  Checkpoints hold the rank's rows of the full
    layout (:meth:`payload_shard`), results are gathered to every rank.
    """

    _KIND = "bucket "

    def __init__(self, step_fn: Callable, state: Dict[str, Any],
                 shared: Optional[Dict[str, Any]] = None, *,
                 options: Optional[RunOptions] = None,
                 data_axes: Optional[Dict[str, int]] = None,
                 orig_indices=None, recompact_below: float = 0.5,
                 lane_axes: Optional[Axes] = None):
        super().__init__(options or RunOptions())
        self.step_fn = step_fn
        self.recompact_below = float(recompact_below)
        if set(state) != {"d", "r"}:
            raise ValueError(f'BatchedDriver expects a state {{"d", "r"}} '
                             f"(batched data and replicated), got "
                             f"{sorted(state)}")
        self.shared = dict(shared or {})
        self.data_axes = dict(data_axes or {})
        state = dict(state)
        if self._cost_per_chunk:
            state["last"] = init_batched_cost_like(
                self.options.step_fn_cost, state, self.shared)
        elif self._skips_cost:
            state["last"] = init_batched_out_like(self.step_fn, state,
                                                  self.shared)
        self.state = state
        self.axes = state_axes(state, self.data_axes)
        k0, v0 = next(iter(state["d"].items()))
        self.device = v0.device
        self.lanes = self._mesh = (lane_axes if lane_axes is not None
                                   else NO_AXES)
        # this rank's rows of the full layout, and every rank's
        self.B0_local = int(v0.shape[self.data_axes.get(k0, 0)])
        B = self.B0_local * self.lanes.size
        self.B0 = B
        self.orig = (np.asarray(orig_indices, dtype=np.int64)
                     if orig_indices is not None
                     else np.arange(B, dtype=np.int64))
        if len(self.orig) != B:
            raise ValueError(f"orig_indices has {len(self.orig)} entries "
                             f"for a batch of {B}")
        # bookkeeping in full-layout rows [0, B0); slots maps the current
        # compacted position s to its row
        self.slots = np.arange(B, dtype=np.int64)
        self.active = self.orig >= 0
        self.iters_run = np.zeros(B, np.int64)
        self.converged_at = np.full(B, -1, np.int64)
        self.logs = [RunLog(iters_run=0) for _ in range(B)]
        self.retired: Dict[int, Any] = {}    # row -> host instance state
        self._mask = None                    # (live rows, device mask)
        self._iters_at_start = self.iters_run.copy()

    def _build_step(self, k: int) -> Callable:
        o = self.options
        if self._cost_per_chunk:
            return make_batched_chunk_cost_step(
                o.step_fn_light, o.step_fn_cost, chunk=k,
                data_axes=self.data_axes,
                update_replicated=o.update_replicated)
        return make_batched_scan_step(
            self.step_fn, chunk=k, data_axes=self.data_axes,
            update_replicated=o.update_replicated, fn_light=o.step_fn_light,
            cost_every=self.cost_every,
            light_updates_replicated=o.light_updates_replicated)

    @property
    def lane_range(self):
        """This rank's rows ``[lo, hi)`` of the full layout."""
        lo = self.lanes.rank * self.B0_local
        return lo, lo + self.B0_local

    @property
    def _local_slots(self) -> np.ndarray:
        """The full-layout rows of this rank's current lanes (``slots``
        lists every rank's, rank by rank, an equal count each)."""
        m = len(self.slots) // self.lanes.size
        return self.slots[self.lanes.rank * m:(self.lanes.rank + 1) * m]

    # -------------------------------------------------------- dispatch
    def _device_mask(self):
        """The (B,) mask of live lanes on the device, ``None`` when every
        lane is live (nothing to freeze); rebuilt only when it changes."""
        live = self.active[self._local_slots]
        if live.all():
            return None
        if self._mask is None or not np.array_equal(self._mask[0], live):
            self._mask = (live.copy(), _on_device(live, self.device))
        return self._mask[1]

    @property
    def _parts(self):
        """``carry_nan``'s layout of the lanes under a mesh: this rank's
        block of the current lanes."""
        if not self.lanes:
            return None
        return (self.lanes.rank, self.lanes.size,
                lambda path: self.data_axes.get(path[0], 0))

    def _record(self, costs, dt: float, i: int, k: int,
                first_call: bool) -> None:
        """Each live lane's log, counter and convergence (a bucket has no
        straggler watchdog)."""
        per = dt / max(k, 1)
        for s, row in enumerate(self.slots):
            row = int(row)
            if not self.active[row]:
                continue
            log = self.logs[row]
            log.costs.extend(float(c) for c in costs[:, s])
            log.times.extend([per] * k)
            self.iters_run[row] += k
            log.iters_run = int(self.iters_run[row])
            if self._converged(log.costs):
                self.active[row] = False
                self.converged_at[row] = i + k - 1
                log.converged_at = i + k - 1

    def _progress_event(self, start: int, k: int, dt: float) -> dict:
        """A chunk event with one entry per instance still in the bucket,
        keyed by the caller's index."""
        inst = {}
        for row in self.slots:
            row = int(row)
            if self.orig[row] < 0:
                continue                            # a filler lane
            log = self.logs[row]
            inst[int(self.orig[row])] = {
                "cost": (log.costs[-1] if log.costs else None),
                "iters_run": int(self.iters_run[row]),
                "converged_at": (int(self.converged_at[row])
                                 if self.converged_at[row] >= 0 else None)}
        return {"kind": "chunk", "start": int(start), "iters": int(k),
                "done": int(start + k), "dt_s": float(dt),
                "instances": inst}

    def _apply_control(self, ctl: dict, it: int) -> None:
        """A ``progress_fn`` control return: ``cancel_instances`` freezes
        the named instances (caller's indices) as if converged; ``stop``
        cancels every live one."""
        if ctl.get("stop"):
            targets = [int(j) for j in self.orig if j >= 0]
        else:
            targets = [int(j) for j in (ctl.get("cancel_instances")
                                        or ())]
        for j in targets:
            rows = np.flatnonzero(self.orig == j)
            if rows.size == 0 or not self.active[int(rows[0])]:
                continue
            row = int(rows[0])
            self.active[row] = False
            self.logs[row].cancelled_at = it

    # ---------------------------------------------------- re-compaction
    def _select(self, keep: np.ndarray):
        """The state's lanes ``keep`` (compacted positions), on the
        device."""
        idx = _on_device(keep.astype(np.int64), self.device)

        def pick(x, a):
            return x.index_select(a, idx)

        return _persist.map_with_axes(pick, self.state, self.axes)

    def _maybe_recompact(self) -> None:
        cur = self.active[self.slots]
        n_act = int(cur.sum())
        B = len(self.slots)
        if n_act == 0 or n_act >= self.recompact_below * B:
            return
        # each rank keeps its live lanes, and frozen ones up to the
        # largest live count of any rank (module docstring)
        blocks = cur.reshape(self.lanes.size, -1)
        m = int(blocks.sum(axis=1).max())
        if m == blocks.shape[1]:
            return
        keeps = [np.sort(np.concatenate([
            np.flatnonzero(live),
            np.flatnonzero(~live)[:m - int(live.sum())]]))
            for live in blocks]
        keep = keeps[self.lanes.rank]
        gone = np.setdiff1d(np.arange(blocks.shape[1]), keep)
        mine = self._local_slots
        host = _persist.to_host(self._select(gone))
        for s, g in enumerate(gone):
            self.retired[int(mine[g])] = _persist.slice_instance(
                host, s, self.axes)
        self.state = self._select(keep)
        self.slots = np.concatenate([
            block[k] for block, k in
            zip(self.slots.reshape(self.lanes.size, -1), keeps)])

    # ------------------------------------------------------ checkpoints
    def payload_template(self) -> Dict[str, Any]:
        """The structure of :meth:`snapshot_payload` (``meta`` tensors for
        the state, in the full B0-row layout), for
        ``checkpoint.restore(..., like=..., device=...)``."""
        def full(x, a):
            shape = list(x.shape)
            shape[a] = self.B0_local
            return torch.empty(shape, dtype=x.dtype, device="meta")

        return {"state": _persist.map_with_axes(full, self.state,
                                                 self.axes),
                "batch": {"active": np.zeros(self.B0, bool),
                          "iters_run": np.zeros(self.B0, np.int64),
                          "converged_at": np.zeros(self.B0, np.int64)}}

    def payload_shard(self) -> Dict[str, Any]:
        """The checkpoint layout of :meth:`snapshot_payload`: this rank's
        rows of the state's full layout (``checkpoint.save(shard=)``);
        the bookkeeping, the same on every rank, is written whole."""
        lo, hi = self.lane_range
        return {"index": self.lanes.rank, "count": self.lanes.size,
                "write": self.lanes.lead,
                "records": {_checks.label(("state",) + path):
                            [_persist._axis(self.axes, path), lo, hi,
                             self.B0]
                            for path, _ in _checks.leaves_with_path(
                                self.state)}}

    def snapshot_payload(self) -> Dict[str, Any]:
        """The full-bucket checkpoint payload: the state in this rank's
        rows of the full layout (the compacted lanes scattered back on
        the device, the retired ones from their host spills) and the
        per-instance bookkeeping.  The state stays on the device; the
        checkpoint writer spills it."""
        state = self.state
        lo, _ = self.lane_range
        if len(self.slots) != self.B0:
            idx = _on_device(self._local_slots - lo, self.device)

            def scatter(x, a):
                shape = list(x.shape)
                shape[a] = self.B0_local
                return torch.zeros(shape, dtype=x.dtype,
                                   device=x.device).index_copy_(a, idx, x)

            state = _persist.map_with_axes(scatter, state, self.axes)
            for row, inst in self.retired.items():
                _persist.set_instance(
                    state, row - lo,
                    _persist.readmit_batched(self.device, inst), self.axes)
        return {"state": state,
                "batch": {"active": self.active.copy(),
                          "iters_run": self.iters_run.copy(),
                          "converged_at": self.converged_at.copy()}}

    def load_payload(self, payload, *, rewind_logs: bool = False) -> None:
        """Adopt a full-layout payload: a resume (fresh logs from the
        restored boundary, as a single solve's resume has) or a mid-run
        rollback from disk (``rewind_logs=True`` cuts each lane's log back
        to the iterations it had logged at the checkpoint)."""
        batch = payload["batch"]
        iters = np.asarray(batch["iters_run"], dtype=np.int64)
        conv = np.asarray(batch["converged_at"], dtype=np.int64)
        if rewind_logs:
            for row in range(self.B0):
                n = int(max(iters[row] - self._iters_at_start[row], 0))
                log = self.logs[row]
                del log.costs[n:]
                del log.times[n:]
                log.iters_run = int(iters[row])
                log.converged_at = (int(conv[row]) if conv[row] >= 0
                                    else None)
        else:
            self.logs = [RunLog(iters_run=int(iters[r]),
                                converged_at=(int(conv[r]) if conv[r] >= 0
                                              else None))
                         for r in range(self.B0)]
        self.active = np.asarray(batch["active"]).astype(bool)
        self.iters_run, self.converged_at = iters, conv
        self.slots = np.arange(self.B0, dtype=np.int64)
        self.retired = {}
        self._mask = None
        self.state = payload["state"]

    # ---------------------------------------------------------- results
    def log_of(self, row: int) -> RunLog:
        """The :class:`RunLog` of the full layout's row ``row``."""
        return self.logs[row]

    def host_states(self) -> Dict[int, Any]:
        """Each row's final instance state on the host: live lanes
        sliced out of the device state, retired ones from their spills;
        under a mesh every rank's rows, gathered."""
        if self.lanes:
            full = _persist.map_with_axes(
                lambda x, a: compat.all_gather(x, self.lanes, a),
                self.snapshot_payload()["state"], self.axes)
            host = _persist.to_host(full)
            return {row: _persist.slice_instance(host, row, self.axes)
                    for row in range(self.B0)}
        host = _persist.to_host(self.state)
        out = dict(self.retired)
        for s, row in enumerate(self.slots):
            out[int(row)] = _persist.slice_instance(host, s, self.axes)
        return out

    # ------------------------------------------------------ loop hooks
    def _begin(self, start_iter: int) -> None:
        if self.options.checks:
            _checks.assert_all_finite(
                self._state_tree(self.state), "initial bucket state")
        self._iters_at_start = self.iters_run.copy()

    def _live(self) -> bool:
        return bool(self.active.any())

    def _launch(self, i: int, k: int):
        """Enqueue one chunk for the bucket (the ``dispatch`` fault point
        first) and gather every rank's lanes of its (K, B) costs."""
        with span("driver.launch"):
            _chaos.maybe_raise("dispatch", step=i)
            state, trace = self._scan_step(k)(self.state, self.shared,
                                              self._device_mask(), i)
            costs = trace["cost"] if isinstance(trace, dict) else trace
            costs = compat.all_gather(costs, self.lanes, 1)
        return state, costs

    def _poison(self, state, i: int):
        return dict(state, d=_chaos.poison_tree(
            "carry_nan", state["d"], step=i, parts=self._parts))

    def _state_tree(self, state) -> Dict[str, Any]:
        return {"data": state["d"], "replicated": state["r"]}

    def _live_costs(self, costs: np.ndarray) -> np.ndarray:
        return costs[:, self.active[self.slots]]

    def _checkpoint_payload(self) -> Dict[str, Any]:
        return self.snapshot_payload()

    def _end_chunk(self, start: int, k: int, dt: float) -> None:
        """``progress_fn`` and its controls, then re-compaction."""
        if self.options.progress_fn is not None:
            ctl = self.options.progress_fn(
                self._progress_event(start, k, dt))
            if isinstance(ctl, dict):
                self._apply_control(ctl, start + k - 1)
        self._maybe_recompact()

    def _result(self, start_iter: int, i: int) -> "BatchedDriver":
        return self

    # ------------------------------------------------- supervisor hooks
    def snapshot(self) -> Dict[str, Any]:
        """The chunk-start state (references) beside copies of the
        bookkeeping: the slot map, the active mask, the counters, each
        lane's log length and the retired lanes."""
        return {"state": self.state,
                "slots": self.slots.copy(), "active": self.active.copy(),
                "iters": self.iters_run.copy(),
                "conv": self.converged_at.copy(),
                "logs_len": [len(log.costs) for log in self.logs],
                "retired": dict(self.retired)}

    def restore(self, snap: Dict[str, Any]) -> None:
        self.slots = snap["slots"].copy()
        self.active = snap["active"].copy()
        self.iters_run = snap["iters"].copy()
        self.converged_at = snap["conv"].copy()
        self.retired = dict(snap["retired"])
        for row in range(self.B0):
            log = self.logs[row]
            n = snap["logs_len"][row]
            del log.costs[n:]
            del log.times[n:]
            log.iters_run = int(self.iters_run[row])
            log.converged_at = (int(self.converged_at[row])
                                if self.converged_at[row] >= 0 else None)
        self.state = snap["state"]

    def restore_checkpoint(self, directory, step: int) -> None:
        """The full-bucket payload of iteration ``step``, each lane's log
        cut back to it."""
        from repro_torch.checkpoint import checkpointer as ckpt
        payload, _ = ckpt.restore(directory, step, self.payload_template(),
                                  device=self.device,
                                  records=(self.lane_range if self.lanes
                                           else None))
        self.load_payload(payload, rewind_logs=True)

    def map_replicated(self, fn: Callable) -> None:
        self.state = dict(self.state, r=fn(self.state["r"]))
