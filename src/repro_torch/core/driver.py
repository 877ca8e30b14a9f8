"""IterativeDriver and BatchedDriver: the paper's driver program on one
device.

Port of ``repro.core.driver``:

- ``chunk=1``  — one step and one host sync per iteration;
- ``chunk=K>1`` — K iterations per dispatch through
  ``core.engine.make_scan_step`` / ``make_chunk_cost_step``: the host
  sees one ``(K,)`` cost trace, one convergence check and one sync per
  chunk.

Kept exactly: the chunk clamped to ``max_iter``; ``_converged`` with its
stride rule (costs ``cost_window x stride`` apart when the log repeats
skipped objectives); ``progress_fn`` and its ``{"stop": True}``
control; the straggler watchdog, which leaves each chunk length's first
call out (it includes the kernel build and FFT plan creation); the
runtime checks (``core.checks``: the initial state, the carry contract
on ``meta`` tensors before the first dispatch, then the costs and the
state at every host sync) and the checkpoint hook with its cadence rules
(clamped to ``max_iter``; a chunk that crosses a multiple of the cadence
checkpoints at its end).  Off, the checks add no operation and no sync.

:class:`BatchedDriver` runs one bucket of ``solve_many`` (module
``core.engine``'s batched steps): per-instance logs and convergence, an
active mask, re-compaction, the ``cancel_instances`` control and the
full-bucket checkpoint payload.  One host sync per chunk.

Supervision (``RunOptions.resilience``, ``resilience.supervisor``):
each chunk's start is pushed onto a ring of references, the dispatch is
retried on transient faults, and a non-finite objective or state rolls
the run back (ring first, then the newest valid checkpoint).  The state
is judged by one device reduction that reaches the host with the
chunk's costs, so a supervised chunk still syncs once; under a mesh the
ranks' verdicts are summed in one all-reduce before that transfer, and
every recovery decision is taken by every rank together
(``resilience.supervisor``).  Supervised runs
always take the chunked loop (``chunk=1`` there runs the scan step of
one iteration, the same math).  The chaos fault points ``dispatch``
and ``carry_nan`` sit in both loops and in the batched driver; off,
each costs one ``is None`` check.
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
                                     make_step, state_axes)
from repro_torch.core.spans import span
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience.errors import DivergenceError
from repro_torch.resilience.recovery import ResilienceConfig
from repro_torch.resilience.supervisor import (BatchSupervisor, Supervisor,
                                               finite_flag,
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


class IterativeDriver:
    """Drive ``step_fn(data, rep, axes) -> (data', out)`` until the
    relative cost change drops below ``tol`` or ``max_iter`` is hit.
    ``out`` is a scalar cost or a dict with a ``"cost"`` entry.

    The configuration is one :class:`RunOptions`.  The individual
    keyword arguments of old (``max_iter=``, ``step_fn_light=``, ...)
    are still taken, deprecated: they are mapped onto ``options`` with a
    ``DeprecationWarning``, and a name that is no field raises
    ``TypeError``."""

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
        self.options = options = options or RunOptions()
        self.bundle = bundle
        self.step_fn = step_fn
        self.step_fn_light = options.step_fn_light
        self.step_fn_cost = options.step_fn_cost
        self.update_replicated = options.update_replicated
        self.light_updates_replicated = options.light_updates_replicated
        self.max_iter = options.max_iter
        self.tol = options.tol
        self.cost_window = options.cost_window
        self.straggler_factor = options.straggler_factor
        self.checkpoint_fn = options.checkpoint_fn
        self.checks = options.checks
        self.progress_fn = options.progress_fn
        # a chunk longer than the whole run would never run whole —
        # clamp so the chunk that runs is the one that was asked for
        self.chunk = max(min(int(options.chunk),
                             max(int(options.max_iter), 1)), 1)
        # the same clamp for the checkpoint cadence (0 stays off): a
        # cadence longer than the run would never fire, and the final
        # state is what a resume needs
        self.checkpoint_every = (min(int(options.checkpoint_every),
                                     max(int(options.max_iter), 1))
                                 if options.checkpoint_every else 0)
        self._per_chunk = options.cost_every == "chunk"
        if self._per_chunk:
            if options.step_fn_cost is None or options.step_fn_light is None:
                raise ValueError(
                    'cost_every="chunk" requires step_fn_cost (a '
                    "standalone objective over the post-iteration "
                    "state) AND step_fn_light (the cost-free step)")
            self.cost_every = 1
        else:
            if options.step_fn_cost is not None:
                raise ValueError(
                    "step_fn_cost is only consumed by the per-chunk "
                    'objective mode — pass cost_every="chunk" with it, '
                    f"not cost_every={options.cost_every!r}")
            self.cost_every = max(int(options.cost_every), 1)
        self.log = RunLog()
        # the supervised run's RecoveryReport (None when unsupervised)
        self.recovery = None
        self._steps: Dict[object, Callable] = {}

    # ------------------------------------------------------------ steps
    def _scan_step(self, k: int) -> Callable:
        """The K-iteration step, built once per chunk length."""
        if k not in self._steps:
            if self._cost_per_chunk:
                self._steps[k] = make_chunk_cost_step(
                    self.step_fn_light, self.step_fn_cost, chunk=k,
                    update_replicated=self.update_replicated,
                    axes=self.bundle.axes)
            else:
                self._steps[k] = make_scan_step(
                    self.step_fn, chunk=k,
                    update_replicated=self.update_replicated,
                    fn_light=self.step_fn_light,
                    cost_every=self.cost_every,
                    light_updates_replicated=self.light_updates_replicated,
                    axes=self.bundle.axes)
        return self._steps[k]

    @property
    def _skips_cost(self) -> bool:
        return self.cost_every > 1 and self.step_fn_light is not None

    @property
    def _cost_per_chunk(self) -> bool:
        """Chunk-granular objective; per-step runs (chunk=1) evaluate
        every iteration anyway, so they take the plain path."""
        return self._per_chunk and self.chunk > 1

    # ------------------------------------------------------ convergence
    def _converged(self) -> bool:
        if not self.tol:
            return False
        c = self.log.costs
        # with cost skipping the log repeats each evaluated objective;
        # compare costs cost_window *evaluations* apart
        stride = (self.chunk if self._cost_per_chunk
                  else self.cost_every if self._skips_cost else 1)
        w = self.cost_window * stride
        if len(c) <= w:
            return False
        prev, cur = c[-w - 1], c[-1]
        return abs(prev - cur) <= self.tol * max(abs(prev), 1e-12)

    def _progress_event(self, start: int, k: int, dt: float) -> dict:
        return {"kind": "chunk", "start": int(start), "iters": int(k),
                "done": int(start + k),
                "cost": (self.log.costs[-1] if self.log.costs else None),
                "dt_s": float(dt),
                "converged_at": self.log.converged_at}

    # ------------------------------------------------------ checks
    def _assert_contracts(self, start_iter: int) -> None:
        """checks=True before the first dispatch: the initial state is
        finite, and the step's carry keeps its structure, shapes and
        dtypes — found by running the step on ``meta`` tensors."""
        data, rep = self.bundle.data, self.bundle.replicated
        _checks.assert_all_finite({"data": data, "replicated": rep},
                                  "initial bundle state")
        what = "{} carry (meta tensors, before any dispatch)"
        if self.chunk == 1:
            out = _checks.eval_step_spec(self.step_fn, data, rep,
                                         self.bundle.axes)
            _checks.assert_carry_stable(data, out[0],
                                        what.format("per-step data"))
            return
        k = min(self.chunk, max(self.max_iter - start_iter, 1))
        step = self._scan_step(k)
        if self._cost_per_chunk or self._skips_cost:
            out = _checks.eval_step_spec(
                lambda d, r: step(d, r, start_iter, None), data, rep)
        else:
            out = _checks.eval_step_spec(
                lambda d, r: step(d, r, start_iter), data, rep)
        _checks.assert_carry_stable((data, rep), (out[0], out[1]),
                                    what.format("chunked scan"))

    @property
    def _checkpoints_stragglers(self) -> bool:
        """A straggling chunk checkpoints its state, except under a mesh:
        each rank times its own chunks, and a step that one rank alone
        writes is never complete."""
        return self.checkpoint_fn is not None and not self.bundle.axes

    def _checkpoint(self, data, rep, i: int) -> None:
        self.checkpoint_fn(self.bundle.with_data(data, replicated=rep), i)

    # -------------------------------------------------------------- run
    def run(self, start_iter: int = 0) -> Bundle:
        if self.checks:
            self._assert_contracts(start_iter)
        if self.chunk == 1 and self.options.resilience is None:
            return self._run_per_step(start_iter)
        # supervised runs take the chunked loop: its chunk boundary is
        # where snapshots, validation and rollback live
        return self._run_chunked(start_iter)

    def _launch_chunk(self, data, rep, last, i: int, k: int):
        """Enqueue one K-iteration dispatch; the ``dispatch`` fault point
        fires before any of its work is enqueued."""
        with span("driver.launch"):
            _chaos.maybe_raise("dispatch", step=i)
            step = self._scan_step(k)
            if self._cost_per_chunk or self._skips_cost:
                data, rep, last, trace = step(data, rep, i, last)
            else:
                data, rep, trace = step(data, rep, i)
        return data, rep, last, trace

    def _dispatch_chunk(self, data, rep, last, i: int, k: int):
        """One K-iteration dispatch and its host sync."""
        data, rep, last, trace = self._launch_chunk(data, rep, last, i, k)
        return data, rep, last, _host_costs(trace)

    @property
    def _parts(self):
        """``carry_nan``'s layout of the data under a mesh: this rank's
        block of each leaf's records."""
        b = self.bundle
        if not b.axes:
            return None
        return b.axes.rank, b.axes.size, lambda path: b.record_axis(path[0])

    def _dispatch_supervised(self, data, rep, last, i: int, k: int):
        """The supervised dispatch: the chunk, the ``carry_nan`` fault
        point, and one transfer of the costs with the state's finite
        flag (under a mesh every rank's, summed in one all-reduce)."""
        data, rep, last, trace = self._launch_chunk(data, rep, last, i, k)
        if _chaos.is_active():
            data = _chaos.poison_tree("carry_nan", data, step=i,
                                      parts=self._parts)
        flag = finite_flag({"data": data, "replicated": rep})
        axes = self.bundle.axes
        if axes:
            flag = mesh_flag(flag, axes, self.bundle.device)
        costs, finite = host_costs_and_flag(trace, flag)
        return data, rep, last, costs, finite

    def _run_chunked(self, start_iter: int) -> Bundle:
        data, rep = self.bundle.data, self.bundle.replicated
        last = None                     # the +inf seed (engine.seed_like)
        sup = None
        if self.options.resilience is not None:
            sup = Supervisor(self.options.resilience, self.bundle,
                             start_iter=start_iter)
        ema = None
        seen_ks = set()
        i = start_iter
        while i < self.max_iter:
            k = min(self.chunk, self.max_iter - i)
            first_call = k not in seen_ks
            seen_ks.add(k)
            t0 = time.perf_counter()
            if sup is not None:
                sup.begin_chunk(data, rep, last, i, len(self.log.costs))
                try:
                    data, rep, last, costs, finite = sup.dispatch(
                        self._dispatch_supervised, data, rep, last, i, k)
                    sup.validate(data, rep, costs, finite, i + k - 1)
                except DivergenceError as e:
                    sup.report.wall_time_lost_s += \
                        time.perf_counter() - t0
                    data, rep, last, i = sup.rollback(e, self.log)
                    ema = None      # times across a rollback don't compare
                    continue
            else:
                data, rep, last, costs = self._dispatch_chunk(
                    data, rep, last, i, k)
                if _chaos.is_active():
                    data = _chaos.poison_tree("carry_nan", data, step=i,
                                              parts=self._parts)
            dt = time.perf_counter() - t0
            if self.checks:
                _checks.assert_costs_finite(
                    costs, f"chunk ending at iteration {i + k - 1}")
                _checks.assert_all_finite(
                    {"data": data, "replicated": rep},
                    f"state after iteration {i + k - 1}")
            self.log.times.extend([dt / k] * k)
            self.log.costs.extend(float(c) for c in np.ravel(costs))
            # a chunk length's first call builds kernels and FFT plans —
            # keep it out of the straggler watchdog and its EMA
            if not first_call:
                if ema is not None and dt > self.straggler_factor * ema:
                    self.log.straggler_steps.append(i)
                    if self._checkpoints_stragglers:
                        self._checkpoint(data, rep, i + k - 1)
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            # a chunk that crosses a multiple of the cadence checkpoints
            # its final state
            if (self.checkpoint_every and self.checkpoint_fn is not None
                    and (i + k) // self.checkpoint_every
                    > i // self.checkpoint_every):
                self._checkpoint(data, rep, i + k - 1)
            i += k
            conv = self._converged()
            if conv:
                self.log.converged_at = i - 1
            if self.progress_fn is not None:
                ctl = self.progress_fn(self._progress_event(i - k, k, dt))
                # only a dict return is a control signal
                if isinstance(ctl, dict) and ctl.get("stop"):
                    self.log.cancelled_at = i - 1
                    break
            if conv:
                break
        self.log.iters_run = (self.log.iters_run or 0) + (i - start_iter)
        if sup is not None:
            self.recovery = sup.finalize()
        return self.bundle.with_data(data, replicated=rep)

    def _run_per_step(self, start_iter: int) -> Bundle:
        data, rep = self.bundle.data, self.bundle.replicated
        axes = self.bundle.axes
        step = make_step(self.step_fn, axes)
        ema = None
        n_done = 0
        for i in range(start_iter, self.max_iter):
            t0 = time.perf_counter()
            if _chaos.is_active():  # unsupervised: a fault ends the run
                _chaos.maybe_raise("dispatch", step=i)
            if self._skips_cost and i % self.cost_every != 0:
                # off the cost grid: the objective-free step, the last
                # evaluated cost carried forward
                if self.light_updates_replicated:
                    data, aux = self.step_fn_light(data, rep, axes)
                    if self.update_replicated is not None:
                        rep = self.update_replicated(rep, aux)
                else:
                    data = self.step_fn_light(data, rep, axes)
                _sync(data)
                dt = time.perf_counter() - t0
                self.log.times.append(dt)
                self.log.costs.append(self.log.costs[-1]
                                      if self.log.costs else float("inf"))
            else:
                data, out = step(data, rep)
                cost = out["cost"] if isinstance(out, dict) else out
                cost_val = float(cost)            # the iteration's sync
                dt = time.perf_counter() - t0
                self.log.times.append(dt)
                if self.checks:
                    _checks.assert_costs_finite(np.asarray([cost_val]),
                                                f"iteration {i}")
                    _checks.assert_all_finite(
                        {"data": data}, f"state after iteration {i}")
                self.log.costs.append(cost_val)
                if self.update_replicated is not None:
                    rep = self.update_replicated(rep, out)
            if _chaos.is_active():
                data = _chaos.poison_tree("carry_nan", data, step=i,
                                          parts=self._parts)
            if ema is not None and dt > self.straggler_factor * ema:
                self.log.straggler_steps.append(i)
                if self._checkpoints_stragglers:
                    self._checkpoint(data, rep, i)
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if (self.checkpoint_every and self.checkpoint_fn is not None
                    and (i + 1) % self.checkpoint_every == 0):
                self._checkpoint(data, rep, i)
            n_done += 1
            conv = self._converged()
            if conv:
                self.log.converged_at = i
            if self.progress_fn is not None:
                ctl = self.progress_fn(self._progress_event(i, 1, dt))
                if isinstance(ctl, dict) and ctl.get("stop"):
                    self.log.cancelled_at = i
                    break
            if conv:
                break
        self.log.iters_run = (self.log.iters_run or 0) + n_done
        return self.bundle.with_data(data, replicated=rep)


def _sync(data: Dict[str, torch.Tensor]) -> None:
    """Wait for the device work behind ``data`` (per-step timing)."""
    dev = next(iter(data.values())).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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


class BatchedDriver:
    """Drive one bucket of stacked instances to per-instance convergence.

    The same options and chunked loop as :class:`IterativeDriver`, over
    the batched state ``{"d", "r"[, "last"]}`` (``core.engine``: every
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
      bookkeeping beside its state (``resilience.supervisor``).

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

    def __init__(self, step_fn: Callable, state: Dict[str, Any],
                 shared: Optional[Dict[str, Any]] = None, *,
                 options: Optional[RunOptions] = None,
                 data_axes: Optional[Dict[str, int]] = None,
                 orig_indices=None, recompact_below: float = 0.5,
                 lane_axes: Optional[Axes] = None):
        self.options = options = options or RunOptions()
        self.step_fn = step_fn
        self.step_fn_light = options.step_fn_light
        self.step_fn_cost = options.step_fn_cost
        self.update_replicated = options.update_replicated
        self.light_updates_replicated = options.light_updates_replicated
        self.max_iter = options.max_iter
        self.tol = options.tol
        self.cost_window = options.cost_window
        self.checkpoint_fn = options.checkpoint_fn
        self.checks = options.checks
        self.progress_fn = options.progress_fn
        self.chunk = max(min(int(options.chunk),
                             max(int(options.max_iter), 1)), 1)
        self.checkpoint_every = (min(int(options.checkpoint_every),
                                     max(int(options.max_iter), 1))
                                 if options.checkpoint_every else 0)
        self._per_chunk = options.cost_every == "chunk"
        if self._per_chunk:
            if options.step_fn_cost is None or options.step_fn_light is None:
                raise ValueError(
                    'cost_every="chunk" requires step_fn_cost AND '
                    "step_fn_light (see IterativeDriver)")
            self.cost_every = 1
        else:
            if options.step_fn_cost is not None:
                raise ValueError(
                    "step_fn_cost is only consumed by the per-chunk "
                    'objective mode — pass cost_every="chunk" with it')
            self.cost_every = max(int(options.cost_every), 1)
        self.recompact_below = float(recompact_below)
        if set(state) != {"d", "r"}:
            raise ValueError(f'BatchedDriver expects a state {{"d", "r"}} '
                             f"(batched data and replicated), got "
                             f"{sorted(state)}")
        self.shared = dict(shared or {})
        self.data_axes = dict(data_axes or {})
        state = dict(state)
        if self._cost_per_chunk:
            state["last"] = init_batched_cost_like(self.step_fn_cost, state,
                                                   self.shared)
        elif self._skips_cost:
            state["last"] = init_batched_out_like(self.step_fn, state,
                                                  self.shared)
        self.state = state
        self.axes = state_axes(state, self.data_axes)
        k0, v0 = next(iter(state["d"].items()))
        self.device = v0.device
        self.lanes = lane_axes if lane_axes is not None else NO_AXES
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
        self.recovery = None                 # the supervised run's report
        self._iters_at_start = self.iters_run.copy()
        self._steps: Dict[int, Callable] = {}

    @property
    def _skips_cost(self) -> bool:
        return self.cost_every > 1 and self.step_fn_light is not None

    @property
    def _cost_per_chunk(self) -> bool:
        return self._per_chunk and self.chunk > 1

    def _scan_step(self, k: int) -> Callable:
        if k not in self._steps:
            if self._cost_per_chunk:
                self._steps[k] = make_batched_chunk_cost_step(
                    self.step_fn_light, self.step_fn_cost, chunk=k,
                    data_axes=self.data_axes,
                    update_replicated=self.update_replicated)
            else:
                self._steps[k] = make_batched_scan_step(
                    self.step_fn, chunk=k, data_axes=self.data_axes,
                    update_replicated=self.update_replicated,
                    fn_light=self.step_fn_light,
                    cost_every=self.cost_every,
                    light_updates_replicated=self.light_updates_replicated)
        return self._steps[k]

    def _converged_log(self, log: RunLog) -> bool:
        if not self.tol:
            return False
        c = log.costs
        stride = (self.chunk if self._cost_per_chunk
                  else self.cost_every if self._skips_cost else 1)
        w = self.cost_window * stride
        if len(c) <= w:
            return False
        prev, cur = c[-w - 1], c[-1]
        return abs(prev - cur) <= self.tol * max(abs(prev), 1e-12)

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

    def _launch_chunk(self, state, mask, i: int, k: int):
        """Enqueue one chunk for the bucket (the ``dispatch`` fault point
        first)."""
        _chaos.maybe_raise("dispatch", step=i)
        return self._scan_step(k)(state, self.shared, mask, i)

    def _dispatch_chunk(self, state, mask, i: int, k: int):
        state, trace = self._launch_chunk(state, mask, i, k)
        costs = trace["cost"] if isinstance(trace, dict) else trace
        # every rank's lanes, then the chunk's sync
        return state, _host_costs(compat.all_gather(costs, self.lanes, 1))

    @property
    def _parts(self):
        """``carry_nan``'s layout of the lanes under a mesh: this rank's
        block of the current lanes."""
        if not self.lanes:
            return None
        return (self.lanes.rank, self.lanes.size,
                lambda path: self.data_axes.get(path[0], 0))

    def _poison(self, state, i: int):
        return dict(state, d=_chaos.poison_tree(
            "carry_nan", state["d"], step=i, parts=self._parts))

    def _dispatch_supervised(self, state, mask, i: int, k: int):
        """The chunk, the ``carry_nan`` fault point, and one transfer of
        the (K, B) costs with the state's finite flag (under a mesh every
        rank's lanes and verdict, gathered and summed first)."""
        state, trace = self._launch_chunk(state, mask, i, k)
        if _chaos.is_active():
            state = self._poison(state, i)
        costs = trace["cost"] if isinstance(trace, dict) else trace
        costs = compat.all_gather(costs, self.lanes, 1)
        flag = finite_flag({"d": state["d"], "r": state["r"]})
        if self.lanes:
            flag = mesh_flag(flag, self.lanes, self.device)
        costs, finite = host_costs_and_flag(costs, flag)
        return state, costs, finite

    def _log_chunk(self, costs, dt: float, i: int, k: int) -> None:
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
            if self._converged_log(log):
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

    # ------------------------------------------------------------- run
    def run(self, start_iter: int = 0) -> "BatchedDriver":
        if self.checks:
            _checks.assert_all_finite(
                {"data": self.state["d"], "replicated": self.state["r"]},
                "initial bucket state")
        self._iters_at_start = self.iters_run.copy()
        sup = None
        if self.options.resilience is not None:
            sup = BatchSupervisor(self.options.resilience, self)
        i = start_iter
        while i < self.max_iter and bool(self.active.any()):
            k = min(self.chunk, self.max_iter - i)
            t0 = time.perf_counter()
            live = self.active[self.slots]
            mask = self._device_mask()
            if sup is not None:
                sup.begin_chunk(i)
                try:
                    state, costs, finite = sup.dispatch(
                        self._dispatch_supervised, self.state, mask, i, k)
                    sup.validate(state, costs, finite, i + k - 1)
                except DivergenceError as e:
                    sup.report.wall_time_lost_s += \
                        time.perf_counter() - t0
                    i = sup.rollback(e)
                    continue
            else:
                state, costs = self._dispatch_chunk(self.state, mask, i, k)
                if _chaos.is_active():
                    state = self._poison(state, i)
            self.state = state
            dt = time.perf_counter() - t0
            if self.checks:
                _checks.assert_costs_finite(
                    costs[:, live],
                    f"bucket chunk ending at iteration {i + k - 1}")
                _checks.assert_all_finite(
                    {"data": self.state["d"], "replicated": self.state["r"]},
                    f"bucket state after iteration {i + k - 1}")
            self._log_chunk(costs, dt, i, k)
            if (self.checkpoint_every and self.checkpoint_fn is not None
                    and (i + k) // self.checkpoint_every
                    > i // self.checkpoint_every):
                self.checkpoint_fn(self.snapshot_payload(), i + k - 1)
            i += k
            if self.progress_fn is not None:
                ctl = self.progress_fn(self._progress_event(i - k, k, dt))
                if isinstance(ctl, dict):
                    self._apply_control(ctl, i - 1)
            self._maybe_recompact()
        if sup is not None:
            self.recovery = sup.finalize()
        return self
