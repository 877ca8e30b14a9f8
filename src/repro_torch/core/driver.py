"""IterativeDriver: the paper's driver program on one device.

Port of the single-instance half of ``repro.core.driver``:

- ``chunk=1``  — one step and one host sync per iteration;
- ``chunk=K>1`` — K iterations per dispatch through
  ``core.engine.make_scan_step`` / ``make_chunk_cost_step``: the host
  sees one ``(K,)`` cost trace, one convergence check and one sync per
  chunk.

Kept exactly: the chunk clamped to ``max_iter``; ``_converged`` with its
stride rule (costs ``cost_window x stride`` apart when the log repeats
skipped objectives); ``progress_fn`` and its ``{"stop": True}``
control; the straggler watchdog, which leaves each chunk length's first
call out (it includes the kernel build and FFT plan creation).

Not ported yet, and refused loudly when asked for: ``checks`` and
checkpoints (ROADMAP A9), ``resilience`` (A11), the batched driver
(A10).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.bundle import Bundle
from repro_torch.core.engine import (make_chunk_cost_step, make_scan_step,
                                     make_step)

# RunOptions fields of later slices: name -> (default, ROADMAP item)
_LATER_FIELDS = {
    "checkpoint_every": (0, "A9 (checkpoints)"),
    "checkpoint_fn": (None, "A9 (checkpoints)"),
    "checks": (False, "A9 (runtime checks)"),
    "resilience": (None, "A11 (resilience)"),
}


@dataclass(frozen=True)
class RunOptions:
    """Everything the driver needs beyond ``(step_fn, bundle)``.

    Run control (iteration budget, convergence, chunking, observability)
    plus step wiring (the cost-free and objective-only step variants and
    the broadcast-update hook), as in the JAX package.  ``cost_every``
    is a positive int (requires ``step_fn_light`` when > 1) or
    ``"chunk"`` (one evaluation per chunk; requires ``step_fn_cost``).
    ``progress_fn`` is called at every chunk boundary with a progress
    event; a dict return ``{"stop": True}`` halts the run there.

    ``checkpoint_every``, ``checkpoint_fn``, ``checks`` and
    ``resilience`` belong to later slices and raise
    ``NotImplementedError`` when set.
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
    resilience: Optional[object] = None
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
        for name, (default, item) in _LATER_FIELDS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"RunOptions.{name} is not ported yet (ROADMAP {item})")

    def merged_with(self, **overrides) -> "RunOptions":
        """A copy with the non-None entries of ``overrides`` applied."""
        return replace(self, **{k: v for k, v in overrides.items()
                                if v is not None})


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
    return costs.detach().cpu().numpy()


class IterativeDriver:
    """Drive ``step_fn(data, rep, axes) -> (data', out)`` until the
    relative cost change drops below ``tol`` or ``max_iter`` is hit.
    ``out`` is a scalar cost or a dict with a ``"cost"`` entry."""

    def __init__(self, step_fn: Callable, bundle: Bundle, *,
                 options: Optional[RunOptions] = None):
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
        self.progress_fn = options.progress_fn
        # a chunk longer than the whole run would never run whole —
        # clamp so the chunk that runs is the one that was asked for
        self.chunk = max(min(int(options.chunk),
                             max(int(options.max_iter), 1)), 1)
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
        self._steps: Dict[object, Callable] = {}

    # ------------------------------------------------------------ steps
    def _scan_step(self, k: int) -> Callable:
        """The K-iteration step, built once per chunk length."""
        if k not in self._steps:
            if self._cost_per_chunk:
                self._steps[k] = make_chunk_cost_step(
                    self.step_fn_light, self.step_fn_cost, chunk=k,
                    update_replicated=self.update_replicated)
            else:
                self._steps[k] = make_scan_step(
                    self.step_fn, chunk=k,
                    update_replicated=self.update_replicated,
                    fn_light=self.step_fn_light,
                    cost_every=self.cost_every,
                    light_updates_replicated=self.light_updates_replicated)
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

    # -------------------------------------------------------------- run
    def run(self, start_iter: int = 0) -> Bundle:
        if self.chunk == 1:
            return self._run_per_step(start_iter)
        return self._run_chunked(start_iter)

    def _dispatch_chunk(self, data, rep, last, i: int, k: int):
        """One K-iteration dispatch and its host sync."""
        step = self._scan_step(k)
        if self._cost_per_chunk or self._skips_cost:
            data, rep, last, trace = step(data, rep, i, last)
        else:
            data, rep, trace = step(data, rep, i)
        return data, rep, last, _host_costs(trace)

    def _run_chunked(self, start_iter: int) -> Bundle:
        data, rep = self.bundle.data, self.bundle.replicated
        last = None                     # the +inf seed (engine.seed_like)
        ema = None
        seen_ks = set()
        i = start_iter
        while i < self.max_iter:
            k = min(self.chunk, self.max_iter - i)
            first_call = k not in seen_ks
            seen_ks.add(k)
            t0 = time.perf_counter()
            data, rep, last, costs = self._dispatch_chunk(
                data, rep, last, i, k)
            dt = time.perf_counter() - t0
            self.log.times.extend([dt / k] * k)
            self.log.costs.extend(float(c) for c in np.ravel(costs))
            # a chunk length's first call builds kernels and FFT plans —
            # keep it out of the straggler watchdog and its EMA
            if not first_call:
                if ema is not None and dt > self.straggler_factor * ema:
                    self.log.straggler_steps.append(i)
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
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
        return self.bundle.with_data(data, replicated=rep)

    def _run_per_step(self, start_iter: int) -> Bundle:
        data, rep = self.bundle.data, self.bundle.replicated
        step = make_step(self.step_fn)
        ema = None
        n_done = 0
        for i in range(start_iter, self.max_iter):
            t0 = time.perf_counter()
            if self._skips_cost and i % self.cost_every != 0:
                # off the cost grid: the objective-free step, the last
                # evaluated cost carried forward
                if self.light_updates_replicated:
                    data, aux = self.step_fn_light(data, rep, ())
                    if self.update_replicated is not None:
                        rep = self.update_replicated(rep, aux)
                else:
                    data = self.step_fn_light(data, rep, ())
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
                self.log.costs.append(cost_val)
                if self.update_replicated is not None:
                    rep = self.update_replicated(rep, out)
            if ema is not None and dt > self.straggler_factor * ema:
                self.log.straggler_steps.append(i)
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
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
