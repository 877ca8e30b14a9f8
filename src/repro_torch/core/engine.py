"""Iteration engine on one device: K iterations per dispatch, one host
sync per chunk.

Port of the single-device half of ``repro.core.engine``.  A step is a
plain function ``fn(data, replicated, axes) -> (data', out)`` over the
bundle's dicts; ``axes`` is always ``()`` here (the port has no mesh
yet, ROADMAP A13).  JAX fuses a chunk into one ``lax.scan`` program;
the port runs the K iterations as a Python loop that only enqueues
device work — every cost stays a 0-d device tensor and the chunk's
``(K,)`` trace is stacked on the device, so the driver syncs once per
chunk when it reads the trace.

Cost-skipping semantics are kept exactly:

- the cadence phases on the global iteration index, ``i % cost_every``
  (a host integer here);
- the carried output before the first evaluation is +inf
  (:func:`seed_like`), so a trace can never fake convergence;
- the per-chunk objective's trace is ``last`` repeated for the first
  K - 1 slots and the fresh objective in the last.

A ``last`` of ``None`` stands for the +inf seed: the port has no
``eval_shape``, so the seed takes its structure from the first output
the step produces.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def _scalar_trace(out):
    """The per-iteration trace: the 0-d leaves of a dict output (or the
    output itself when it is a bare scalar)."""
    if isinstance(out, dict):
        kept = {k: v for k, v in out.items()
                if isinstance(v, torch.Tensor) and v.dim() == 0}
        return kept if kept else out
    return out


def seed_like(out):
    """The "not yet evaluated" value shaped like ``out``: +inf for
    floating leaves, zeros otherwise."""
    def seed(v):
        if v.is_floating_point():
            return torch.full_like(v, float("inf"))
        return torch.zeros_like(v)
    if isinstance(out, dict):
        return {k: seed(v) for k, v in out.items()}
    return seed(out)


def _stack_trace(entries):
    """[trace_0, ..., trace_{K-1}] -> one (K,)-stacked device trace."""
    if isinstance(entries[0], dict):
        return {k: torch.stack([e[k] for e in entries])
                for k in entries[0]}
    return torch.stack(entries)


def make_step(fn: Callable):
    """``step(data, rep) -> (data', out)``: one iteration of ``fn``."""
    def step(data, rep):
        return fn(data, rep, ())
    return step


def make_scan_step(fn: Callable, *, chunk: int = 8,
                   update_replicated: Optional[Callable] = None,
                   fn_light: Optional[Callable] = None,
                   cost_every: int = 1,
                   light_updates_replicated: bool = False):
    """K = ``chunk`` iterations of ``fn`` per call.

    Returns ``step(data, rep, start) -> (data', rep', trace)``, or, when
    ``fn_light`` is given and ``cost_every > 1``, ``step(data, rep,
    start, last) -> (data', rep', last', trace)``: off-grid iterations
    run the cost-free ``fn_light`` and carry ``last``, the most recent
    evaluated output, forward.  ``update_replicated(rep, out)`` folds
    each evaluated output into the broadcast state (every iteration
    with ``light_updates_replicated``, where ``fn_light`` returns
    ``(data', out_partial)``).
    """
    use_light = fn_light is not None and cost_every > 1

    def run(data, rep, start, last):
        entries = []
        for i in range(start, start + chunk):
            if use_light and i % cost_every != 0:
                if last is None:
                    raise ValueError(
                        f"iteration {i} lies off the cost grid before any "
                        f"evaluation; a cost-skipping run starts on it")
                if light_updates_replicated:
                    data, aux = fn_light(data, rep, ())
                    out = {**last, **aux}
                    if update_replicated is not None:
                        rep = update_replicated(rep, out)
                else:
                    data, out = fn_light(data, rep, ()), last
            else:
                data, out = fn(data, rep, ())
                if update_replicated is not None:
                    rep = update_replicated(rep, out)
            last = out
            entries.append(_scalar_trace(out))
        return data, rep, last, _stack_trace(entries)

    if use_light:
        def step(data, rep, start, last=None):
            return run(data, rep, int(start), last)
    else:
        def step(data, rep, start):
            data, rep, _, trace = run(data, rep, int(start), None)
            return data, rep, trace
    return step


def make_chunk_cost_step(fn_light: Callable, fn_cost: Callable, *,
                         chunk: int = 8,
                         update_replicated: Optional[Callable] = None):
    """Chunk-granular objective: K cost-free iterations, then one
    objective evaluation on the chunk's final state.

    Returns ``step(data, rep, start, last) -> (data', rep', fresh,
    trace)``; ``trace`` holds ``last`` (the previous chunk's objective,
    +inf before the first evaluation) in its first K - 1 slots and the
    fresh objective in the last.  ``fn_light`` returns bare ``data'``
    when ``update_replicated`` is ``None``, else ``(data', aux)``.
    """
    def step(data, rep, start, last=None):
        for _ in range(chunk):
            if update_replicated is None:
                data = fn_light(data, rep, ())
            else:
                data, aux = fn_light(data, rep, ())
                rep = update_replicated(rep, aux)
        fresh = fn_cost(data, rep, ())
        if last is None:
            last = seed_like(fresh)

        def trace(s, f):
            return torch.cat([s.reshape(1).expand(chunk - 1), f.reshape(1)])

        if isinstance(fresh, dict):
            tr = {k: trace(last[k], fresh[k]) for k in fresh}
        else:
            tr = trace(last, fresh)
        return data, rep, fresh, tr

    return step
