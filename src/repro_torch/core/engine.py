"""Iteration engine: K iterations per dispatch, one host sync per chunk.

Port of ``repro.core.engine``.  A step is a plain function ``fn(data,
replicated, axes) -> (data', out)`` over the bundle's dicts; ``axes``
is the bundle's ``core.compat.Axes`` (empty without a mesh), which the
step sums its partial results over (``compat.psum``), as the JAX step
psums over its mesh axes under ``shard_map``.  JAX fuses a chunk into
one ``lax.scan`` program; the port runs the K iterations as a Python
loop that only enqueues device work — every cost stays a 0-d device tensor and the chunk's
``(K,)`` trace is stacked on the device, so the driver syncs once per
chunk when it reads the trace.  The scan steps made here are the only
steps the driver's one chunk loop (``core.driver``) runs: a run of
``chunk=1`` takes the scan step of one iteration.

Cost-skipping semantics are kept exactly:

- the cadence phases on the global iteration index, ``i % cost_every``
  (a host integer here);
- the carried output before the first evaluation is +inf
  (:func:`seed_like`), so a trace can never fake convergence;
- the per-chunk objective's trace is ``last`` repeated for the first
  K - 1 slots and the fresh objective in the last.

A ``last`` of ``None`` stands for the +inf seed.  A run that starts on
the cost grid takes the seed's structure from the first output the step
produces; one that starts off it (a resume from step 10 under
``cost_every=3``) needs the structure before any output exists, and gets
it as the JAX package does through ``eval_shape``: :func:`init_out_like`
runs the step once on ``meta`` tensors, which compute nothing.

The batched half (``solve_many``): :func:`make_batched_scan_step` and
:func:`make_batched_chunk_cost_step` run K iterations across a whole
bucket of instances.  Where the JAX package ``vmap``s the per-instance
step, the port calls the workload's own step once an iteration on
tensors that carry the instance axis B (every built-in workload's step
is written over a leading batch of instances: step sizes of shape (B,),
objectives reduced per instance to (B,)).  The active mask changes only
at chunk boundaries, where the host decides convergence, so the port
freezes converged lanes once, at the end of the chunk
(:func:`freeze_where`): the same values as the JAX package's freeze on
every iteration, since instances never read each other, without a pass
over the state each iteration.  A frozen lane's objective never moves.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.core.checks import eval_step_spec


def _scalar_trace(out, ndim: int = 0):
    """The per-iteration trace: the leaves of a dict output with ``ndim``
    dimensions (0 for one instance, 1 — a (B,) vector — for a bucket),
    or the output itself when it is a bare tensor."""
    if isinstance(out, dict):
        kept = {k: v for k, v in out.items()
                if isinstance(v, torch.Tensor) and v.dim() == ndim}
        return kept if kept else out
    return out


def seed_like(out, device=None):
    """The "not yet evaluated" value shaped like ``out`` (tensors or
    ``meta`` tensors), on ``device`` (``out``'s own by default): +inf
    for floating leaves, zeros otherwise."""
    def seed(v):
        dev = v.device if device is None else device
        fill = float("inf") if v.is_floating_point() else 0
        return torch.full(tuple(v.shape), fill, dtype=v.dtype, device=dev)
    if isinstance(out, dict):
        return {k: seed(v) for k, v in out.items()}
    return seed(out)


def _device_of(tree) -> torch.device:
    for v in tree.values():
        if isinstance(v, dict):
            return _device_of(v)
        return v.device
    raise ValueError("an empty state has no device")


def init_out_like(fn: Callable, data, rep, axes=()):
    """The +inf seed of ``fn``'s reduced output, its structure taken by
    running ``fn`` once on ``meta`` tensors (no device work)."""
    _, out = eval_step_spec(lambda d, r: fn(d, r, axes), data, rep)
    return seed_like(out, _device_of(data))


def _stack_trace(entries):
    """[trace_0, ..., trace_{K-1}] -> one (K,)-stacked device trace."""
    if isinstance(entries[0], dict):
        return {k: torch.stack([e[k] for e in entries])
                for k in entries[0]}
    return torch.stack(entries)


def make_scan_step(fn: Callable, *, chunk: int = 8,
                   update_replicated: Optional[Callable] = None,
                   fn_light: Optional[Callable] = None,
                   cost_every: int = 1,
                   light_updates_replicated: bool = False, axes=()):
    """K = ``chunk`` iterations of ``fn`` per call, each given ``axes``.

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
                    # a run that starts off the grid (a resume)
                    last = init_out_like(fn, data, rep, axes)
                if light_updates_replicated:
                    data, aux = fn_light(data, rep, axes)
                    out = {**last, **aux}
                    if update_replicated is not None:
                        rep = update_replicated(rep, out)
                else:
                    data, out = fn_light(data, rep, axes), last
            else:
                data, out = fn(data, rep, axes)
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
                         update_replicated: Optional[Callable] = None,
                         axes=()):
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
                data = fn_light(data, rep, axes)
            else:
                data, aux = fn_light(data, rep, axes)
                rep = update_replicated(rep, aux)
        fresh = fn_cost(data, rep, axes)
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


# --------------------------------------------------------------------
# Batched multi-instance steps (solve_many)
# --------------------------------------------------------------------
#
# The bucket's state is ``{"d": data, "r": replicated[, "last":
# carried output]}``.  Every leaf carries the instance axis B: a data
# leaf at its record axis (an instance's (n, ...) leaf is (B, n, ...), a
# scale-major (J, n, ...) one is (J, B, n, ...): one more view of the
# (J, B*n, ...) stack the kernels read), every replicated and carried
# leaf at axis 0.  ``data_axes`` names the data leaves whose instance
# axis is not 0.  The bucket-shared replicated tree
# (``BatchAxes.shared_in_batch``) rides beside the state and is read by
# every instance.  Under a mesh each rank runs its own block of lanes;
# the steps get ``axes=()``, since instances never sum into each other.


def _merge_rep(r, shared):
    return {**shared, **r} if shared else r


def _split_rep(rep_full, r):
    """The updated full replicated view, projected back onto the batched
    keys (the shared part is constant by declaration)."""
    return {k: rep_full[k] for k in r}


def state_axes(state, data_axes: Optional[Mapping[str, int]] = None):
    """The instance axis of every leaf of a batched state tree."""
    def zeros(t):
        return {k: zeros(v) if isinstance(v, dict) else 0
                for k, v in t.items()}
    out = {k: zeros(v) if isinstance(v, dict) else 0
           for k, v in state.items()}
    out["d"] = {k: (data_axes or {}).get(k, 0) for k in state["d"]}
    return out


def freeze_where(active: torch.Tensor, new, old, axes) -> Any:
    """Per-instance freeze: ``old`` wherever the (B,) bool mask
    ``active`` is False, ``new`` elsewhere, on each leaf's instance axis
    (``axes``, a matching tree of ints).  Frozen lanes computed the
    chunk all the same; re-compaction reclaims that work once enough
    lanes retire."""
    if isinstance(new, dict):
        return {k: freeze_where(active, new[k], old[k], axes[k])
                for k in new}
    shape = [1] * new.dim()
    shape[axes] = active.shape[0]
    return torch.where(active.reshape(shape), new, old)


def init_batched_out_like(fn: Callable, state, shared):
    """(B,)-stacked +inf seed of ``fn``'s per-instance output, for the
    carried slot of a cost-skipping batched scan."""
    _, out = eval_step_spec(
        lambda d, r, s: fn(d, _merge_rep(r, s), ()),
        state["d"], state["r"], shared)
    return seed_like(out, _device_of(state["d"]))


def init_batched_cost_like(fn_cost: Callable, state, shared):
    """(B,)-stacked +inf seed of the per-instance objective (per-chunk
    cost mode)."""
    out = eval_step_spec(lambda d, r, s: fn_cost(d, _merge_rep(r, s), ()),
                         state["d"], state["r"], shared)
    return seed_like(out, _device_of(state["d"]))


def make_batched_scan_step(fn: Callable, *, chunk: int = 8,
                           data_axes: Optional[Mapping[str, int]] = None,
                           update_replicated: Optional[Callable] = None,
                           fn_light: Optional[Callable] = None,
                           cost_every: int = 1,
                           light_updates_replicated: bool = False):
    """K = ``chunk`` iterations across a whole bucket: the batched
    counterpart of :func:`make_scan_step`.

    Returns ``step(state, shared, active, start) -> (state', trace)``;
    ``active`` is the (B,) bool device mask of live lanes (``None``: all
    live, nothing to freeze), ``trace`` stacks the (B,) scalar outputs
    into (K, B).  The cost grid is one for the whole bucket, so it stays
    a host branch; with a light step the carried output must already be
    in ``state["last"]`` (:func:`init_batched_out_like`)."""
    use_light = fn_light is not None and cost_every > 1

    def step(state, shared, active, start):
        d, r = state["d"], state["r"]
        last = state.get("last")
        entries = []
        for i in range(int(start), int(start) + chunk):
            rep = _merge_rep(r, shared)
            if use_light and i % cost_every != 0:
                if light_updates_replicated:
                    d, aux = fn_light(d, rep, ())
                    out = {**last, **aux}
                    if update_replicated is not None:
                        r = _split_rep(update_replicated(rep, out), r)
                else:
                    d, out = fn_light(d, rep, ()), last
            else:
                d, out = fn(d, rep, ())
                if update_replicated is not None:
                    r = _split_rep(update_replicated(rep, out), r)
            last = out
            entries.append(_scalar_trace(out, ndim=1))
        new = {"d": d, "r": r}
        if "last" in state:
            new["last"] = last
        if active is not None:
            new = freeze_where(active, new, state,
                               state_axes(state, data_axes))
        return new, _stack_trace(entries)

    return step


def make_batched_chunk_cost_step(fn_light: Callable, fn_cost: Callable, *,
                                 chunk: int = 8,
                                 data_axes: Optional[Mapping[str, int]]
                                 = None,
                                 update_replicated: Optional[Callable]
                                 = None):
    """Batched counterpart of :func:`make_chunk_cost_step`: K cost-free
    iterations across the bucket, then each instance's objective once,
    on the chunk's final state, carried in ``state["last"]``.  A frozen
    lane keeps its previous objective.  Same signature as
    :func:`make_batched_scan_step`."""

    def step(state, shared, active, start):
        d, r = state["d"], state["r"]
        for _ in range(chunk):
            rep = _merge_rep(r, shared)
            if update_replicated is None:
                d = fn_light(d, rep, ())
            else:
                d, aux = fn_light(d, rep, ())
                r = _split_rep(update_replicated(rep, aux), r)
        new = {"d": d, "r": r,
               "last": fn_cost(d, _merge_rep(r, shared), ())}
        if active is not None:
            new = freeze_where(active, new, state,
                               state_axes(state, data_axes))

        def trace(s, f):
            return torch.cat([s.unsqueeze(0).expand((chunk - 1,)
                                                    + tuple(s.shape)),
                              f.unsqueeze(0)])

        last, fresh = state["last"], new["last"]
        if isinstance(fresh, dict):
            tr = {k: trace(last[k], fresh[k]) for k in fresh}
        else:
            tr = trace(last, fresh)
        return new, tr

    return step
