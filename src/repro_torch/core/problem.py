"""Declarative workload API: declare a ``Problem`` once, ``solve()`` it.

Port of ``repro.core.problem`` for one device::

    class MyProblem(Problem):
        def init_bundle(self, inputs, device): ...   # configure + place
        def full_step(self, d, rep, axes): ...       # one iteration
        # optional: light_step / cost / refresh_replicated

    sol = solve(MyProblem(cfg), *inputs, device="cuda", max_iter=100)

``solve()`` derives the driver wiring — scan step or chunk-cost step,
light and cost variants, broadcast updates — from which optional hooks
the Problem declares (:func:`derive_options`, the same rules as the JAX
package).  The port's ``init_bundle`` takes the target ``device`` where
the JAX one takes a mesh.

Workloads register under a string key (``@register("deconvolve")``) in
the port's own registry; built-in workloads import lazily on first
lookup.

``solve`` takes the runtime checks (``checks=True`` or ``REPRO_CHECKS``),
checkpoints (``checkpoint_dir=``, ``checkpoint_every=``, ``resume=``)
and supervision (``resilience=ResilienceConfig(...)``, with the
``REPRO_CHAOS`` fault plan read for the run) as the JAX package does.
:func:`solve_many` runs many independent instances in buckets, one
batched step per iteration for a whole bucket (``core.batching``,
``core.engine``).  ``mesh=`` belongs to a later slice and raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import importlib
import warnings
from dataclasses import dataclass, replace
from pathlib import Path
from typing import (Any, Callable, ClassVar, Dict, List, Optional, Tuple,
                    Type, Union)

import numpy as np

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.core import batching, checks, persistence
from repro_torch.core.batching import BatchAxes
from repro_torch.core.bundle import Bundle, gather
from repro_torch.core.driver import (BatchedDriver, IterativeDriver, RunLog,
                                     RunOptions)
from repro_torch.kernels.common import resolve_device
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience.recovery import RecoveryReport


class Problem:
    """One workload, declared once.

    Required hooks:

    - ``init_bundle(inputs, device) -> Bundle`` — configuration and
      placement: build the bundle (and its broadcast side) on
      ``device`` from the raw inputs.
    - ``full_step(d, rep, axes) -> (d', out)`` — one iteration; ``out``
      is a scalar cost or a dict with a ``"cost"`` entry.

    Optional hooks (``None`` at class level means "not declared"):
    ``light_step(d, rep, axes)`` (the iteration without the objective),
    ``cost(d, rep, axes)`` (the objective of the post-iteration state),
    ``refresh_replicated(rep, out)`` (fold the output into the broadcast
    state).  Metadata: ``replicated_in_carry``, ``default_chunk``,
    ``default_cost_every``.  ``finalize(bundle, log) -> (x, aux)``.

    ``batched_steps`` declares that the step hooks also take a bucket's
    batched state (every data leaf with the instance axis at its record
    axis, every replicated leaf with it first; objectives reduced per
    instance to (B,)), which :func:`solve_many` needs: the port writes
    the batch out where the JAX package ``vmap``s.
    """

    name: ClassVar[Optional[str]] = None      # set by @register
    replicated_in_carry: ClassVar[bool] = False
    batched_steps: ClassVar[bool] = False
    default_chunk: ClassVar[int] = 8
    default_cost_every: ClassVar[Union[int, str]] = 1

    light_step: Optional[Callable] = None
    cost: Optional[Callable] = None
    refresh_replicated: Optional[Callable] = None

    def init_bundle(self, inputs: Tuple, device) -> Bundle:
        raise NotImplementedError

    def full_step(self, d, rep, axes):
        raise NotImplementedError

    def default_options(self) -> RunOptions:
        """``max_iter``/``tol`` from ``self.cfg`` when it has them,
        chunking and cadence from the class metadata."""
        base = RunOptions()
        cfg = getattr(self, "cfg", None)
        return RunOptions(
            max_iter=getattr(cfg, "max_iter", base.max_iter),
            tol=getattr(cfg, "tol", base.tol),
            chunk=self.default_chunk,
            cost_every=self.default_cost_every)

    def finalize(self, bundle: Bundle, log: RunLog) -> Tuple[Any, Dict]:
        return gather(bundle), {}

    def batch_axes(self) -> BatchAxes:
        """How instances batch in :func:`solve_many`."""
        return BatchAxes()

    def _declared(self, hook: str) -> Optional[Callable]:
        fn = getattr(self, hook, None)
        return fn if callable(fn) else None


@dataclass
class Solution:
    """What ``solve()`` returns: the primary result ``x`` (numpy),
    secondary outputs ``aux``, the driver's log, and the final bundle."""
    x: Any
    aux: Dict[str, Any]
    log: RunLog
    bundle: Bundle
    problem: Problem
    # the run's checkpoint writer (its spill and write times), if any
    checkpointer: Optional[ckpt.Checkpointer] = None
    # what supervision did (resilience=); None for an unsupervised run.
    # A bucket's instances share their bucket's report.
    recovery: Optional[RecoveryReport] = None

    @property
    def costs(self):
        return self.log.costs

    def percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        return self.log.percentiles(qs)


# --------------------------------------------------------------------
# Workload registry
# --------------------------------------------------------------------

_REGISTRY: Dict[str, Type[Problem]] = {}

_BUILTIN_MODULES: Dict[str, str] = {
    "deconvolve": "repro_torch.imaging.deconvolve",
    "lowrank": "repro_torch.imaging.lowrank",
    "scdl": "repro_torch.imaging.scdl",
}
# workloads of the reference that later slices port (none left)
_LATER_WORKLOADS: Dict[str, str] = {}


def register(name: str):
    """Class decorator: put the Problem subclass into the registry under
    ``name`` and stamp ``cls.name``."""

    def deco(cls: Type[Problem]) -> Type[Problem]:
        if not (isinstance(cls, type) and issubclass(cls, Problem)):
            raise TypeError(f"@register({name!r}) expects a Problem "
                            f"subclass, got {cls!r}")
        prev = _REGISTRY.get(name)
        if prev is not None and prev is not cls:
            raise ValueError(
                f"workload {name!r} already registered to "
                f"{prev.__module__}.{prev.__name__}")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get(name: str) -> Type[Problem]:
    """Look up a registered Problem class by key (importing the built-in
    workload modules on first use)."""
    if name not in _REGISTRY and name in _BUILTIN_MODULES:
        importlib.import_module(_BUILTIN_MODULES[name])
    if name not in _REGISTRY:
        if name in _LATER_WORKLOADS:
            raise NotImplementedError(
                f"workload {name!r} is not ported yet (ROADMAP "
                f"{_LATER_WORKLOADS[name]})")
        raise KeyError(
            f"unknown workload {name!r}; registered workloads: "
            f"{available()}")
    return _REGISTRY[name]


def available() -> Tuple[str, ...]:
    """All known workload keys (registered + lazily importable)."""
    return tuple(sorted(set(_REGISTRY) | set(_BUILTIN_MODULES)))


# --------------------------------------------------------------------
# Wiring derivation + the single entry point
# --------------------------------------------------------------------

_RUN_CONTROL_KEYS = ("max_iter", "tol", "chunk", "cost_every",
                     "cost_window", "straggler_factor",
                     "checkpoint_every", "checkpoint_fn", "checks",
                     "resilience", "progress_fn")


def derive_options(problem: Problem, base: RunOptions) -> RunOptions:
    """Map a Problem's declared hooks + metadata onto the driver's step
    wiring (the rules of the JAX package):

    1. ``light_step`` declared         -> ``step_fn_light``.
    2. ``cost_every == "chunk"``       -> requires ``cost`` and
       ``light_step``; wires ``step_fn_cost``.
    3. ``refresh_replicated`` declared -> ``update_replicated``.
    4. ``replicated_in_carry``         -> ``light_updates_replicated``.
    """
    light = problem._declared("light_step")
    cost = problem._declared("cost")
    refresh = problem._declared("refresh_replicated")
    per_chunk = base.cost_every == "chunk"
    if per_chunk and (cost is None or light is None):
        raise ValueError(
            f'{type(problem).__name__}: cost_every="chunk" needs both a '
            f"light_step and a standalone cost declaration")
    if not per_chunk and int(base.cost_every) > 1 and light is None:
        raise ValueError(
            f"{type(problem).__name__}: cost_every={base.cost_every} "
            f"needs a light_step declaration (the cost-free iteration)")
    if problem.replicated_in_carry and refresh is None:
        raise ValueError(
            f"{type(problem).__name__}: replicated_in_carry requires a "
            f"refresh_replicated declaration")
    if per_chunk and refresh is not None \
            and not problem.replicated_in_carry:
        raise ValueError(
            f'{type(problem).__name__}: cost_every="chunk" with '
            f"refresh_replicated requires replicated_in_carry")
    return replace(base,
                   step_fn_light=light,
                   step_fn_cost=cost if per_chunk else None,
                   update_replicated=refresh,
                   light_updates_replicated=problem.replicated_in_carry)


def _config_fingerprint(problem: Problem) -> str:
    """The checkpoint manifest's fingerprint of the workload's config.
    ``max_iter`` and ``tol`` stay out: they never enter the step math,
    and extending ``max_iter`` on a resume continues a finished run."""
    cfg = getattr(problem, "cfg", None)
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        kept = {k: v for k, v in sorted(dataclasses.asdict(cfg).items())
                if k not in ("max_iter", "tol")}
        return f"{type(cfg).__name__}({kept!r})"
    return repr(cfg)


def _as_problem(problem: Union[str, Problem, Type[Problem]],
                cfg) -> Problem:
    if isinstance(problem, str):
        cls = get(problem)
        return cls(cfg) if cfg is not None else cls()
    if isinstance(problem, type) and issubclass(problem, Problem):
        return problem(cfg) if cfg is not None else problem()
    if not isinstance(problem, Problem):
        raise TypeError(
            f"solve() expects a workload key, Problem class, or Problem "
            f"instance as its first argument, got "
            f"{type(problem).__name__!r}")
    if cfg is not None:
        raise TypeError(
            "cfg= is only valid with a workload key/class; the Problem "
            "instance already carries its config")
    return problem


def _resolved_options(problem: Problem, options: Optional[RunOptions],
                      run_opts: Dict[str, Any]) -> RunOptions:
    """Reject non-run-control kwargs and pre-wired step options, then
    merge per-call overrides over the problem's defaults."""
    bad = set(run_opts) - set(_RUN_CONTROL_KEYS)
    if bad:
        raise TypeError(
            f"got unexpected run options {sorted(bad)}; valid: "
            f"{list(_RUN_CONTROL_KEYS)}.  Step wiring is derived from "
            f"the Problem declaration, not passed to solve().")
    if options is not None:
        defaults = RunOptions()
        wired = [f for f in ("step_fn_light", "step_fn_cost",
                             "update_replicated",
                             "light_updates_replicated")
                 if getattr(options, f) != getattr(defaults, f)]
        if wired:
            raise TypeError(
                f"options= carries step wiring {wired}, which solve() "
                f"derives from the Problem declaration")
    opts = options if options is not None else problem.default_options()
    opts = opts.merged_with(**run_opts)
    # checks=True per call, or REPRO_CHECKS for every solve in the process
    if checks.checks_enabled(opts.checks) and not opts.checks:
        opts = replace(opts, checks=True)
    return opts


def _check_checkpoint_args(opts: RunOptions, checkpoint_dir, resume) -> None:
    """The argument combinations that would read or write nothing."""
    if checkpoint_dir is None:
        if resume is not False:
            raise ValueError("resume= requires checkpoint_dir=")
        if opts.checkpoint_every and opts.checkpoint_fn is None:
            raise ValueError(
                "checkpoint_every= without checkpoint_dir= (or a custom "
                "checkpoint_fn) would silently write nothing")
    elif not opts.checkpoint_every and opts.checkpoint_fn is None \
            and resume is False:
        raise ValueError(
            "checkpoint_dir= given but neither checkpoint_every= nor "
            "resume= requested — no checkpoint would ever be read or "
            "written")


def _resume_step(checkpoint_dir, resume) -> int:
    """The step ``solve(resume=...)`` restores: an explicit step, which
    must exist, or the newest intact one."""
    latest = ckpt.latest_step(checkpoint_dir)
    if isinstance(resume, int) and not isinstance(resume, bool):
        if not (Path(checkpoint_dir) / f"step_{resume:08d}"
                / "manifest.json").exists():
            raise ValueError(f"no checkpoint for step {resume} under "
                             f"{str(checkpoint_dir)!r} (latest saved step: "
                             f"{latest})")
        return resume
    if latest is None:
        raise ValueError(f"resume=True but no checkpoints found under "
                         f"{str(checkpoint_dir)!r} — wrong directory, or "
                         f"the first checkpoint was never written")
    step, corrupt = ckpt.latest_valid_step(checkpoint_dir)
    if step is None:
        raise ValueError(f"resume=True but every checkpoint under "
                         f"{str(checkpoint_dir)!r} failed integrity "
                         f"validation (corrupt steps: {corrupt}); latest "
                         f"saved step: {latest}")
    if corrupt:
        warnings.warn(f"newest checkpoint(s) {corrupt} under "
                      f"{str(checkpoint_dir)!r} failed integrity "
                      f"validation (torn write?); resuming from step "
                      f"{step} instead", RuntimeWarning, stacklevel=3)
    return step


def solve(problem: Union[str, Problem, Type[Problem]], *inputs,
          cfg=None, device=None, mesh=None,
          options: Optional[RunOptions] = None, checkpoint_dir=None,
          resume: Union[bool, int] = False, **run_opts) -> Solution:
    """The single entry point: configure, place, iterate.

    ``problem`` is a registry key (``"deconvolve"``, ``"scdl"``,
    ``"lowrank"``), a Problem class or an instance.  ``*inputs`` (numpy
    arrays or tensors) go to ``problem.init_bundle``, which copies them
    onto ``device``
    (``None`` = ``"cuda"``; raises without a card).  Run control:
    ``options=RunOptions(...)`` replaces the problem's defaults;
    ``**run_opts`` (``max_iter=``, ``tol=``, ``chunk=``,
    ``cost_every=``, ``progress_fn=``, ``checks=``, ...) override
    field-wise.

    Checkpoints: ``checkpoint_dir=`` with ``checkpoint_every=k`` writes
    the full state (data and replicated) every k iterations, on a
    writer thread that never makes this thread wait for the device
    (``checkpoint.Checkpointer``, keep 3).  ``resume=True`` (the newest
    intact checkpoint, falling back past a torn one with a
    ``RuntimeWarning``) or ``resume=<step>`` (that step, which must
    exist) restores into the freshly built bundle and continues, the
    cost trajectory exactly where the checkpointed run left off.  The
    manifest's workload and config fingerprint must match.

    Supervision: ``resilience=ResilienceConfig(...)`` retries transient
    dispatch failures and rolls a diverged run back (its snapshot ring,
    then the newest valid checkpoint: ``checkpoint_dir`` defaults to
    this call's own); ``Solution.recovery`` reports what it did.
    ``REPRO_CHAOS`` arms the fault plan for this run unless one is
    already active.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet (ROADMAP A13, multi-device)")
    problem = _as_problem(problem, cfg)
    opts = _resolved_options(problem, options, run_opts)
    _check_checkpoint_args(opts, checkpoint_dir, resume)
    bundle = problem.init_bundle(tuple(inputs), resolve_device(device))
    start_iter = 0
    writer = None
    if checkpoint_dir is not None:
        # the fingerprint makes a resume under a changed config (same
        # shapes, other step sizes) fail loudly
        meta = {"problem": problem.name or type(problem).__name__,
                "config": _config_fingerprint(problem)}
        if resume is not False:
            step = _resume_step(checkpoint_dir, resume)
            state, _ = ckpt.restore(
                checkpoint_dir, step,
                {"data": bundle.data, "replicated": bundle.replicated},
                expect_meta=lambda m: m.get("problem") == meta["problem"]
                and m.get("config") == meta["config"])
            bundle = bundle.with_data(state["data"],
                                      replicated=state["replicated"])
            start_iter = step
        if opts.checkpoint_every and opts.checkpoint_fn is None:
            writer = ckpt.Checkpointer(checkpoint_dir, meta=meta)

            def checkpoint_fn(b: Bundle, i: int) -> None:
                # i is the last iteration done: i + 1 are in the state
                writer.save_async(i + 1, persistence.spill_bundle(b))

            opts = replace(opts, checkpoint_fn=checkpoint_fn)
    opts = _with_rollback_dir(opts, checkpoint_dir)
    driver = IterativeDriver(problem.full_step, bundle,
                             options=derive_options(problem, opts))
    with _chaos.maybe_from_env():
        out = driver.run(start_iter=start_iter)
    if writer is not None:
        writer.wait()       # the last write lands before the run is done
    x, aux = problem.finalize(out, driver.log)
    return Solution(x=x, aux=aux, log=driver.log, bundle=out,
                    problem=problem, checkpointer=writer,
                    recovery=driver.recovery)


def _with_rollback_dir(opts: RunOptions, directory) -> RunOptions:
    """Point a supervised run's disk fallback at the run's own
    checkpoints unless its ``ResilienceConfig`` names a directory."""
    if opts.resilience is None or directory is None \
            or opts.resilience.checkpoint_dir is not None:
        return opts
    return replace(opts, resilience=replace(
        opts.resilience, checkpoint_dir=str(directory)))


# --------------------------------------------------------------------
# Many instances: buckets
# --------------------------------------------------------------------

def solve_many(problem: Union[str, Problem, Type[Problem]], instances, *,
               cfg=None, device=None, mesh=None,
               options: Optional[RunOptions] = None, checkpoint_dir=None,
               resume: bool = False, waste_budget: float = 0.25,
               recompact_below: float = 0.5,
               **run_opts) -> List[Solution]:
    """Solve many independent instances of one workload in buckets.

    ``instances`` is a sequence of input tuples, each what the single
    :func:`solve` would take.  Instances group into buckets by static
    signature (``Problem.batch_axes``); within a bucket each instance's
    records are zero-padded to the bucket's capacity (at most
    ``waste_budget`` of the bucket's rows padding) and stacked, and one
    batched step per iteration advances the whole bucket.  Each instance
    converges on its own: its lane freezes, and the bucket re-compacts
    to its live lanes once fewer than ``recompact_below`` of them are
    left.

    ``checkpoint_dir=`` with ``checkpoint_every=`` writes each bucket's
    full-layout checkpoints under ``<checkpoint_dir>/bucket_<key>``;
    bucket keys are deterministic, so ``resume=True`` (not a step)
    plans the same buckets and restores each from its newest intact
    step.

    ``resilience=`` supervises each bucket's chunks (retry, rollback
    with the bucket's bookkeeping; the disk fallback reads the bucket's
    own checkpoints); every instance of a bucket carries the bucket's
    ``RecoveryReport``.

    Returns one :class:`Solution` per instance, unpadded, in input
    order.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet (ROADMAP A13, multi-device)")
    problem = _as_problem(problem, cfg)
    opts = _resolved_options(problem, options, run_opts)
    instances = [tuple(inst) for inst in instances]
    if not instances:
        return []
    if not problem.batched_steps:
        raise TypeError(
            f"{type(problem).__name__} does not declare batched_steps: its "
            f"step hooks must take a bucket's batched state for solve_many")
    axes = problem.batch_axes()
    if not isinstance(axes, BatchAxes):
        raise TypeError(f"{type(problem).__name__}.batch_axes() must return "
                        f"a batching.BatchAxes, got {type(axes).__name__}")
    if axes.shared_in_batch and \
            problem._declared("refresh_replicated") is not None:
        raise ValueError(
            f"{type(problem).__name__}: shared_in_batch="
            f"{axes.shared_in_batch} cannot combine with "
            f"refresh_replicated — the per-iteration broadcast update "
            f"rewrites the replicated tree")
    salt = (f"{problem.name or type(problem).__name__}|"
            f"{_config_fingerprint(problem)}")
    plan = batching.plan_buckets(instances, axes,
                                 waste_budget=waste_budget, salt=salt)
    if checkpoint_dir is not None:
        if isinstance(resume, int) and not isinstance(resume, bool):
            raise ValueError(
                "solve_many resumes each bucket from its newest valid "
                "step — pass resume=True, not an explicit step number")
        if resume and not any(
                ckpt.latest_step(Path(checkpoint_dir) / f"bucket_{b.key}")
                is not None for b in plan):
            raise ValueError(
                f"resume=True but no bucket checkpoints found under "
                f"{str(checkpoint_dir)!r} — wrong directory, another "
                f"instance plan (bucket keys changed), or the first "
                f"checkpoint was never written")
    _check_checkpoint_args(opts, checkpoint_dir, resume)
    dev = resolve_device(device)
    solutions: List[Optional[Solution]] = [None] * len(instances)
    with _chaos.maybe_from_env():
        for bucket in plan:
            _run_bucket(problem, bucket, instances, opts, dev,
                        checkpoint_dir, resume, recompact_below, solutions)
    return solutions


def stack_bucket(problem: Problem, bucket: batching.Bucket, instances,
                 device) -> Tuple[Dict[str, Any], Dict[str, Any],
                                  Dict[str, int]]:
    """One bucket's batched state ``{"d", "r"}``, its shared replicated
    tree and the data leaves' record axes (where each carries its
    instance axis)."""
    # init_bundle runs per instance on the UNPADDED inputs, so derived
    # state (operator norms, step sizes) is the single solve's; padding
    # goes onto the built bundle, where zero records are inert
    bundles = [problem.init_bundle(instances[j], device)
               for j in bucket.indices]
    rec_axes = dict(bundles[0].record_axes)
    shared_keys = tuple(problem.batch_axes().shared_in_batch)
    missing = [k for k in shared_keys if k not in bundles[0].replicated]
    if missing:
        raise ValueError(
            f"{type(problem).__name__}: batch_axes declares shared "
            f"replicated keys {missing} absent from init_bundle's "
            f"replicated tree {sorted(bundles[0].replicated)}")
    shared = {k: bundles[0].replicated[k] for k in shared_keys}
    state = {
        "d": batching.stack_trees(
            [batching.pad_tree_records(b.data, bucket.capacity, rec_axes)
             for b in bundles], rec_axes),
        "r": batching.stack_trees(
            [{k: v for k, v in b.replicated.items() if k not in shared_keys}
             for b in bundles])}
    return state, shared, rec_axes


def _run_bucket(problem: Problem, bucket: batching.Bucket, instances,
                opts: RunOptions, device, checkpoint_dir, resume,
                recompact_below: float,
                solutions: List[Optional[Solution]]) -> None:
    """Stack, run and unstack one bucket, writing its Solutions."""
    state, shared, rec_axes = stack_bucket(problem, bucket, instances,
                                           device)
    bopts = opts
    writer = None
    bdir = None
    if checkpoint_dir is not None:
        bdir = Path(checkpoint_dir) / f"bucket_{bucket.key}"
        meta = {"problem": problem.name or type(problem).__name__,
                "config": _config_fingerprint(problem),
                "bucket": bucket.key, "capacity": int(bucket.capacity),
                "instances": [int(j) for j in bucket.indices]}
        if bopts.checkpoint_every and bopts.checkpoint_fn is None:
            writer = ckpt.Checkpointer(bdir, meta=meta)

            def checkpoint_fn(payload, i: int, _writer=writer) -> None:
                _writer.save_async(i + 1, payload)

            bopts = replace(bopts, checkpoint_fn=checkpoint_fn)
    bopts = _with_rollback_dir(bopts, bdir)
    driver = BatchedDriver(problem.full_step, state, shared,
                           options=derive_options(problem, bopts),
                           data_axes=rec_axes,
                           orig_indices=np.asarray(bucket.indices),
                           recompact_below=recompact_below)
    del state
    start_iter = 0
    if bdir is not None and resume:
        step, corrupt = ckpt.latest_valid_step(bdir)
        # a bucket with no checkpoint yet starts from scratch
        if step is not None:
            if corrupt:
                warnings.warn(
                    f"newest checkpoint(s) {corrupt} under {str(bdir)!r} "
                    f"failed integrity validation (torn write?); resuming "
                    f"bucket from step {step} instead", RuntimeWarning,
                    stacklevel=3)
            payload, _ = ckpt.restore(
                bdir, step, driver.payload_template(), device=device,
                expect_meta=lambda m: m.get("problem") == meta["problem"]
                and m.get("config") == meta["config"]
                and m.get("bucket") == meta["bucket"])
            driver.load_payload(payload)
            start_iter = step
    driver.run(start_iter=start_iter)
    if writer is not None:
        writer.wait()

    host_shared = persistence.to_host(shared)
    states = driver.host_states()
    for row, j in enumerate(bucket.indices):
        inst = states[row]
        n = bucket.records[row]
        data = {k: v.narrow(rec_axes.get(k, 0), 0, n).contiguous()
                for k, v in inst["d"].items()}
        b_inst = Bundle(data=data, replicated={**host_shared, **inst["r"]},
                        device=data[next(iter(data))].device,
                        record_axes=rec_axes)
        log = driver.logs[row]
        x, aux = problem.finalize(b_inst, log)
        solutions[j] = Solution(x=x, aux=aux, log=log, bundle=b_inst,
                                problem=problem, checkpointer=writer,
                                recovery=driver.recovery)
