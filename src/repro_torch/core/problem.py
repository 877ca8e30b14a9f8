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
lookup.  Arguments of later slices (``mesh``, ``checkpoint_dir``,
``resume``, ``checks``, ``resilience``) raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple, Type, Union

from repro_torch.core.batching import BatchAxes
from repro_torch.core.bundle import Bundle, gather
from repro_torch.core.driver import IterativeDriver, RunLog, RunOptions
from repro_torch.kernels.common import resolve_device


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
    """

    name: ClassVar[Optional[str]] = None      # set by @register
    replicated_in_carry: ClassVar[bool] = False
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
        """How instances batch (consumed by lint rule RPL801 now, by
        ``solve_many`` once it is ported, ROADMAP A10)."""
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
    return opts.merged_with(**run_opts)


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
    ``cost_every=``, ``progress_fn=``, ...) override field-wise.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet (ROADMAP A13, multi-device)")
    if checkpoint_dir is not None or resume is not False:
        raise NotImplementedError(
            "checkpoint_dir=/resume= are not ported yet (ROADMAP A9, "
            "checkpoints)")
    problem = _as_problem(problem, cfg)
    opts = _resolved_options(problem, options, run_opts)
    bundle = problem.init_bundle(tuple(inputs), resolve_device(device))
    driver = IterativeDriver(problem.full_step, bundle,
                             options=derive_options(problem, opts))
    out = driver.run()
    x, aux = problem.finalize(out, driver.log)
    return Solution(x=x, aux=aux, log=driver.log, bundle=out,
                    problem=problem)
