"""The workload registry, as a package: ``repro_torch.problems``.

    from repro_torch import problems
    problems.list()                    # ('deconvolve', 'lowrank', 'scdl')
    cls = problems.get("scdl")         # -> SCDLProblem
    sol = problems.solve("scdl", S_h, S_l, cfg=SCDLConfig(...))

Port of ``repro.problems``: a thin façade over
:mod:`repro_torch.core.problem`, where the registry and the ``solve()``
entry point live so the imaging modules can register themselves without
an import cycle.  Importing this package loads the built-in workloads,
so ``list()`` holds every registered key.
"""
from repro_torch.core.problem import (Problem, RunOptions, Solution,
                                      available, derive_options, get,
                                      register, solve, solve_many)

# register the built-in workloads now (core.problem imports them lazily
# on get(); here list() is complete even for keys a future module
# registers at import time)
from repro_torch.imaging import deconvolve as _deconvolve  # noqa: F401
from repro_torch.imaging import lowrank as _lowrank        # noqa: F401
from repro_torch.imaging import scdl as _scdl              # noqa: F401


def list() -> tuple:
    """All registered workload keys (shadows the builtin deliberately:
    this namespace is the registry)."""
    return available()


__all__ = ["Problem", "RunOptions", "Solution", "available",
           "derive_options", "get", "list", "register", "solve",
           "solve_many"]
