"""repro_torch.lint — the port's static analysis.

Port of ``repro.lint``, with the port's own rules: the JAX package's
linter looks for JAX's hazards (donated buffers, BlockSpecs against
grids, tracer leaks), this one for the port's, above all a host sync in
the code that runs every iteration, which otherwise only the card's
sync-debug count shows.  It imports neither JAX nor the JAX package::

    python -m repro_torch.lint                 # src/repro_torch, tests/test_torch_*.py
    python -m repro_torch.lint src/repro_torch tests --report out.json
    python -m repro_torch.lint --list-rules

Checkers register themselves into a rule registry; each finding carries
a stable rule ID and its ``file:line:col``.  A finding is suppressed by
an end-of-line ``# repro-lint: disable=<rule>`` comment (rule ID or
slug, comma-separated, ``all`` for every rule) or a file-wide
``# repro-lint: disable-file=<rule>``: the JAX package's syntax, so one
comment reads the same under both linters.

The rules (``--list-rules`` prints the table):

- RPL102 inplace-carry, RPL301 tensor-branch, RPL302 host-sync: the
  code that runs every iteration (``checkers/steps.py``);
- RPL203 ref-parity, RPL204 kernel-fallback: the kernel families
  (``checkers/kernels.py``);
- RPL401 f64-dtype, RPL402 bf16-accum (``checkers/dtypes.py``);
- RPL501 problem-hooks, RPL502 problem-metadata, RPL801 batch-axes: the
  port's Problem protocol (``checkers/protocol.py``,
  ``checkers/batching.py``);
- RPL601 noncanonical-import (``checkers/imports.py``);
- RPL701 swallowed-exception in ``core/``, ``checkpoint/`` and
  ``resilience/``; RPL901 untracked-task in ``serve/``.

The JAX package's RPL101, RPL201, RPL202 and RPL303 have no rule of
the same ID here: RPL102 and RPL204 replace RPL101 and RPL202 with the
port's meaning, RPL302 takes in RPL303, and RPL201 checks Pallas
BlockSpecs, which the port does not have (its grids are in
``csrc/*.cu``).
"""
from repro_torch.lint.core import (Finding, ModuleSource, Rule, all_rules,
                                   lint_file, lint_paths, register_checker)

__all__ = ["Finding", "ModuleSource", "Rule", "all_rules", "lint_file",
           "lint_paths", "register_checker"]
