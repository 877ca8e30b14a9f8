"""Problem-protocol conformance for the port's ``@register``-ed workloads.

RPL501 problem-hooks    : a registered Problem lacks a required hook or
                          declares a hook with the wrong arity.  The
                          protocol is duck-typed: a drifted signature
                          fails only deep inside ``solve``.
RPL502 problem-metadata : class metadata and declared hooks disagree
                          (``replicated_in_carry`` without
                          ``refresh_replicated``/``light_step``,
                          ``refresh_replicated`` without
                          ``replicated_in_carry``, or
                          ``default_cost_every="chunk"`` without the
                          ``cost`` + ``light_step`` pair it wires up),
                          as ``core.problem.derive_options`` rejects at
                          run time.

The arities are the port's (``repro_torch/core/problem.py``), counting
``self``: ``init_bundle(self, inputs, device[, mesh=None])``,
``full_step(self, d, rep, axes)``, ``light_step`` and ``cost`` alike,
``refresh_replicated(self, rep, out)``, ``finalize(self, bundle, log)``
and ``batch_axes(self)``.  ``solve`` passes ``mesh`` to ``init_bundle``
as a keyword and only under a mesh, so a required ``mesh`` parameter
(the JAX package's ``init_bundle(self, inputs, mesh)``) is a finding.
Only classes registered with the port's ``register`` are checked.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.lint.checkers._ast_util import (import_aliases, methods,
                                                 param_names,
                                                 params_with_defaults,
                                                 registered)
from repro_torch.lint.core import Finding, ModuleSource, Rule, register_checker

RPL501 = Rule("RPL501", "problem-hooks",
              "registered Problem missing/mis-declared protocol hook")
RPL502 = Rule("RPL502", "problem-metadata",
              "Problem metadata inconsistent with its declared hooks")

_REQUIRED = {"init_bundle": 3, "full_step": 4}
_OPTIONAL = {"light_step": 4, "cost": 4, "refresh_replicated": 3,
             "finalize": 3, "batch_axes": 1}
_WHERE = "(incl. self — repro_torch/core/problem.py)"


def _class_flag(cls: ast.ClassDef, name: str):
    """Literal value of a class-level ``name = <const>``, else None."""
    for st in cls.body:
        if isinstance(st, ast.Assign):
            targets = st.targets
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            targets = [st.target]
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name and \
                    isinstance(st.value, ast.Constant):
                return st.value.value
    return None


def _arity_ok(fn, want: int) -> bool:
    """Exact positional arity, modulo trailing defaulted parameters."""
    if fn.args.vararg or fn.args.kwarg:
        return True                        # a forwarding wrapper
    positional = len(fn.args.posonlyargs + fn.args.args)
    return positional - len(fn.args.defaults) <= want <= positional


def _check_hooks(mod, cls, found, findings) -> None:
    for hook, arity in {**_REQUIRED, **_OPTIONAL}.items():
        fn = found.get(hook)
        if fn is None:
            if hook in _REQUIRED:
                findings.append(mod.finding(
                    RPL501, cls,
                    f"registered Problem '{cls.name}' does not declare "
                    f"required hook '{hook}'"))
        elif not _arity_ok(fn, arity):
            findings.append(mod.finding(
                RPL501, fn,
                f"'{cls.name}.{hook}' takes {len(param_names(fn))} "
                f"params, protocol expects {arity} {_WHERE}"))
    init = found.get("init_bundle")
    if init is not None and "mesh" in param_names(init) and \
            "mesh" not in params_with_defaults(init):
        findings.append(mod.finding(
            RPL501, init,
            f"'{cls.name}.init_bundle' requires 'mesh', which solve() "
            f"passes only under a mesh, as a keyword: the port's hook is "
            f"init_bundle(self, inputs, device, mesh=None) {_WHERE}"))


def _check_metadata(mod, cls, found, findings) -> None:
    replicated = _class_flag(cls, "replicated_in_carry")
    if replicated is True:
        for needed in ("refresh_replicated", "light_step"):
            if needed not in found:
                findings.append(mod.finding(
                    RPL502, cls,
                    f"'{cls.name}' sets replicated_in_carry but does not "
                    f"declare {needed}() — the broadcast carry cannot "
                    f"advance (derive_options will reject it)"))
    if "refresh_replicated" in found and replicated is not True:
        findings.append(mod.finding(
            RPL502, cls,
            f"'{cls.name}' declares refresh_replicated() without "
            f"replicated_in_carry=True — the hook is dead wiring"))
    if _class_flag(cls, "default_cost_every") == "chunk":
        for needed in ("cost", "light_step"):
            if needed not in found:
                findings.append(mod.finding(
                    RPL502, cls,
                    f"'{cls.name}' defaults cost_every='chunk' but does "
                    f"not declare {needed}() — the chunk-cost step "
                    f"cannot be assembled"))


@register_checker("protocol", [RPL501, RPL502])
def check(mod: ModuleSource):
    aliases = import_aliases(mod.tree)
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and registered(node, aliases):
            found = methods(node)
            _check_hooks(mod, node, found, findings)
            _check_metadata(mod, node, found, findings)
    return findings
