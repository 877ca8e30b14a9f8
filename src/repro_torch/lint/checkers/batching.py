"""Batch-axes hygiene for the port's ``@register``-ed workloads.

RPL801 batch-axes : a registered Problem's ``init_bundle`` reads
                    constructor state (``self.<attr>``) that its
                    ``batch_axes()`` never names.  ``solve_many`` builds
                    ONE problem object and calls ``init_bundle`` once
                    per instance, so every attribute the hook reads is
                    shared by the whole bucket.  That is sound only
                    where the author says so, by naming the attribute in
                    the ``instance_invariant`` or ``shared_in_batch`` of
                    the :class:`repro_torch.core.batching.BatchAxes` the
                    hook returns.  An undeclared read is the classic
                    batched-solve bug: a per-instance noise level or
                    random draw frozen to the first instance's value.
                    (An instance's own draws ride in its inputs, as a
                    trailing dict, and are not constructor state.)

``self.cfg``, the class's own methods and private ``self._*`` caches are
exempt.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.lint.checkers._ast_util import (import_aliases, methods,
                                                 registered)
from repro_torch.lint.core import Finding, ModuleSource, Rule, register_checker

RPL801 = Rule("RPL801", "batch-axes",
              "init_bundle closes over per-instance state not declared "
              "in batch_axes()")


def _self_reads(fn: ast.AST) -> Set[str]:
    """Names of ``self.<attr>`` loads anywhere in the function."""
    return {node.attr for node in ast.walk(fn)
            if isinstance(node, ast.Attribute)
            and isinstance(node.ctx, ast.Load)
            and isinstance(node.value, ast.Name) and node.value.id == "self"}


def _declared_names(fn: ast.AST) -> Set[str]:
    """Every string literal in the ``batch_axes`` body: the union of the
    ``shared_in_batch``/``instance_invariant`` tuples however the
    ``BatchAxes`` call is spelled (conditionals, helper variables)."""
    return {node.value for node in ast.walk(fn)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)}


def _check_class(mod, cls, findings) -> None:
    found = methods(cls)
    init = found.get("init_bundle")
    if init is None:
        return                      # RPL501's finding, not this rule's
    attrs = {a for a in _self_reads(init)
             if a != "cfg" and not a.startswith("_") and a not in found}
    if not attrs:
        return
    ba = found.get("batch_axes")
    if ba is None:
        findings.append(mod.finding(
            RPL801, init,
            f"'{cls.name}.init_bundle' reads constructor state "
            f"({', '.join(sorted(attrs))}) but '{cls.name}' declares no "
            f"batch_axes() — solve_many would silently share these "
            f"across every instance; declare them in BatchAxes("
            f"instance_invariant=...) or shared_in_batch"))
        return
    for attr in sorted(attrs - _declared_names(ba)):
        findings.append(mod.finding(
            RPL801, init,
            f"'{cls.name}.init_bundle' reads self.{attr}, which "
            f"batch_axes() never declares — under solve_many every "
            f"instance gets the same {attr}; add it to instance_invariant "
            f"(or shared_in_batch) if that is intended"))


@register_checker("batching", [RPL801])
def check(mod: ModuleSource):
    aliases = import_aliases(mod.tree)
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and registered(node, aliases):
            _check_class(mod, node, findings)
    return findings
