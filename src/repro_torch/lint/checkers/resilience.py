"""RPL701 swallowed-exception: recovery-path code does not silently
swallow broad exceptions.

In the port's ``core/``, ``checkpoint/`` and ``resilience/`` an
``except:`` / ``except Exception:`` / ``except BaseException:`` handler
that neither re-raises nor routes the exception into the resilience
machinery turns a worker failure into silent state corruption, the
failure the supervised solve exists to make loud.  Outside those
packages broad handlers are left to review; inside them every caught
exception either propagates (``raise``) or reaches a recognised router:
the transient/fatal classifier or a record/surface hook (``classify``,
``record_fault``, ``_record_failure``, ``_raise_pending``, ...).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.lint.core import Finding, ModuleSource, Rule, register_checker

RPL701 = Rule("RPL701", "swallowed-exception",
              "broad except clause swallows exceptions in recovery-path "
              "code without re-raising or routing them")

# path fragments that put a module in scope (posix)
_SCOPED = ("repro_torch/core/", "repro_torch/checkpoint/",
           "repro_torch/resilience/")

# calls that route the exception into the resilience machinery (bare
# names or method attributes)
_ROUTERS = frozenset({"classify", "classify_error", "record_fault",
                      "record_failure", "_record_failure",
                      "_raise_pending"})

_BROAD = frozenset({"Exception", "BaseException"})


def _broad_name(handler: ast.ExceptHandler) -> str:
    """The overbroad catch spelling, or '' when the handler is narrow."""
    t = handler.type
    if t is None:
        return "bare except:"
    for n in t.elts if isinstance(t, ast.Tuple) else [t]:
        name = n.id if isinstance(n, ast.Name) else \
            n.attr if isinstance(n, ast.Attribute) else None
        if name in _BROAD:
            return f"except {name}"
    return ""


def _handled(handler: ast.ExceptHandler) -> bool:
    """Whether the handler re-raises or calls a router."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else \
                fn.attr if isinstance(fn, ast.Attribute) else None
            if name in _ROUTERS:
                return True
    return False


@register_checker("resilience", [RPL701])
def check(mod: ModuleSource):
    if not any(frag in mod.path.as_posix() for frag in _SCOPED):
        return []
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ExceptHandler):
            broad = _broad_name(node)
            if broad and not _handled(node):
                findings.append(mod.finding(
                    RPL701, node,
                    f"{broad} swallows the exception — re-raise it or "
                    f"route it through the resilience machinery "
                    f"(repro_torch.resilience.errors.classify / "
                    f"record_fault / _record_failure); a silent failure on "
                    f"the recovery path corrupts state"))
    return findings
