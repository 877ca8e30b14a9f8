"""RPL901 untracked-task: the serving layer's asyncio tasks do not drop
their exceptions.

In the port's ``serve/`` a task spawned with ``asyncio.create_task`` /
``asyncio.ensure_future`` (or ``loop.create_task``) whose handle is
discarded (a bare expression statement, or a name never used again)
loses its exception: asyncio reports it only as "Task exception was
never retrieved" when the task is collected, long after the service
silently stopped doing what the task was for (a dead watchdog no longer
reaps hung dispatches).  A spawned task is awaited, gathered, stored on
an object, returned, or given an ``add_done_callback`` that retrieves
its exception.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.lint.core import Finding, ModuleSource, Rule, register_checker

RPL901 = Rule("RPL901", "untracked-task",
              "asyncio task spawned in repro_torch/serve/ whose handle "
              "(and exception) is dropped")

_SCOPED = "repro_torch/serve/"
_SPAWNERS = frozenset({"create_task", "ensure_future"})


def _spawns_task(call: ast.Call) -> str:
    fn = call.func
    name = fn.id if isinstance(fn, ast.Name) else \
        fn.attr if isinstance(fn, ast.Attribute) else None
    return name if name in _SPAWNERS else ""


def _flag(mod: ModuleSource, node, spawn: str, how: str) -> Finding:
    return mod.finding(
        RPL901, node,
        f"{spawn}(...) {how} — its exception is never retrieved and the "
        f"task dies silently; await/gather it, store the handle, or "
        f"attach an add_done_callback that calls .exception()")


@register_checker("serve", [RPL901])
def check(mod: ModuleSource):
    if _SCOPED not in mod.path.as_posix():
        return []
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        # a bare statement spawn anywhere in the module
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call) \
                and _spawns_task(node.value):
            findings.append(_flag(mod, node, _spawns_task(node.value),
                                  "discards the task handle"))
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # a handle assigned to a local name that is never read
        assigns, loads = [], set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 and \
                    isinstance(sub.targets[0], ast.Name) and \
                    isinstance(sub.value, ast.Call) and \
                    _spawns_task(sub.value):
                assigns.append((sub, sub.targets[0].id,
                                _spawns_task(sub.value)))
            elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                loads.add(sub.id)
        for sub, name, spawn in assigns:
            if name not in loads:
                findings.append(_flag(
                    mod, sub, spawn,
                    f"handle {name!r} is assigned but never used"))
    return findings
