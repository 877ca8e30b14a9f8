"""Shared AST helpers for the checkers: dotted-name resolution through
the import aliases, the port's registry decorator, parameters, and the
kernel-family layout."""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# the port's package: names that resolve into it are the port's own
PORT = "repro_torch"


def dotted(node) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> the fully qualified module or object it is bound to:
    ``import torch.nn.functional as F`` (F -> torch.nn.functional),
    ``from x.y import z [as w]`` (w -> x.y.z)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def resolve(node, aliases: Dict[str, str]) -> Optional[str]:
    """The fully qualified dotted name of an expression, through the
    import aliases: with ``import numpy as np``, ``np.sum`` ->
    ``numpy.sum``."""
    d = dotted(node)
    if d is None:
        return None
    head, _, rest = d.partition(".")
    base = aliases.get(head, head)
    return f"{base}.{rest}" if rest else base


def port_name(name: Optional[str], leaf_names) -> bool:
    """Whether ``name`` (resolved) ends in one of ``leaf_names`` and is
    the port's own: imported from ``repro_torch`` or a bare local name.
    The JAX package's counterparts (``repro.core.driver.IterativeDriver``)
    are not."""
    if name is None:
        return False
    leaf = name.split(".")[-1]
    return leaf in leaf_names and (name == leaf
                                   or name.startswith(PORT + "."))


def registered(cls: ast.ClassDef, aliases) -> bool:
    """Whether ``cls`` is decorated with the port's ``@register(...)``."""
    return any(isinstance(dec, ast.Call)
               and port_name(resolve(dec.func, aliases), ("register",))
               for dec in cls.decorator_list)


def methods(cls: ast.ClassDef) -> Dict[str, ast.AST]:
    return {st.name: st for st in cls.body
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef))}


def param_names(fn) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def params_with_defaults(fn) -> set:
    """Parameter names that carry a default (positional or keyword-only)."""
    a = fn.args
    pos = a.posonlyargs + a.args
    out = {p.arg for p, _ in zip(reversed(pos), reversed(a.defaults))}
    out |= {p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
            if d is not None}
    return out


def assigned_pairs(target, value) -> List[Tuple[str, Optional[ast.AST]]]:
    """(name, the value bound to it where it can be told) for an
    assignment ``target = value``: ``a, b = x, y`` pairs a with x; a
    tuple target over any other value gets None."""
    if isinstance(target, ast.Name):
        return [(target.id, value)]
    if isinstance(target, ast.Starred):
        return assigned_pairs(target.value, None)
    if isinstance(target, (ast.Tuple, ast.List)):
        if isinstance(value, (ast.Tuple, ast.List)) and \
                len(value.elts) == len(target.elts) and \
                not any(isinstance(e, ast.Starred) for e in value.elts):
            return [p for t, v in zip(target.elts, value.elts)
                    for p in assigned_pairs(t, v)]
        return [p for t in target.elts for p in assigned_pairs(t, None)]
    return []


def kernel_family(path: Path) -> Optional[str]:
    """The family of a module ``kernels/<family>/<name>.py``, else None."""
    if path.parent.parent.name == "kernels":
        return path.parent.name
    return None
