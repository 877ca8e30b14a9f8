"""Kernel-family contracts of the port (``kernels/<family>/``).

RPL203 ref-parity       : a family lacks ``ops.py`` or ``ref.py``, or a
                          plain version ``<name>_ref`` in ``ref.py`` has
                          no public wrapper ``<name>`` in ``ops.py``, or
                          the two signatures disagree.  The wrapper may
                          add its control parameters (``use_kernel``,
                          ``device``).  Read from the syntax trees: the
                          linter imports nothing it checks.
RPL204 kernel-fallback  : a ``try`` in a family's ``ops.py`` or
                          ``kernel.py`` whose handler calls into the
                          family's plain version or swallows the error
                          (no ``raise``), or a ``contextlib.suppress``
                          there.  The port's contract is the opposite of
                          the JAX package's ``interpret=`` fallback
                          (RPL202 there): a tensor on the card launches
                          its kernel or raises
                          (``repro_torch/kernels/common.py``), so a
                          launch that failed never turns into a slower
                          run that looks right.  The CPU route
                          (``if not use_kernel: return <name>_ref(...)``,
                          chosen before any launch) is not a fallback.

The JAX package's RPL201 (BlockSpec against grid) has no counterpart
here: the port's grids and block shapes live in ``csrc/*.cu``, beside
the launch each kernel's wrapper checks.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.lint.checkers._ast_util import (import_aliases,
                                                 kernel_family, resolve)
from repro_torch.lint.core import Finding, ModuleSource, Rule, register_checker

RPL203 = Rule("RPL203", "ref-parity",
              "kernel ops.py / ref.py signature parity violation")
RPL204 = Rule("RPL204", "kernel-fallback",
              "kernel wrapper falls back to its plain version or "
              "swallows a launch error")

# the control parameters a wrapper may add to its plain version's
CONTROL_PARAMS = frozenset({"use_kernel", "device"})


def _top_level_bindings(tree: ast.Module) -> Dict[str, Optional[ast.AST]]:
    """Module-level names: their FunctionDef, or None where an import or
    an assignment binds them."""
    out: Dict[str, Optional[ast.AST]] = {}
    for st in tree.body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[st.name] = st
        elif isinstance(st, (ast.Import, ast.ImportFrom)):
            for a in st.names:
                out[a.asname or a.name.split(".")[0]] = None
        elif isinstance(st, ast.Assign):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = None
    return out


def _math_params(fn) -> List[str]:
    """The signature minus the control parameters and ``*args``/``**kw``:
    the part a wrapper and its plain version share."""
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            if p.arg not in CONTROL_PARAMS]


def _parse(path: Path) -> Optional[ast.Module]:
    try:
        return ast.parse(path.read_text(), filename=str(path))
    except SyntaxError:
        return None                      # that file's own RPL000


def _check_parity(mod: ModuleSource) -> List[Finding]:
    ref_path = mod.path.with_name("ref.py")
    if not ref_path.exists():
        return [Finding(str(mod.path), 1, 0, RPL203,
                        "kernel family has no sibling ref.py")]
    ref_tree = _parse(ref_path)
    if ref_tree is None:
        return []
    ops = _top_level_bindings(mod.tree)
    findings: List[Finding] = []
    for st in ref_tree.body:
        if not isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)) or \
                st.name.startswith("_") or not st.name.endswith("_ref"):
            continue
        pub = st.name[:-len("_ref")]
        if pub not in ops:
            findings.append(Finding(
                str(mod.path), 1, 0, RPL203,
                f"ref.py declares {st.name} but ops.py has no public "
                f"'{pub}' wrapper"))
            continue
        wrapper = ops[pub]
        if wrapper is None:
            continue                     # re-exported: nothing to compare
        want, got = _math_params(st), _math_params(wrapper)
        if want != got:
            findings.append(Finding(
                str(mod.path), wrapper.lineno, wrapper.col_offset, RPL203,
                f"'{pub}' signature drifted from its plain version: ops.py "
                f"takes {got}, ref.py takes {want} (control parameters "
                f"{sorted(CONTROL_PARAMS)} excluded)"))
    return findings


def _calls_ref(handler: ast.ExceptHandler, family: str, aliases) -> bool:
    """Whether the handler calls a plain version: a ``*_ref`` name or
    anything of the family's ``ref`` module."""
    ref_module = f"repro_torch.kernels.{family}.ref"
    for node in ast.walk(handler):
        if isinstance(node, ast.Call):
            name = resolve(node.func, aliases) or ""
            if name.split(".")[-1].endswith("_ref") or \
                    name.startswith(ref_module + "."):
                return True
    return False


def _check_fallbacks(mod: ModuleSource, family: str) -> List[Finding]:
    aliases = import_aliases(mod.tree)
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ExceptHandler):
            if _calls_ref(node, family, aliases):
                findings.append(mod.finding(
                    RPL204, node,
                    "the handler falls back to the plain version after a "
                    "failure — a tensor on the card launches its kernel or "
                    "raises (repro_torch/kernels/common.py)"))
            elif not any(isinstance(n, ast.Raise) for n in ast.walk(node)):
                findings.append(mod.finding(
                    RPL204, node,
                    "the handler swallows the error — a failed launch must "
                    "raise (repro_torch/kernels/common.py)"))
        elif isinstance(node, ast.Call) and \
                (resolve(node.func, aliases) or "").split(".")[-1] \
                == "suppress":
            findings.append(mod.finding(
                RPL204, node,
                "suppress(...) swallows the error — a failed launch must "
                "raise (repro_torch/kernels/common.py)"))
    return findings


@register_checker("kernels", [RPL203, RPL204])
def check(mod: ModuleSource):
    family = kernel_family(mod.path)
    if family is None or mod.path.name not in ("ops.py", "kernel.py"):
        return []
    findings = _check_fallbacks(mod, family)
    if mod.path.name == "ops.py":
        findings.extend(_check_parity(mod))
    else:
        for sibling in ("ops.py", "ref.py"):
            if not mod.path.with_name(sibling).exists():
                findings.append(Finding(
                    str(mod.path), 1, 0, RPL203,
                    f"kernel family has no sibling {sibling}"))
    return findings
