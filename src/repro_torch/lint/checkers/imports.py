"""RPL601 noncanonical-import: the kernel families' shared helpers are
imported from ``repro_torch.kernels.common``, their canonical home.

Every family's ``kernel.py`` and ``ops.py`` binds ``common`` and calls
its helpers (the chaos point, the route choice, the launch checks, the
library), so ``from repro_torch.kernels.condat_elwise.kernel import
require_cuda`` or ``... import common`` resolves today.  Importing a
helper *through* a family couples unrelated families and pins the
importer to whichever module happened to bind the name; one canonical
home keeps the launch contract (no fallback, one error check, one
counter) in one place.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.lint.core import Finding, ModuleSource, Rule, register_checker

RPL601 = Rule("RPL601", "noncanonical-import",
              "shared kernel helper imported from a non-canonical module")

_CANONICAL = "repro_torch.kernels.common"
# what kernels/common.py defines and the families' kernel.py / ops.py
# use, and the module itself
_SHARED_HELPERS = frozenset({
    "common", "chaos_point", "on_card", "require_cuda", "library", "check",
    "stream_ptr", "device_scalar", "DTYPE_CODES", "PLAIN_DEVICES"})


@register_checker("imports", [RPL601])
def check(mod: ModuleSource):
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ImportFrom) or node.module is None \
                or node.level > 0 or node.module == _CANONICAL \
                or not node.module.startswith("repro_torch.kernels."):
            continue
        for alias in node.names:
            if alias.name in _SHARED_HELPERS:
                findings.append(mod.finding(
                    RPL601, node,
                    f"'{alias.name}' imported from '{node.module}' — "
                    f"import it from its canonical home '{_CANONICAL}'"))
    return findings
