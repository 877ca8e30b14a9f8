"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``.

Two guards: a fresh interpreter imports every module of the port (and
the smoke script) and then finds no ``jax``, ``jaxlib`` or ``repro``
module loaded; and a scan of the sources finds no such import statement
or ``import_module`` call, including in functions that the first guard
never runs.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or
             m.startswith(("jax.", "jaxlib.", "repro.")))
print(len(names), bad)
assert not bad, bad
"""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    count, bad = out.stdout.split(maxsplit=1)
    assert int(count) >= 15 and bad.strip() == "[]"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__") and \
                    _forbidden(node.args[0].value):
                found.append(node.args[0].value)
    assert not found, f"{path.relative_to(ROOT)} imports {found}"


def test_port_has_its_own_kernel_sources():
    """Every kernel family of the slice has a CUDA source and the
    ref/kernel/ops triple beside it."""
    for family, source in (("starlet2d", "starlet2d.cu"),
                           ("condat_elwise", "condat_elwise.cu"),
                           ("admm_elwise", "admm_elwise.cu"),
                           ("dict_outer", "dict_outer.cu")):
        assert (PORT / "csrc" / source).is_file()
        for part in ("ref.py", "kernel.py", "ops.py"):
            assert (PORT / "kernels" / family / part).is_file()
