"""The ``ctypes`` bindings of the port's kernel library against the C
entry points they call.

``ctypes`` trusts the argument types it is given: an entry point whose
C signature drifts from its ``_SIGNATURES`` row would be called with
shifted arguments on the card, not refused.  This reads every
``extern "C" int`` declaration in ``src/repro_torch/csrc/*.cu`` and
holds it against its row, argument by argument, on any host.
"""
import ctypes
import re

import pytest

from repro_torch.kernels import common

_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _c_type(arg: str):
    """A C parameter declaration -> the ctypes type it must bind to."""
    if "*" in arg:
        return ctypes.c_void_p
    words = arg.split()[:-1]
    return {("int",): ctypes.c_int, ("long", "long"): ctypes.c_longlong,
            ("float",): ctypes.c_float}[tuple(words)]


def _declarations():
    found = {}
    for src in sorted(common.CSRC.glob("*.cu")):
        for name, args in _DECL.findall(src.read_text()):
            found[name] = tuple(_c_type(a.strip()) for a in args.split(","))
    return found


def test_every_entry_point_is_bound():
    assert sorted(_declarations()) == sorted(common._SIGNATURES)


@pytest.mark.parametrize("name", sorted(common._SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    assert common._SIGNATURES[name] == _declarations()[name]
