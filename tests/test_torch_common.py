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


def test_build_compiles_each_source_apart_and_logs_it(tmp_path,
                                                      monkeypatch):
    """One compiler process per ``.cu`` (headers are only hashed), each
    one's output and seconds kept in the library's log; a stand-in
    ``nvcc`` records what it was asked to do."""
    import sys
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "shared.cuh"):
        (csrc / name).write_text(f"// {name}\n")
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        f"open({str(calls)!r}, 'a').write(' '.join(args) + '\\n')\n"
        "open(args[args.index('-o') + 1], 'wb').close()\n"
        "if '-c' in args:\n"
        "    print('ptxas info: compiled', args[args.index('-c') + 1])\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(common, "CSRC", csrc)
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(common, "_nvcc", lambda: str(nvcc))
    out = common.build_library()
    assert out.exists() and out == common.library_path()
    compiled = [line.split(" -c ")[1].split()[0]
                for line in calls.read_text().splitlines() if " -c " in line]
    assert sorted(compiled) == [str(csrc / "a.cu"), str(csrc / "b.cu")]
    log = (out.parent / (out.name + ".log")).read_text()
    for name in ("a.cu", "b.cu"):
        assert re.search(rf"^== {name} \(\d+\.\d s\)\n"
                         rf"ptxas info: compiled .*{name}$", log, re.M)
    # built once: a second call finds the library for these sources
    assert common.build_library() == out
    assert len(calls.read_text().splitlines()) == 3
