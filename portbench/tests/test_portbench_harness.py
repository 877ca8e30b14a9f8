"""The harness is driven by data: every cell, configuration, traffic
driver, metric and work count is a file of its own, found by name."""
import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = harness.workload(cell)
    for key in ("name", "config", "chips"):
        assert wl[key] == entry[key]
    # the mix's name begins with the name of the driver that reads it
    assert entry["traffic"].split(".")[0] == wl["traffic"]
    assert wl["why"] == entry["why"] and len(wl["why"]) <= 200
    assert callable(harness.traffic(wl["traffic"]).run)
    assert wl["limits"], "every cell compares something"
    cfg = harness.config(wl["config"])
    assert cfg["name"] == wl["config"]
    reported = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.cell_metrics(BENCH, cell, True)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert callable(harness.work(c["name"]).per_iteration)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(m):
    r = harness.reader(m["name"])
    assert r.UNIT == m["unit"]
    assert r.read({}) is None          # nothing to read: no number
    if "layer" in m:
        assert r.LAYER == m["layer"] and r.MOVES == m["moves"]


@pytest.mark.parametrize("path", sorted((ROOT / "portbench/metrics").glob(
    "*.py")), ids=lambda p: p.stem)
def test_every_reader_file(path):
    """Readers of metrics that no cell reports yet (kept for a cell a
    later change adds) are whole too."""
    r = harness.reader(path.stem)
    assert isinstance(r.LAYER, str) and "\n" not in r.LAYER
    assert isinstance(r.UNIT, str) and UNIT.match(r.UNIT)
    assert isinstance(r.MOVES, str) and r.read({}) is None


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_by_each_cell(m):
    for cell in m["workloads"]:
        e2e = {x["name"] for x in harness.cell_metrics(BENCH, cell, False)}
        assert m["moves"] in e2e, (m["name"], cell)
        assert m["name"] in {x["name"] for x in
                             harness.cell_metrics(BENCH, cell, True)}


def test_a_new_cell_and_metric_need_no_edit(tmp_path):
    """A throwaway cell and metric, added as files and entries in a copy,
    are picked up with no file of the harness edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = harness.workload("deconv-sparse-10k")
    wl.update(name="deconv-throwaway", why="a throwaway cell")
    (tmp_path / "portbench/workloads/deconv-throwaway.json").write_text(
        json.dumps(wl))
    (tmp_path / "portbench/metrics/throwaway_ms.py").write_text(
        'LAYER = "driver"\nUNIT = "ms"\nMOVES = "stamps_per_s"\n\n\n'
        'def read(rec):\n    return 1e3 * rec["window_s"]\n')
    bench["workloads"].append({"name": "deconv-throwaway",
                               "config": "galaxy-deconv",
                               "traffic": "throwaway", "chips": 1,
                               "why": "a throwaway cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "deconv-sparse-10k" in m.get("workloads", []):
            m["workloads"].append("deconv-throwaway")
    bench["per_layer"].append({"name": "throwaway_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "driver", "moves": "stamps_per_s",
                               "workloads": ["deconv-throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]\n"
        "from portbench import harness\n"
        "b = harness.benchmark()\n"
        "names = [m['name'] for m in "
        "harness.cell_metrics(b, 'deconv-throwaway', True)]\n"
        "r = harness.reader('throwaway_ms').read({'window_s': 2.0})\n"
        "t = harness.traffic(harness.workload('deconv-throwaway')['traffic'])\n"
        "print(json.dumps([names, r, t.__name__, harness.__file__]))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, cwd=tmp_path)
    names, value, traffic, where = json.loads(out.stdout.splitlines()[-1])
    assert "throwaway_ms" in names and "iter_ms.deconv" in names
    assert value == 2000.0
    assert traffic == "portbench.traffic.catalogue_loop"
    assert where.startswith(str(tmp_path))


def _imports(path):
    tree = ast.parse(path.read_text())
    out = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
           for a in n.names}
    out |= {n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    return {m.split(".")[0] for m in out}


def test_no_jax_and_no_jax_package():
    """Judged by the whole top-level name: ``repro_torch`` passes,
    ``repro`` does not."""
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path
    probe = (
        "import sys, pkgutil, importlib, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import portbench, portbench.traffic, portbench.work\n"
        "from portbench import harness\n"
        "for pkg in (portbench, portbench.traffic, portbench.work):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        if m.name not in ('run', 'control', 'tests'):\n"
        "            importlib.import_module(pkg.__name__ + '.' + m.name)\n"
        "for m in harness.benchmark()['end_to_end'] + "
        "harness.benchmark()['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "import repro_torch.core.problem, repro_torch.serve.server\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True)
    assert json.loads(out.stdout.splitlines()[-1]) == []
    ref = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
         "import portbench.reference.deconv_sparse, portbench.reference.scdl, "
         "portbench.reference.compare\n"
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('repro_torch', 'repro', 'jax')))"],
        capture_output=True, text=True, check=True)
    assert ref.stdout.strip() == "[]"


def test_forbidden_names_compare_whole():
    port = ["repro_torch", "repro_torch.core.problem", "reprox", "jaxtyping",
            "torch", "portbench.harness"]
    assert harness.forbidden_modules(port) == []
    assert harness.forbidden_modules(port + ["repro.imaging"]) == ["repro"]
    assert harness.forbidden_modules(["jax._src.core", "flax"]) == [
        "flax", "jax"]


def test_command_refuses_without_the_card(tmp_path):
    """Without CUDA, or in a directory holding only the benchmark, the
    command exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench/run.py"), "--workload",
         "deconv-sparse-10k", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    alone = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "scdl-40k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin"})
    assert alone.returncode != 0 and alone.stdout.strip() == ""
