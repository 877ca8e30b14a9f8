"""The harness: finds a cell's files by name, runs its traffic driver,
reads its metrics and judges its outputs, and builds the result line.

A traffic driver (``traffic/<name>.py``) has ``run(ctx) -> Outcome``.
It makes its inputs from ``ctx.seed``, warms up, calls
``ctx.open_window()`` when set-up ends, measures for ``ctx.seconds``,
and returns what it saw (``Outcome.record``, read by the metric
readers), the judge that compares its outputs with the plain reference
once the program's state is freed, and, in a traced run, the profiled
timeline's summary.  A metric reader (``metrics/<name>.py``) has
``LAYER``, ``UNIT``, ``MOVES`` and ``read(record) -> float | None``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
#: top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

_IMPORTED_AT = time.time()


def process_started() -> float:
    """The wall-clock time (``time.time()``) at which this process
    started, from ``/proc``; the import of this module where that is not
    readable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + int(fields[19]) / os.sysconf(
            "SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


# ------------------------------------------------------------ by name
def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return read_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return read_json(HERE / "configs" / f"{name}.json")


def traffic(name: str):
    return importlib.import_module(f"portbench.traffic.{name}")


def work(config_name: str):
    return importlib.import_module(
        f"portbench.work.{config_name.replace('-', '_')}")


def reader(name: str):
    """The reader of metric ``name``, loaded from its own file."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "portbench.metrics." + name.replace(".", "__").replace(
        "-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced.  An entry without ``workloads`` belongs to
    every cell that reports what it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def reports(m):
        if "workloads" in m:
            return cell in m["workloads"]
        return m["moves"] in names

    return [m for m in bench["per_layer"] if reports(m)]


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``
    when not given), each compared whole: ``repro_torch`` is not
    ``repro``."""
    names = list(sys.modules) if modules is None else list(modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# -------------------------------------------------------------- runs
@dataclass
class Outcome:
    """What a traffic driver hands back."""
    record: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    judge: Callable[[], Dict[str, float]]
    device_count: int = 1
    trace: Optional[dict] = None          # busy_s, window_s, breakdown


class Run:
    """What a traffic driver gets: the cell's data and the seed."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", started: Optional[float] = None,
                 spec: Optional[dict] = None):
        self.cell = cell
        self.workload = spec if spec is not None else workload(cell)
        self.config = config(self.workload["config"])
        self.params = self.workload["params"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.started = process_started() if started is None else started
        self.setup_s: Optional[float] = None
        self.window_t0: Optional[float] = None

    def generator(self, *tags, device=None):
        from portbench.seeds import generator
        return generator(self.seed, self.cell, *tags,
                         device=device or self.device)

    def uniform(self, *tags) -> float:
        from portbench.seeds import uniform
        return uniform(self.seed, self.cell, *tags)

    def open_window(self) -> float:
        """Set-up ends here: returns the window's start (perf_counter)."""
        self.setup_s = time.time() - self.started
        self.window_t0 = time.perf_counter()
        return self.window_t0


def _number(v):
    return None if v is None or not math.isfinite(float(v)) else float(v)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", started: Optional[float] = None,
             spec: Optional[dict] = None, log=None) -> dict:
    """Run one cell and return its result line (a dict).  ``device``
    other than ``"cuda"`` and ``spec`` (the cell's workload, in place of
    its file) serve the CPU tests, which skip the look for a chip and
    run at small sizes."""
    import torch
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = benchmark()
    ctx = Run(cell, seed, seconds, trace, device=device, started=started,
              spec=spec)
    limits = ctx.workload["limits"]
    out = traffic(ctx.workload["traffic"]).run(ctx)
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = out.judge()
    metrics = {}
    rec = dict(out.record, setup_s=ctx.setup_s)
    for m in cell_metrics(bench, cell, trace):
        value = _number(reader(m["name"]).read(rec))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    judged = {}
    correct = out.failed == 0 and out.attempted > 0
    for name, value in checks.items():
        limit = limits.get(name)
        ok = limit is not None and value is not None and \
            math.isfinite(value) and value <= limit
        correct = correct and ok
        judged[name] = {"value": value if value is None or
                        math.isfinite(value) else str(value),
                        "limit": limit}
    missing = sorted(set(limits) - set(checks))
    if missing:
        correct = False
        judged["not_compared"] = {"value": ",".join(missing), "limit": ""}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else device),
                   "count": out.device_count,
                   "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": device_info}
    if trace and out.trace is not None:
        device_info["busy_s"] = out.trace["busy_s"]
        device_info["window_s"] = out.trace["window_s"]
        result["breakdown"] = out.trace["breakdown"]
    result["checks"] = judged
    for name, j in judged.items():
        log(f"check {name} {j['value']} limit {j['limit']}")
    return result
