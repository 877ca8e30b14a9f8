"""Reading the program's own spans (``repro_torch.core.spans``) on a
profiled timeline (``profiling.Timeline``): their seconds by name, the
driver's enqueue time over the chunks after the first, and the device's
idle stretches by the innermost program span at their middle.

``trace_spans(tl)`` gives what a traced record adds for the readers of
``init_ms.*``, ``draws_ms.deconv``, ``norms_ms.deconv``,
``finalize_ms.*`` and ``launch_ms_per_iter.*`` (``metrics/``):
``spans``, ``launch_s`` and ``idle_by_span``.  ``loop.trace_entry`` does
not call it yet, so in a run of ``run.py`` those readers find nothing.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs one cell traced, as ``run.py --trace 1`` does, with its traced
record extended by ``trace_spans``, and prints the result line with the
readings of those readers (``program_spans``), the spans' seconds and
``breakdown.idle_by_span``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

from portbench import profiling

PROGRAM_PREFIX = "repro_torch."
OUTSIDE = "outside program spans"
LAUNCH = "driver.launch"
#: the readers of the program's spans, with the cells they read
METRICS = {
    "init_ms.deconv": "deconv-sparse-10k",
    "draws_ms.deconv": "deconv-sparse-10k",
    "norms_ms.deconv": "deconv-sparse-10k",
    "finalize_ms.deconv": "deconv-sparse-10k",
    "launch_ms_per_iter.deconv": "deconv-sparse-10k",
    "init_ms.scdl": "scdl-40k",
    "finalize_ms.scdl": "scdl-40k",
    "launch_ms_per_iter.scdl": "scdl-40k",
    "launch_ms_per_iter.mesh": "scdl-40k-4chip",
}


def program_spans(tl) -> List[tuple]:
    """``(start, end, name)`` of the program's spans on the host, the
    name without ``repro_torch.``."""
    n = len(PROGRAM_PREFIX)
    return [(a, b, name[n:]) for a, b, name in tl.cpu
            if name.startswith(PROGRAM_PREFIX)]


def span_s(tl, name: str, lo: Optional[float] = None,
           hi: Optional[float] = None) -> float:
    """Summed seconds of the program spans called ``name``; with ``lo``
    and ``hi``, of those that start in ``[lo, hi)``."""
    lo = float("-inf") if lo is None else lo
    hi = float("inf") if hi is None else hi
    return sum(b - a for a, b, n in program_spans(tl)
               if n == name and lo <= a < hi) / 1e6


def idle_by_span(tl) -> List[List]:
    """The device's idle stretches in the window summed by the innermost
    program span that covers each one's middle (``OUTSIDE`` where none
    does); stretches shorter than ``profiling.SHORT_GAP_US`` are summed as
    one entry, and the ``profiling.TOP`` largest entries are kept."""
    spans = program_spans(tl)
    lo, hi = tl.window
    edges = [lo] + [x for ab in tl._busy for x in ab] + [hi]
    by: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if b - a < profiling.SHORT_GAP_US:
            by[f"gaps under {profiling.SHORT_GAP_US:g} us"] += (b - a) / 1e6
            continue
        t = 0.5 * (a + b)
        cover = [(e - s, n) for s, e, n in spans if s <= t <= e]
        by[min(cover)[1] if cover else OUTSIDE] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(),
                                      key=lambda kv: -kv[1])[:profiling.TOP]]


def trace_spans(tl) -> dict:
    """What a traced record adds: ``spans`` (seconds by name over the
    profiled unit), ``launch_s`` (``driver.launch`` seconds over the
    chunks after the first, the stretch of ``ops`` and ``device_s``) and
    ``idle_by_span``."""
    spans: Dict[str, float] = defaultdict(float)
    for a, b, name in program_spans(tl):
        spans[name] += (b - a) / 1e6
    out = {"spans": dict(spans), "idle_by_span": idle_by_span(tl)}
    stretch = profiling.chunks_after_first(tl)
    if stretch is not None:
        out["launch_s"] = span_s(tl, LAUNCH, *stretch)
    return out


# ------------------------------------------------------------ readers
def span_ms(rec, name: str):
    """Milliseconds of the program spans ``name`` in the traced unit."""
    spans = (rec.get("trace") or {}).get("spans") or {}
    return 1e3 * spans[name] if name in spans else None


def launch_ms_per_iter(rec):
    """``driver.launch`` milliseconds per iteration over the chunks after
    the first of the traced unit."""
    t = rec.get("trace") or {}
    if t.get("launch_s") is None or not t.get("iters"):
        return None
    return 1e3 * t["launch_s"] / t["iters"]


# ---------------------------------------------------------------- run
def main(argv=None) -> int:
    import argparse
    import json

    from portbench import run  # noqa: F401 (the command's caches and paths)
    from portbench import harness, loop

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    started = harness.process_started()
    plain, traced = loop.trace_entry, []

    def trace_entry(tl, iters_per_chunk, work_count):
        out = plain(tl, iters_per_chunk, work_count)
        extra = trace_spans(tl)
        out["breakdown"]["idle_by_span"] = extra.pop("idle_by_span")
        out.update(extra)
        # the unit's wall outside its chunks (launch and sync)
        unit_s = sum(b - a for a, b, n in tl.cpu
                     if n == profiling.SPAN_PREFIX + "solve") / 1e6
        out["outside_chunks_s"] = unit_s - sum(
            span_s(tl, n) for n in (LAUNCH, "driver.sync"))
        traced.append(out)
        return out

    loop.trace_entry = trace_entry
    result = harness.run_cell(args.workload, args.seed, args.seconds, True,
                              started=started)
    rec = {"trace": traced[-1]} if traced else {}
    result["program_spans"] = {
        name: harness.reader(name).read(rec) for name, cell in METRICS.items()
        if cell == args.workload}
    if traced:
        for key in ("spans", "launch_s", "outside_chunks_s"):
            result[key] = traced[-1].get(key)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
