"""A closed loop of one caller: units of work (a catalogue's solve, a
training) run back to back for the window, each from its raw inputs.

The record it builds is what the metric readers read:

- ``window_s``: from the window's start to the end of the last unit that
  returned inside it; ``units``: each such unit's wall seconds, the sum
  of its chunks' seconds (``RunLog.times``), its iterations, the
  per-iteration seconds of its chunks after the first, and its ``work``
  (stamps or samples);
- ``trace`` (traced runs): one more unit after the window under the
  profiler, with the device's busy and wall seconds, and over its chunks
  after the first the iterations, device seconds, device operations and
  collective seconds, beside the work count of one iteration.
"""
from __future__ import annotations

import sys
import time
import traceback

from portbench import profiling


def memory_peak(torch, device) -> int:
    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0


def sync(torch, device) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def unit_entry(log, wall_s: float, chunk: int, work: int) -> dict:
    times = list(log.times)
    return {"wall_s": wall_s, "chunk_s": float(sum(times)),
            "iters": len(times), "work": work,
            "iter_s": [times[i] for i in range(chunk, len(times), chunk)]}


def trace_entry(tl, iters_per_chunk: int, work_count: dict) -> dict:
    """The traced unit's numbers, from its timeline."""
    out = {"busy_s": tl.busy_s(), "window_s": tl.window_s,
           "work": work_count,
           "breakdown": {"device_ops": tl.top_ops(),
                         "idle_gaps": tl.idle_gaps()}}
    span = profiling.chunks_after_first(tl)
    if span is not None:
        lo, hi = span
        out.update(iters=iters_per_chunk * (len(tl.marks) - 1),
                   device_s=tl.busy_s(lo, hi), ops=tl.ops(lo, hi),
                   nccl_s=tl.device_s(lo, hi, "nccl"))
    return out


def closed_loop(ctx, torch, unit, n_inputs: int, chunk: int,
                work_count: dict):
    """Run ``unit(k, progress_fn) -> (kept, log, work)`` on input ``k``
    (cycling over ``n_inputs``) once to warm up, then back to back for
    the window, then, traced, once more under the profiler.  Returns
    ``(record, attempted, failed, kept)`` with ``kept`` the last result
    of every input that returned inside the window."""
    dev = ctx.device
    unit(0, None)
    sync(torch, dev)
    t0 = ctx.open_window()
    t_end = t0 + ctx.seconds
    units, kept = [], {}
    attempted = failed = 0
    last_end = t0
    while time.perf_counter() < t_end:
        k = attempted % n_inputs
        attempted += 1
        a = time.perf_counter()
        try:
            res, log, work = unit(k, None)
        except Exception:                       # noqa: BLE001 (reported)
            failed += 1
            if failed == 1:
                traceback.print_exc(file=sys.stderr)
            continue
        b = time.perf_counter()
        if b <= t_end:
            units.append(unit_entry(log, b - a, chunk, work))
            kept[k] = res
            last_end = b
    record = {"window_s": last_end - t0, "units": units,
              "memory_peak_bytes": memory_peak(torch, dev)}
    if ctx.trace:
        def progress(event):
            profiling.mark()

        with profiling.profiled(torch, dev == "cuda") as prof:
            unit(attempted % n_inputs, progress)
        if prof.timeline is not None:
            record["trace"] = trace_entry(prof.timeline, chunk, work_count)
    return record, attempted, failed, kept
