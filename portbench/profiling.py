"""Reading the profiler's trace: device busy time as the union of the
device's operations, its idle share, operations by name, idle gaps by
what the host was doing, and the same restricted to marked intervals.

The arithmetic follows the profile window of the port's ``chip_smoke.py``
(device operations by name, the device's idle share of the profiled
wall), read here from the timeline rather than from sums, so that work
on two streams is not counted twice."""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

#: spans the benchmark records around its calls into the program
SPAN_PREFIX = "portbench."
WINDOW_SPAN = SPAN_PREFIX + "profiled"
MARK_SPAN = SPAN_PREFIX + "chunk_end"
TOP = 10
SHORT_GAP_US = 20.0


def span(name: str):
    """A profiler span around a call into a layer of the program
    (free when no profiler runs)."""
    from torch.profiler import record_function
    return record_function(SPAN_PREFIX + name)


def mark() -> None:
    """A zero-length span: the host passed a chunk boundary."""
    from torch.profiler import record_function
    with record_function(MARK_SPAN):
        pass


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Timeline:
    """The device's operations and the host's spans of one profiled
    block, in microseconds of the profiler's clock."""

    def __init__(self, prof, wall_s: float):
        from torch.autograd import DeviceType
        self.wall_s = wall_s
        self.dev: List[Tuple[float, float, str]] = []
        self.cpu: List[Tuple[float, float, str]] = []
        self.marks: List[float] = []
        window = None
        for ev in prof.events():
            a, b = float(ev.time_range.start), float(ev.time_range.end)
            if ev.device_type == DeviceType.CUDA:
                # the device's copy of a host span is no operation
                if not (getattr(ev, "is_user_annotation", False)
                        or ev.name.startswith(SPAN_PREFIX)):
                    self.dev.append((a, b, ev.name))
            elif ev.name == WINDOW_SPAN:
                window = (a, b)
            elif ev.name == MARK_SPAN:
                self.marks.append(b)
            else:
                self.cpu.append((a, b, ev.name))
        self.dev.sort()
        self.marks.sort()
        if window is None:
            lo = min([a for a, _, _ in self.dev + self.cpu], default=0.0)
            window = (lo, lo + wall_s * 1e6)
        self.window = window
        self._busy = _union([(a, b) for a, b, _ in self.dev])

    # ---------------------------------------------------------- sums
    def busy_s(self, lo: Optional[float] = None,
               hi: Optional[float] = None) -> float:
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return sum(max(0.0, min(b, hi) - max(a, lo))
                   for a, b in self._busy) / 1e6

    def ops(self, lo: float, hi: float) -> int:
        """Device operations that start in ``[lo, hi)``."""
        return sum(1 for a, _, _ in self.dev if lo <= a < hi)

    def device_s(self, lo: float, hi: float, match: str) -> float:
        """Busy seconds of the operations whose name holds ``match``."""
        return sum(max(0.0, min(b, hi) - max(a, lo))
                   for a, b in _union([(a, b) for a, b, name in self.dev
                                       if match.lower() in name.lower()])
                   ) / 1e6

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    # ---------------------------------------------------- breakdown
    def top_ops(self) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for a, b, name in self.dev:
            by[name[:120]] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """The idle stretches of the device, summed by what the host was
        doing at their middle: the innermost benchmark span and the
        innermost host operation there.  Stretches shorter than
        ``SHORT_GAP_US`` are summed as one entry."""
        import numpy as np
        lo, hi = self.window
        edges = [lo] + [x for ab in self._busy for x in ab] + [hi]
        starts = np.array([a for a, _, _ in self.cpu], dtype=np.float64)
        ends = np.array([b for _, b, _ in self.cpu], dtype=np.float64)
        ours = np.array([n.startswith(SPAN_PREFIX) for _, _, n in self.cpu],
                        dtype=bool)
        by: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b - a <= 0:
                continue
            if b - a < SHORT_GAP_US:
                by[f"gaps under {SHORT_GAP_US:g} us"] += (b - a) / 1e6
                continue
            t = 0.5 * (a + b)
            cover = (starts <= t) & (ends >= t)
            by[self._label(cover & ours, cover & ~ours, ends - starts)] += \
                (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def _label(self, ours, other, length) -> str:
        import numpy as np

        def innermost(mask):
            idx = np.flatnonzero(mask)
            return self.cpu[idx[np.argmin(length[idx])]][2] if idx.size \
                else None

        span = innermost(ours)
        label = span[len(SPAN_PREFIX):] if span else "outside spans"
        return f"{label}: {innermost(other) or 'python'}"[:120]


@contextmanager
def profiled(torch, enabled: bool = True):
    """Profile the block (CPU and CUDA); yields a holder whose
    ``timeline`` is set on exit.  ``enabled=False`` profiles nothing."""
    holder = type("Profiled", (), {"timeline": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW_SPAN):
            yield holder
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    holder.timeline = Timeline(prof, wall)


def chunks_after_first(tl: Timeline):
    """``(lo, hi)`` of the chunks after the first of the one run the
    block profiled: the stretch from its first chunk mark to its last."""
    if len(tl.marks) < 2:
        return None
    return tl.marks[0], tl.marks[-1]
