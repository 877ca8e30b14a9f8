"""Device time by the host span that launched it.

The profiler records each launch on the host (the CUDA runtime's call,
``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) and the operation it
started on the device under one correlation id, their events' ``id``.
An operation was launched under a program span when its launch call
starts inside one of that span's intervals on the host, whatever issued
it: a PyTorch operation, a library, or a kernel of the port bound with
``ctypes``, which no PyTorch operation owns.  Device time is thus
attributed by where the host was when it enqueued the work, not by when
the device ran it.

``trace_launches(events, tl, name)`` gives what a traced record adds for
the readers of ``svt_ms_per_iter.lowrank`` and ``roofline.lowrank_svt``
(``metrics/``): over the chunks after the first (the stretch of
``ops`` and ``device_s``), the device seconds of the operations launched
under ``repro_torch.<name>``, of the others launched in the stretch, and
of those whose launch call is not among the events.  A program without
that span gives nothing to read.
"""
from __future__ import annotations

from typing import Optional

from portbench import peaks, profiling, spans

#: the CUDA runtime's and driver's calls start with these; no PyTorch
#: operation or span does, so their ids (the launches' correlation ids)
#: are not mistaken for an operation's own
RUNTIME_PREFIX = "cu"


def _is_device_op(ev, cuda) -> bool:
    """A device operation, as ``profiling.Timeline`` counts them: not the
    device's copy of a host span."""
    return ev.device_type == cuda and not (
        getattr(ev, "is_user_annotation", False)
        or ev.name.startswith(profiling.SPAN_PREFIX)
        or ev.name.startswith(spans.PROGRAM_PREFIX))


def by_launch(events, name: str, lo: float, hi: float) -> Optional[dict]:
    """Device seconds of the operations whose launch call starts in
    ``[lo, hi)``: ``inside_s`` under the program span ``name``,
    ``outside_s`` the rest; ``unlinked_s`` of operations (anywhere) whose
    launch call is not among the events; with the count of the spans
    that start in the stretch.  ``None`` when none does."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    full = spans.PROGRAM_PREFIX + name
    launch, inside = {}, []
    for ev in events:
        if ev.device_type == cuda:
            continue
        a = float(ev.time_range.start)
        if ev.name.startswith(RUNTIME_PREFIX):
            launch[ev.id] = a
        elif ev.name == full and lo <= a < hi:
            inside.append((a, float(ev.time_range.end)))
    if not inside:
        return None
    out = {"inside_s": 0.0, "outside_s": 0.0, "unlinked_s": 0.0,
           "spans": len(inside)}
    for ev in events:
        if not _is_device_op(ev, cuda):
            continue
        dur = (float(ev.time_range.end) - float(ev.time_range.start)) / 1e6
        t = launch.get(ev.id)
        if t is None:
            out["unlinked_s"] += dur
        elif lo <= t < hi:
            key = "inside_s" if any(a <= t <= b for a, b in inside) \
                else "outside_s"
            out[key] += dur
    return out


def trace_launches(events, tl, name: str) -> dict:
    """What a traced record adds: ``launched`` (``by_launch`` over the
    chunks after the first), or nothing."""
    stretch = profiling.chunks_after_first(tl)
    if stretch is None:
        return {}
    got = by_launch(events, name, *stretch)
    return {"launched": got} if got is not None else {}


# ------------------------------------------------------------ readers
def _launched(rec):
    t = rec.get("trace") or {}
    got = t.get("launched")
    if not got or not t.get("iters") or got["inside_s"] <= 0:
        return None, None
    return t, got


def inside_ms_per_iter(rec):
    """Device milliseconds per iteration of the operations launched
    under the span, over the chunks after the first."""
    t, got = _launched(rec)
    return None if t is None else 1e3 * got["inside_s"] / t["iters"]


def inside_roofline(rec, work_key: str):
    """The least time of the span's work (``trace[work_key]``) over its
    device time per iteration, in percent."""
    t, got = _launched(rec)
    if t is None or not t.get(work_key):
        return None
    return peaks.roofline_percent(t[work_key], got["inside_s"] / t["iters"])
