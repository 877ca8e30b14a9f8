"""The arithmetic of the metric readers, over the record a traffic
driver builds (``loop.py``, ``traffic/*.py``).  Each returns ``None``
when the record holds nothing to read."""
from __future__ import annotations

import statistics

from portbench import peaks


def _units(rec):
    return rec.get("units") or []


def work_per_s(rec):
    """Units of work (stamps) of the units that returned in the window,
    over the window up to the last of them."""
    units = _units(rec)
    if not units or rec.get("window_s", 0) <= 0:
        return None
    return sum(u["work"] for u in units) / rec["window_s"]


def window_ms_per_iter(rec):
    """The window up to the last unit's end over all the iterations of
    the units that returned in it."""
    iters = sum(u["iters"] for u in _units(rec))
    if not iters:
        return None
    return 1e3 * rec["window_s"] / iters


def fixed_ms(rec):
    """A unit's wall time outside its chunks, as a mean over the units."""
    units = _units(rec)
    if not units:
        return None
    return 1e3 * statistics.fmean(u["wall_s"] - u["chunk_s"] for u in units)


def chunk_ms_per_iter(rec):
    """The median over the chunks after the first of a chunk's seconds
    per iteration (``RunLog.times``)."""
    vals = [t for u in _units(rec) for t in u["iter_s"]]
    return 1e3 * statistics.median(vals) if vals else None


def _trace(rec):
    t = rec.get("trace")
    return t if t and t.get("iters") else None


def ops_per_iter(rec):
    t = _trace(rec)
    return t["ops"] / t["iters"] if t else None


def roofline(rec):
    t = _trace(rec)
    if not t or t["device_s"] <= 0:
        return None
    return peaks.roofline_percent(t["work"], t["device_s"] / t["iters"])


def idle_share(rec):
    t = rec.get("trace")
    if not t or t.get("window_s", 0) <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t["busy_s"] / t["window_s"])


def collective_ms_per_iter(rec):
    t = _trace(rec)
    return 1e3 * t["nccl_s"] / t["iters"] if t else None


def collectives_per_iter(rec):
    c = rec.get("collectives")
    return c["calls"] / c["iters"] if c and c.get("iters") else None


def percentile(values, q):
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def setup(rec):
    return rec.get("setup_s")


def request_p95(rec):
    lat = rec.get("latencies_s")
    return percentile(lat, 95) if lat else None


def batch_occupancy(rec):
    sizes = rec.get("batch_sizes")
    return statistics.fmean(sizes) if sizes else None


def inservice_p50(rec):
    lat = rec.get("inservice_s")
    return percentile(lat, 50) if lat else None
