"""The numbers compared with the reference.  Each is a gap: 0 when the
program agrees with the reference exactly, and every one is judged
against its cell's limit (``workloads/<cell>.json``, ``limits``)."""
from __future__ import annotations

import math

import numpy as np


def _arr(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def stamp_gap(x, ref) -> float:
    """The widest gap of any stamp, as a share of that stamp's largest
    reference value: max over stamps of max|x - ref| / max|ref|."""
    x, ref = _arr(x), _arr(ref)
    if x.shape != ref.shape:
        return math.inf
    n = ref.shape[0]
    d = np.abs(x - ref).reshape(n, -1).max(axis=1)
    s = np.abs(ref).reshape(n, -1).max(axis=1)
    gap = d / np.maximum(s, 1e-30)
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else math.inf


def cost_gap(costs, ref_costs) -> float:
    """The widest relative gap of the objective over the evaluated
    iterations."""
    c, r = _arr(costs), _arr(ref_costs)
    if c.shape != r.shape or c.size == 0:
        return math.inf
    gap = np.abs(c - r) / np.maximum(np.abs(r), 1e-30)
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else math.inf


def matrix_gap(x, ref) -> float:
    """The widest gap of any entry, as a share of the reference's
    largest column norm (a dictionary's columns have norm at most 1)."""
    x, ref = _arr(x), _arr(ref)
    if x.shape != ref.shape:
        return math.inf
    scale = max(float(np.linalg.norm(ref, axis=0).max()), 1e-30)
    gap = float(np.abs(x - ref).max()) / scale
    return gap if math.isfinite(gap) else math.inf


def chunk_costs(costs, chunk: int):
    """The costs a ``cost_every="chunk"`` run evaluated: each chunk's
    last and the run's last, from ``RunLog.costs`` (one per iteration)."""
    n = len(costs)
    return [costs[i] for i in range(n) if (i + 1) % chunk == 0 or i == n - 1]
