"""The least time of one masked gradient step at the cell's shapes (work/lowrank_completion.grad over peaks.py) over grad_ms_per_iter.completion."""
from portbench import launches

LAYER = "per-iteration math and kernels"
UNIT = "%"
MOVES = "stamps_per_s"


def read(rec):
    t = rec.get("trace") or {}
    return launches.inside_roofline(
        {"trace": dict(t, launched=t.get("grad_launched"))}, "grad_work")
