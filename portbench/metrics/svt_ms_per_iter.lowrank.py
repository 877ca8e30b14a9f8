"""Device milliseconds per iteration of the operations launched under the span repro_torch.lowrank.svt, over the chunks after the first of the profiled catalogue."""
from portbench import launches

LAYER = "low-rank prox"
UNIT = "ms"
MOVES = "stamps_per_s"


def read(rec):
    return launches.inside_ms_per_iter(rec)
