"""Device time of the NCCL operations per iteration over the chunks after the first of rank 0's profiled training."""
from portbench import readers

LAYER = "collectives"
UNIT = "ms"
MOVES = "mesh_iter_ms"


def read(rec):
    return readers.collective_ms_per_iter(rec)
