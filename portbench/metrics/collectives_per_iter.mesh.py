"""Collectives issued per iteration (core.compat.COLLECTIVES) over rank 0's trainings of the window."""
from portbench import readers

LAYER = "collectives"
UNIT = "calls"
MOVES = "mesh_iter_ms"


def read(rec):
    return readers.collectives_per_iter(rec)
