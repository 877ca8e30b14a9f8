"""Device operations per iteration over the chunks after the first of the profiled catalogue."""
from portbench import readers

LAYER = "engine"
UNIT = "ops"
MOVES = "stamps_per_s"


def read(rec):
    return readers.ops_per_iter(rec)
