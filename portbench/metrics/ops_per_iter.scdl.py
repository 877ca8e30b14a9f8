"""Device operations per iteration over the chunks after the first of the profiled training."""
from portbench import readers

LAYER = "engine"
UNIT = "ops"
MOVES = "train_iter_ms"


def read(rec):
    return readers.ops_per_iter(rec)
