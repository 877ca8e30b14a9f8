"""RunLog.times: the median over the chunks after the first of the window's trainings, per iteration."""
from portbench import readers

LAYER = "driver"
UNIT = "ms"
MOVES = "train_iter_ms"


def read(rec):
    return readers.chunk_ms_per_iter(rec)
