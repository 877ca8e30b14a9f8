"""RunLog.times: the median over the chunks after the first of the window's catalogues, per iteration."""
from portbench import readers

LAYER = "driver"
UNIT = "ms"
MOVES = "stamps_per_s"


def read(rec):
    return readers.chunk_ms_per_iter(rec)
