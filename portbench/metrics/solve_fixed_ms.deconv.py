"""A catalogue's wall time outside its chunks (everything but RunLog.times), as a mean over the catalogues of the window."""
from portbench import readers

LAYER = "entry and set-up"
UNIT = "ms"
MOVES = "stamps_per_s"


def read(rec):
    return readers.fixed_ms(rec)
