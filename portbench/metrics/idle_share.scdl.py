"""One minus the union of device activity over the wall of the profiled training, in percent."""
from portbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "train_iter_ms"


def read(rec):
    return readers.idle_share(rec)
