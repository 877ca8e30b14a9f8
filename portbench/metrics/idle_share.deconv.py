"""One minus the union of device activity over the wall of the profiled catalogue, in percent."""
from portbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "stamps_per_s"


def read(rec):
    return readers.idle_share(rec)
