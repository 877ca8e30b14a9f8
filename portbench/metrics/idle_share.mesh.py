"""One minus the union of device activity over the wall of rank 0's profiled training, in percent."""
from portbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "mesh_iter_ms"


def read(rec):
    return readers.idle_share(rec)
