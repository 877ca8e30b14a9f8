"""The least time one iteration of the algorithm needs at the cell's shapes (work/galaxy_deconv.py over peaks.py) over the device time per iteration of the profiled chunks."""
from portbench import readers

LAYER = "per-iteration math and kernels"
UNIT = "%"
MOVES = "stamps_per_s"


def read(rec):
    return readers.roofline(rec)
