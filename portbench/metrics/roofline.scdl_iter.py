"""The least time one iteration of the algorithm needs at the cell's shapes (work/scdl_sr.py over peaks.py) over the device time per iteration of the profiled chunks."""
from portbench import readers

LAYER = "per-iteration math and kernels"
UNIT = "%"
MOVES = "train_iter_ms"


def read(rec):
    return readers.roofline(rec)
