"""The least time of one randomized SVT at the cell's shapes (work/galaxy_deconv_lowrank.svt over peaks.py) over svt_ms_per_iter.lowrank."""
from portbench import launches

LAYER = "low-rank prox"
UNIT = "%"
MOVES = "stamps_per_s"


def read(rec):
    return launches.inside_roofline(rec, "svt_work")
