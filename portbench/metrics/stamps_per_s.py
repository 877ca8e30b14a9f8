"""Stamps of the catalogues whose solve returned in the window, over the window up to the last of them."""
from portbench import readers

LAYER = "end to end"
UNIT = "stamps/s"
MOVES = ""


def read(rec):
    return readers.work_per_s(rec)
