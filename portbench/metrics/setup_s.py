"""Seconds from process start to the start of the measured window: loading, building or loading kernels, making the inputs, warming up."""
from portbench import readers

LAYER = "end to end"
UNIT = "s"
MOVES = ""


def read(rec):
    return readers.setup(rec)
