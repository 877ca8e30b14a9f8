"""The window up to the last training's end over all the iterations of the trainings that completed in it, each from raw patches."""
from portbench import readers

LAYER = "end to end"
UNIT = "ms"
MOVES = ""


def read(rec):
    return readers.window_ms_per_iter(rec)
