"""A training's wall time outside its chunks, as a mean over the trainings of the window."""
from portbench import readers

LAYER = "entry and set-up"
UNIT = "ms"
MOVES = "train_iter_ms"


def read(rec):
    return readers.fixed_ms(rec)
