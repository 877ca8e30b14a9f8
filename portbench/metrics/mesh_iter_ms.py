"""As train_iter_ms, for the training on four cards, read on rank 0."""
from portbench import readers

LAYER = "end to end"
UNIT = "ms"
MOVES = ""


def read(rec):
    return readers.window_ms_per_iter(rec)
