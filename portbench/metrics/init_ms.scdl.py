"""The program's set-up span (repro_torch.solve.init) in the profiled training."""
from portbench import spans

LAYER = "entry and set-up"
UNIT = "ms"
MOVES = "train_iter_ms"


def read(rec):
    return spans.span_ms(rec, "solve.init")
