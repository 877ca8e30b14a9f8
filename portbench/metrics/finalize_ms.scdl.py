"""The program's repro_torch.solve.finalize span (the dictionaries' copy to the host) in the profiled training."""
from portbench import spans

LAYER = "entry and set-up"
UNIT = "ms"
MOVES = "train_iter_ms"


def read(rec):
    return spans.span_ms(rec, "solve.finalize")
