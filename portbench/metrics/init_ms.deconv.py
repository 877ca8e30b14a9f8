"""The program's set-up span (repro_torch.solve.init: placement, operator norms, draws, initial state) in the profiled catalogue."""
from portbench import spans

LAYER = "entry and set-up"
UNIT = "ms"
MOVES = "stamps_per_s"


def read(rec):
    return spans.span_ms(rec, "solve.init")
