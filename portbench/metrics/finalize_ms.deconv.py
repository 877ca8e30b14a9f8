"""The program's repro_torch.solve.finalize span (the result's copy to the host) in the profiled catalogue."""
from portbench import spans

LAYER = "entry and set-up"
UNIT = "ms"
MOVES = "stamps_per_s"


def read(rec):
    return spans.span_ms(rec, "solve.finalize")
