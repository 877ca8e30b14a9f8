"""The summed repro_torch.deconvolve.norms spans of the profiled catalogue: the operator norms' power iterations, up to their host floats."""
from portbench import spans

LAYER = "entry and set-up"
UNIT = "ms"
MOVES = "stamps_per_s"


def read(rec):
    return spans.span_ms(rec, "deconvolve.norms")
