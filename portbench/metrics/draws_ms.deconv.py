"""The summed repro_torch.deconvolve.draws spans of the profiled catalogue: the default start vectors and noise drawn on the host and copied to the card."""
from portbench import spans

LAYER = "entry and set-up"
UNIT = "ms"
MOVES = "stamps_per_s"


def read(rec):
    return spans.span_ms(rec, "deconvolve.draws")
