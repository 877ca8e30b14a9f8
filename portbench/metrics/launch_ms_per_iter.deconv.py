"""repro_torch.driver.launch seconds (enqueuing a chunk) over the chunks after the first of the profiled catalogue, per iteration."""
from portbench import spans

LAYER = "driver"
UNIT = "ms"
MOVES = "stamps_per_s"


def read(rec):
    return spans.launch_ms_per_iter(rec)
