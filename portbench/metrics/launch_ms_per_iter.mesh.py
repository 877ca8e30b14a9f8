"""repro_torch.driver.launch seconds (enqueuing a chunk) over the chunks after the first of rank 0's profiled training, per iteration."""
from portbench import spans

LAYER = "driver"
UNIT = "ms"
MOVES = "mesh_iter_ms"


def read(rec):
    return spans.launch_ms_per_iter(rec)
