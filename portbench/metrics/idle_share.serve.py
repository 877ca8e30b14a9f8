"""One minus the union of device activity over the wall of the profiled stretch of the service, in percent."""
from portbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "request_s.p95"


def read(rec):
    return readers.idle_share(rec)
