"""The 95th percentile of the client-side latency of every request completed in the window, from just before its submit until its result with x was decoded."""
from portbench import readers

LAYER = "end to end"
UNIT = "s"
MOVES = ""


def read(rec):
    return readers.request_p95(rec)
