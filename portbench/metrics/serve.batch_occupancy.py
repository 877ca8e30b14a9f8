"""The mean number of requests per dispatched bucket over the window (serve.metrics.Metrics batch sizes)."""
from portbench import readers

LAYER = "serve"
UNIT = "requests"
MOVES = "request_s.p95"


def read(rec):
    return readers.batch_occupancy(rec)
