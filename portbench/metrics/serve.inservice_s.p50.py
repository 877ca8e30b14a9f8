"""The median of the service's own submit-to-done latencies of the requests completed in the window (serve.metrics.Metrics)."""
from portbench import readers

LAYER = "serve"
UNIT = "s"
MOVES = "request_s.p95"


def read(rec):
    return readers.inservice_p50(rec)
