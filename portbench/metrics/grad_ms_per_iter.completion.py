"""Device milliseconds per iteration of the operations launched under the span repro_torch.completion.grad (the masked gradient step), over the chunks after the first of the profiled matrix."""
from portbench import launches

LAYER = "per-iteration math and kernels"
UNIT = "ms"
MOVES = "stamps_per_s"


def read(rec):
    t = rec.get("trace") or {}
    return launches.inside_ms_per_iter(
        {"trace": dict(t, launched=t.get("grad_launched"))})
