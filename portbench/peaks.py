"""The table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W) and the roofline share computed against it."""
from __future__ import annotations

#: bytes per second of HBM3
HBM_BYTES_PER_S = 3.35e12
#: matrix products: the dense TF32 rate, which no float32-accurate
#: product (3xTF32 included) can beat
MATMUL_FLOPS_PER_S = 495e12
#: every other operation: the float32 rate outside the tensor cores
FP32_FLOPS_PER_S = 67e12


def least_seconds(work: dict) -> float:
    """The least time a piece of work can take on the card: the largest
    of its bytes over the bandwidth, its matrix-product operations over
    the TF32 rate and its other operations over the float32 rate."""
    return max(work["bytes"] / HBM_BYTES_PER_S,
               work["matmul_flops"] / MATMUL_FLOPS_PER_S,
               work["flops"] / FP32_FLOPS_PER_S)


def roofline_percent(work: dict, device_seconds: float):
    """The share, in percent, of the least time in the measured device
    time; ``None`` when nothing was measured."""
    if not device_seconds or device_seconds <= 0:
        return None
    return 100.0 * least_seconds(work) / device_seconds
