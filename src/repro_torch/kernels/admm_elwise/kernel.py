"""Fused SCDL ADMM elementwise tail — the CUDA kernel's wrapper.

The kernel (``csrc/admm_elwise.cu``) replaces the Pallas
``admm_elwise_fwd`` (``repro/kernels/admm_elwise/kernel.py``): one
grid-stride pass that reads Wh, Wl and the three multiplier planes and
writes the five planes of the new state.  The ADMM constants are static
configuration, passed as plain ``float`` launch arguments (no device
scalar, no sync).  No padding of K: the pass is flat over K x A.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common


def admm_elwise_fwd(Wh, Wl, YZ, *, c1: float, c2: float, c3: float,
                    t1: float, t2: float):
    """Wh/Wl: (K, A) CUDA tensors; YZ: (5, K, A), plane-major; all one
    dtype (fp32 or bf16) and contiguous.  Returns the new (5, K, A)."""
    what = "admm_elwise"
    common.require_cuda(what, Wh, Wl, YZ)
    if Wh.dim() != 2 or Wh.shape != Wl.shape or \
            tuple(YZ.shape) != (5,) + tuple(Wh.shape):
        raise ValueError(f"{what}: expects Wh, Wl (K, A) and YZ (5, K, A), "
                         f"got {tuple(Wh.shape)}, {tuple(Wl.shape)}, "
                         f"{tuple(YZ.shape)}")
    out = torch.empty_like(YZ)
    err = common.library().repro_admm_elwise(
        Wh.data_ptr(), Wl.data_ptr(), YZ.data_ptr(), out.data_ptr(),
        Wh.numel(), float(c1), float(c2), float(c3), float(t1), float(t2),
        common.DTYPE_CODES[YZ.dtype], common.stream_ptr(YZ))
    common.check(err, what)
    admm_elwise_fwd.launches += 1
    return out


admm_elwise_fwd.launches = 0
