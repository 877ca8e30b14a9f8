"""Fused Condat primal/dual elementwise passes — the CUDA kernels'
wrappers.

The kernels (``csrc/condat_elwise.cu``) replace the Pallas
``condat_primal_fwd`` and ``condat_dual_fwd``
(``repro/kernels/condat_elwise/kernel.py``): grid-stride passes that
read each operand once and write each output once.  The step sizes are
one-element fp32 device tensors read by the kernel through a pointer
(the TPU version put them in SMEM), so a solver loop never syncs to the
host for them.  No leading-axis padding: the passes are flat.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common


def condat_primal_fwd(X, U_adj, grad, tau, *, with_xbar: bool = False):
    """X/U_adj/grad: (N, S, S) CUDA tensors of one dtype (fp32 or
    bf16), contiguous; ``tau`` a one-element fp32 tensor on their device
    (or a Python number).  Returns X_new, or (X_new, X_bar)."""
    what = "condat_elwise.primal"
    common.require_cuda(what, X, U_adj, grad)
    if not (X.shape == U_adj.shape == grad.shape):
        raise ValueError(f"{what}: shapes differ: {tuple(X.shape)}, "
                         f"{tuple(U_adj.shape)}, {tuple(grad.shape)}")
    t = common.device_scalar(tau, X, what, "tau")
    xn = torch.empty_like(X)
    xb = torch.empty_like(X) if with_xbar else None
    err = common.library().repro_condat_primal(
        X.data_ptr(), U_adj.data_ptr(), grad.data_ptr(), t.data_ptr(),
        xn.data_ptr(), None if xb is None else xb.data_ptr(), X.numel(),
        common.DTYPE_CODES[X.dtype], int(with_xbar), common.stream_ptr(X))
    common.check(err, what)
    condat_primal_fwd.launches += 1
    # the two-output form (the low-rank path's) is also counted apart
    condat_primal_fwd.launches_xbar += int(with_xbar)
    return (xn, xb) if with_xbar else xn


def condat_dual_fwd(U, C_new, C_old, W, sig):
    """U/C_new/C_old: (M, S, S) CUDA tensors of one dtype (fp32 or
    bf16), contiguous; W: (M, 1, 1) of the same dtype, one weight per
    row; ``sig`` a one-element fp32 tensor on their device (or a Python
    number).  Returns U_new."""
    what = "condat_elwise.dual"
    common.require_cuda(what, U, C_new, C_old, W)
    if not (U.shape == C_new.shape == C_old.shape):
        raise ValueError(f"{what}: shapes differ: {tuple(U.shape)}, "
                         f"{tuple(C_new.shape)}, {tuple(C_old.shape)}")
    if U.dim() != 3 or tuple(W.shape) != (U.shape[0], 1, 1):
        raise ValueError(f"{what}: expects U (M, S, S) and W (M, 1, 1), "
                         f"got {tuple(U.shape)} and {tuple(W.shape)}")
    s = common.device_scalar(sig, U, what, "sig")
    out = torch.empty_like(U)
    err = common.library().repro_condat_dual(
        U.data_ptr(), C_new.data_ptr(), C_old.data_ptr(), W.data_ptr(),
        s.data_ptr(), out.data_ptr(), U.numel(), U.shape[1] * U.shape[2],
        common.DTYPE_CODES[U.dtype], common.stream_ptr(U))
    common.check(err, what)
    condat_dual_fwd.launches += 1
    return out


condat_primal_fwd.launches = 0
condat_primal_fwd.launches_xbar = 0
condat_dual_fwd.launches = 0
