"""Fused Condat primal/dual elementwise passes — the CUDA kernels'
wrappers.

The kernels (``csrc/condat_elwise.cu``) replace the Pallas
``condat_primal_fwd`` and ``condat_dual_fwd``
(``repro/kernels/condat_elwise/kernel.py``): grid-stride passes that
read each operand once and write each output once.  The step sizes are
fp32 device tensors read by the kernel through a pointer (the TPU
version put them in SMEM), so a solver loop never syncs to the host for
them: one entry for one instance, one per instance for a bucket of
``solve_many``, where one launch covers the whole bucket.  No
leading-axis padding: the passes are flat.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common


def _step_sizes(value, like, what: str, name: str) -> torch.Tensor:
    """``tau``/``sig`` as a flat fp32 device tensor of ``count`` entries
    (a Python number or a 0-d tensor is one instance's)."""
    if isinstance(value, torch.Tensor) and value.dim() > 0:
        if value.dim() != 1 or value.dtype != torch.float32 \
                or value.device != like.device \
                or not value.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a 0-d or (count,) contiguous "
                f"float32 tensor on {like.device}, got "
                f"{tuple(value.shape)} {value.dtype} on {value.device}")
        return value
    return common.device_scalar(value, like, what, name)


def condat_primal_fwd(X, U_adj, grad, tau, *, with_xbar: bool = False):
    """X/U_adj/grad: (N, S, S) CUDA tensors of one dtype (fp32 or bf16),
    contiguous; ``tau`` a fp32 tensor on their device of ``count``
    entries, one per instance, instance b owning the b-th of ``count``
    equal runs of the N stamps (or a Python number).  Returns X_new, or
    (X_new, X_bar)."""
    what = "condat_elwise.primal"
    common.require_cuda(what, X, U_adj, grad)
    if not (X.shape == U_adj.shape == grad.shape):
        raise ValueError(f"{what}: shapes differ: {tuple(X.shape)}, "
                         f"{tuple(U_adj.shape)}, {tuple(grad.shape)}")
    t = _step_sizes(tau, X, what, "tau")
    count = t.numel()
    if X.numel() % count:
        raise ValueError(f"{what}: {count} step sizes for {X.numel()} "
                         f"elements (one equal run an instance)")
    xn = torch.empty_like(X)
    xb = torch.empty_like(X) if with_xbar else None
    err = common.library().repro_condat_primal(
        X.data_ptr(), U_adj.data_ptr(), grad.data_ptr(), t.data_ptr(),
        xn.data_ptr(), None if xb is None else xb.data_ptr(), X.numel(),
        count, common.DTYPE_CODES[X.dtype], int(with_xbar),
        common.stream_ptr(X))
    common.check(err, what)
    condat_primal_fwd.launches += 1
    # the two-output form (the low-rank path's) and the per-instance form
    # (a bucket's) are also counted apart
    condat_primal_fwd.launches_xbar += int(with_xbar)
    condat_primal_fwd.launches_batched += int(count > 1)
    return (xn, xb) if with_xbar else xn


def condat_dual_fwd(U, C_new, C_old, W, sig, *, run=None):
    """U/C_new/C_old: (M, S, S) CUDA tensors of one dtype (fp32 or
    bf16), contiguous; W: (M, 1, 1) of the same dtype, one weight per
    row; ``sig`` a fp32 tensor on their device of ``count`` entries (or a
    Python number).  The rows form runs of ``run`` rows (all M by
    default), the r-th run belonging to instance r % count: the layout
    of a bucket's scale-major (J, count, run, S, S) stack.  Returns
    U_new."""
    what = "condat_elwise.dual"
    common.require_cuda(what, U, C_new, C_old, W)
    if not (U.shape == C_new.shape == C_old.shape):
        raise ValueError(f"{what}: shapes differ: {tuple(U.shape)}, "
                         f"{tuple(C_new.shape)}, {tuple(C_old.shape)}")
    if U.dim() != 3 or tuple(W.shape) != (U.shape[0], 1, 1):
        raise ValueError(f"{what}: expects U (M, S, S) and W (M, 1, 1), "
                         f"got {tuple(U.shape)} and {tuple(W.shape)}")
    s = _step_sizes(sig, U, what, "sig")
    count = s.numel()
    ss = U.shape[1] * U.shape[2]
    run = U.shape[0] if run is None else int(run)
    if run <= 0 or U.shape[0] % (run * count):
        raise ValueError(f"{what}: {count} step sizes for {U.shape[0]} rows "
                         f"in runs of {run} (whole cycles of the "
                         f"instances)")
    out = torch.empty_like(U)
    err = common.library().repro_condat_dual(
        U.data_ptr(), C_new.data_ptr(), C_old.data_ptr(), W.data_ptr(),
        s.data_ptr(), out.data_ptr(), U.numel(), ss, run, count,
        common.DTYPE_CODES[U.dtype], common.stream_ptr(U))
    common.check(err, what)
    condat_dual_fwd.launches += 1
    condat_dual_fwd.launches_batched += int(count > 1)
    return out


condat_primal_fwd.launches = 0
condat_primal_fwd.launches_xbar = 0
condat_primal_fwd.launches_batched = 0
condat_dual_fwd.launches = 0
condat_dual_fwd.launches_batched = 0
