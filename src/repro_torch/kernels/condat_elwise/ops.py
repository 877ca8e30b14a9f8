"""Public wrappers for the fused Condat elementwise passes.

Dispatch rule: CPU tensors take the plain versions (``ref.py``), and
so do ``meta`` tensors (shapes only); any other tensor launches the CUDA kernel or raises — there is no fallback.
``use_kernel=False`` selects the plain version on the card, for
comparing the two; ``use_kernel=True`` on CPU tensors raises.

Both wrappers accept arbitrary leading batch shape: ``condat_dual``
flattens the (scale, record) leading axes of the dual stack into the
kernel's flat pass (the weight column broadcasts per leading index,
shaped (..., 1, 1) like ``condat.weight_matrix`` emits).

A step size per instance: ``tau``/``sig`` of shape (B,) go with operands
whose fourth axis from the end is the instance axis — the primal's
(B, n, S, S) stamps, the dual's scale-major (J, B, n, S, S) stack — and
one launch covers the bucket.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.condat_elwise.kernel import (condat_dual_fwd,
                                                      condat_primal_fwd)
from repro_torch.kernels.condat_elwise.ref import (condat_dual_ref,
                                                   condat_primal_ref)


def _count(v, like) -> int:
    """The number of step sizes, checked against the instance axis."""
    n = v.numel() if isinstance(v, torch.Tensor) else 1
    if n > 1 and (like.dim() < 4 or like.shape[-4] != n):
        raise ValueError(f"{n} step sizes for an operand of shape "
                         f"{tuple(like.shape)} (instance axis fourth from "
                         f"the end)")
    return n


def condat_primal(X, U_adj, grad, tau, *, with_xbar: bool = False,
                  use_kernel=None):
    if use_kernel is None:
        use_kernel = common.on_card(X)
    if not use_kernel:
        return condat_primal_ref(X, U_adj, grad, tau, with_xbar=with_xbar)
    _count(tau, X)
    flat = (-1,) + tuple(X.shape[-2:])
    out = condat_primal_fwd(X.reshape(flat), U_adj.reshape(flat),
                            grad.reshape(flat), tau, with_xbar=with_xbar)
    if with_xbar:
        return out[0].reshape(X.shape), out[1].reshape(X.shape)
    return out.reshape(X.shape)


def condat_dual(U, C_new, C_old, W, sig, *, use_kernel=None):
    if use_kernel is None:
        use_kernel = common.on_card(U)
    if not use_kernel:
        return condat_dual_ref(U, C_new, C_old, W, sig)
    lead = tuple(U.shape[:-2])
    flat = (-1,) + tuple(U.shape[-2:])
    # a no-copy view when W already carries every leading index, as the
    # solver's (J, n, 1, 1) weights do
    w = W.expand(lead + (1, 1)).reshape((-1, 1, 1))
    # a bucket's runs are its n rows, cycling through the instances
    run = U.shape[-3] if _count(sig, U) > 1 else None
    out = condat_dual_fwd(U.reshape(flat), C_new.reshape(flat),
                          C_old.reshape(flat), w, sig, run=run)
    return out.reshape(U.shape)
