"""Public wrappers for the fused Condat elementwise passes.

Dispatch rule: CPU tensors take the plain versions (``ref.py``); any
other tensor launches the CUDA kernel or raises — there is no fallback.
``use_kernel=False`` selects the plain version on the card, for
comparing the two; ``use_kernel=True`` on CPU tensors raises.

Both wrappers accept arbitrary leading batch shape: ``condat_dual``
flattens the (scale, record) leading axes of the dual stack into the
kernel's flat pass (the weight column broadcasts per leading index,
shaped (..., 1, 1) like ``condat.weight_matrix`` emits).
"""
from __future__ import annotations

from repro_torch.kernels.condat_elwise.kernel import (condat_dual_fwd,
                                                      condat_primal_fwd)
from repro_torch.kernels.condat_elwise.ref import (condat_dual_ref,
                                                   condat_primal_ref)


def condat_primal(X, U_adj, grad, tau, *, with_xbar: bool = False,
                  use_kernel=None):
    if use_kernel is None:
        use_kernel = X.device.type != "cpu"
    if not use_kernel:
        return condat_primal_ref(X, U_adj, grad, tau, with_xbar=with_xbar)
    flat = (-1,) + tuple(X.shape[-2:])
    out = condat_primal_fwd(X.reshape(flat), U_adj.reshape(flat),
                            grad.reshape(flat), tau, with_xbar=with_xbar)
    if with_xbar:
        return out[0].reshape(X.shape), out[1].reshape(X.shape)
    return out.reshape(X.shape)


def condat_dual(U, C_new, C_old, W, sig, *, use_kernel=None):
    if use_kernel is None:
        use_kernel = U.device.type != "cpu"
    if not use_kernel:
        return condat_dual_ref(U, C_new, C_old, W, sig)
    lead = tuple(U.shape[:-2])
    flat = (-1,) + tuple(U.shape[-2:])
    # a no-copy view when W already carries every leading index, as the
    # solver's (J, n, 1, 1) weights do
    w = W.expand(lead + (1, 1)).reshape((-1, 1, 1))
    out = condat_dual_fwd(U.reshape(flat), C_new.reshape(flat),
                          C_old.reshape(flat), w, sig)
    return out.reshape(U.shape)
