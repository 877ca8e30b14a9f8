"""Public wrappers for the small-matrix Jacobi factorizations.

Dispatch rule: CPU tensors take the plain versions (``ref.py``), and
so do ``meta`` tensors (shapes only); any other tensor launches the CUDA kernel or raises — there is no fallback,
and an r above ``kernel.MAX_R`` on the card raises rather than calling
``torch.linalg``.  ``use_kernel=False`` selects the plain version on the
card, for comparing the two; ``use_kernel=True`` on CPU tensors raises.
"""
from __future__ import annotations

from repro_torch.kernels import common
from repro_torch.kernels.jacobi.kernel import eigh_fwd, svd_fwd
from repro_torch.kernels.jacobi.ref import eigh_ref, svd_ref


def eigh(A, *, compute_v: bool = True, use_kernel=None):
    """(w, V) of symmetric (..., r, r) A, w ascending; w alone without
    ``compute_v`` (the ``eigvalsh`` form)."""
    if use_kernel is None:
        use_kernel = common.on_card(A)
    if not use_kernel:
        return eigh_ref(A, compute_v=compute_v)
    return eigh_fwd(A.contiguous(), compute_v=compute_v)


def svd(R, *, use_kernel=None):
    """(U, s, Vh) of square (..., r, r) R, s descending."""
    if use_kernel is None:
        use_kernel = common.on_card(R)
    if not use_kernel:
        return svd_ref(R)
    return svd_fwd(R.contiguous())
