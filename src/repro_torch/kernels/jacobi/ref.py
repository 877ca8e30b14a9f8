"""Plain PyTorch versions of the small factorizations that the Jacobi
kernels compute, in the kernels' output conventions:

  eigh:  A = V diag(w) V^T for symmetric A (..., r, r); the input is
         symmetrized, (A + A^T) / 2, as ``jnp.linalg.eigh`` does; ``w``
         ascending, eigenvectors as the columns of V.  Without vectors,
         ``w`` alone (``eigvalsh``).
  svd:   R = U diag(s) Vh for square R (..., r, r); ``s`` descending
         (``torch.linalg.svd(full_matrices=False)``).

On the card these ``torch.linalg`` calls check their result on the host
and so wait for the device: they serve the CPU, and comparisons on the
card, never the card's solver path."""
from __future__ import annotations

import torch


def eigh_ref(A, *, compute_v: bool = True):
    sym = 0.5 * (A + A.mT)
    if not compute_v:
        return torch.linalg.eigvalsh(sym)
    return torch.linalg.eigh(sym)


def svd_ref(R):
    return torch.linalg.svd(R, full_matrices=False)
