"""Small-matrix Jacobi eigensolver and SVD — the CUDA kernels' wrappers.

The kernels (``csrc/jacobi.cu``) replace no Pallas kernel: they compute
on the card what the JAX package's low-rank path leaves to XLA,
``jnp.linalg.eigh`` / ``eigvalsh`` of the range finder's (r, r) Gram and
the SVD of its (r, p) projection (``repro/imaging/lowrank.py``), because
``torch.linalg``'s versions wait for the device on the host.  One block
per matrix, the matrix in shared memory, one barrier a step,
r <= ``MAX_R``; fp32 in and out, the rotations in fp64; the sweeps stop
on the device.  Each launch leaves its sweep counts (an int32
device tensor, one per matrix) in ``<wrapper>.sweeps``, which only
checks read.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common

# the largest side of the kernels (kMaxR in csrc/jacobi.cuh): every warp
# computes all r / 2 rotations of a step, one a lane
MAX_R = 64


def _check(what: str, A: torch.Tensor) -> int:
    """The matrix side, after the checks: (..., r, r) fp32 with
    1 <= r <= MAX_R, then those every wrapper shares."""
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"{what}: expects square matrices (..., r, r), "
                         f"got {tuple(A.shape)}")
    r = A.shape[-1]
    if not 1 <= r <= MAX_R:
        raise ValueError(f"{what}: r = {r} is outside the kernel's 1 .. "
                         f"{MAX_R}; the card's path has no other route")
    if A.dtype != torch.float32:
        raise ValueError(f"{what}: expects float32, got {A.dtype}")
    common.require_cuda(what, A)
    return r


def eigh_fwd(A: torch.Tensor, *, compute_v: bool = True):
    """A: (..., r, r) fp32 CUDA tensor, contiguous, symmetric (it is
    symmetrized).  Returns (w, V), w ascending and the eigenvectors as
    columns, or w alone without ``compute_v``."""
    what = "jacobi.eigh"
    r = _check(what, A)
    batch = A.numel() // (r * r)
    w = torch.empty(A.shape[:-1], dtype=A.dtype, device=A.device)
    v = torch.empty_like(A) if compute_v else None
    sweeps = torch.empty(A.shape[:-2], dtype=torch.int32, device=A.device)
    err = common.library().repro_jacobi_eigh(
        A.data_ptr(), w.data_ptr(), None if v is None else v.data_ptr(),
        sweeps.data_ptr(), batch, r, int(compute_v), common.stream_ptr(A))
    common.check(err, what)
    eigh_fwd.launches += 1
    eigh_fwd.sweeps = sweeps
    return (w, v) if compute_v else w


def svd_fwd(R: torch.Tensor):
    """R: (..., r, r) fp32 CUDA tensor, contiguous.  Returns (U, s, Vh)
    with R = U diag(s) Vh and s descending."""
    what = "jacobi.svd"
    r = _check(what, R)
    batch = R.numel() // (r * r)
    u = torch.empty_like(R)
    vh = torch.empty_like(R)
    s = torch.empty(R.shape[:-1], dtype=R.dtype, device=R.device)
    sweeps = torch.empty(R.shape[:-2], dtype=torch.int32, device=R.device)
    err = common.library().repro_jacobi_svd(
        R.data_ptr(), u.data_ptr(), s.data_ptr(), vh.data_ptr(),
        sweeps.data_ptr(), batch, r, common.stream_ptr(R))
    common.check(err, what)
    svd_fwd.launches += 1
    svd_fwd.sweeps = sweeps
    return u, s, vh


eigh_fwd.launches = 0
eigh_fwd.sweeps = None
svd_fwd.launches = 0
svd_fwd.sweeps = None
