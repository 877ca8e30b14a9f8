"""Plain reference of the port's low-rank space-variant PSF
deconvolution (the prior of arXiv:1809.05956, Eq. 3; Condat's
primal-dual splitting, after Farrens et al. 2017, with the SVT by a
range finder), written from the algorithm's definition in plain
PyTorch.

    min_X  0.5 ||Y - H(X)||_F^2 + lam ||X||_*   s.t.  X >= 0

over the (n, S^2) matrix whose rows are the stamps.

- ``H`` is the sparse reference's convolution (``deconv_sparse``): a
  'same' linear convolution of each stamp with its own PSF on the
  padded FFT grid, its adjoint the correlation.
- The regulariser's operator is the identity, so ``||L|| = 1``:
  ``sig = 0.5``, ``tau = 1 / (||H||^2 / 2 + sig)``, with ``||H||`` from
  the sparse reference's power iteration.
- One iteration: the primal step ``X_new = max(X - tau (H^T(H X - Y) +
  U), 0)`` and ``X_bar = 2 X_new - X``; the dual step ``U + sig X_bar -
  sig SVT((U + sig X_bar) / sig, lam / sig)`` (Moreau's identity for the
  prox of the nuclear norm's conjugate).
- The objective at every chunk's end: ``0.5 ||Y - H(X)||^2 + lam
  ||X||_*``, with the nuclear norm of the range finder below.

It departs from Farrens et al. where the port does, and both departures
are the configuration's ``reduced``: the SVT's full SVD of the (n, S^2)
matrix is replaced by the port's randomized range finder (Halko et al.
2011, Alg. 4.1, with no power iterations) on its test matrix Omega,
(S^2, rank + 8), a standard normal draw over sqrt(S^2) from a CPU
generator seeded 7:

    Yr = A Omega,  G = Yr^T Yr = V diag(l) V^T,
    Q = Yr V diag(l^-1/2)   (directions with l <= 1e-6 max(l) dropped),
    B = Q^T A = U_B diag(s) W^T,
    SVT(A, t) = (Q U_B) diag(max(s - t, 0)) W^T,

and the objective's nuclear norm is the port's range-finder estimate,
the sum of the square roots of the eigenvalues of (X Omega)^T (X Omega):
the nuclear norm of X Omega, not of X (with E[Omega Omega^T] = (r / p) I
it reads about sqrt(r / p) of it).  The range finder's SVT sets the
part of A outside its r directions to zero, so the dual step keeps that
part whole; on noisy catalogues the exact SVT keeps far more than r
directions, and the iterate lies far from Eq. 3's minimiser
(``solve(..., exact=True)`` reads how far).  So this reference checks
that the port computes its documented iteration, not that it solves
Eq. 3.

The range finder and the nuclear norm run in float64, their (r, r) and
(r, S^2) factorizations through ``torch.linalg``; the carried state is
float32, as the configuration states.  The PSF norm's start vectors are
the solver's default draw (``deconv_sparse.norm_H``).

``round_state`` makes the control: the carried state is rounded to that
dtype after every iteration (``torch.bfloat16`` for this float32
configuration).  Nothing here imports the port.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.deconv_sparse import (_cpu_normal, convolve,
                                               norm_H, psf_spectrum)

OVERSAMPLE = 8
EPS = 1e-6


def default_omega(p: int, rank: int) -> torch.Tensor:
    """Omega, (p, rank + OVERSAMPLE) float32 on the CPU."""
    return _cpu_normal(7, (p, rank + OVERSAMPLE)) / math.sqrt(p)


def _range(a: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Q, an orthonormal basis of the range of ``a @ omega`` (float64)."""
    yr = a @ omega
    lam, v = torch.linalg.eigh(yr.T @ yr)
    scale = torch.where(lam > EPS * lam.max(),
                        torch.rsqrt(torch.clamp(lam, min=1e-300)),
                        torch.zeros_like(lam))
    return yr @ (v * scale)


def svt(a: torch.Tensor, omega: torch.Tensor, thresh: float) -> torch.Tensor:
    """Singular-value thresholding of the (n, p) matrix through the range
    finder, in float64; returned in ``a``'s dtype."""
    a64, om = a.double(), omega.double()
    q = _range(a64, om)
    u, s, wt = torch.linalg.svd(q.T @ a64, full_matrices=False)
    s = torch.clamp(s - thresh, min=0.0)
    return (((q @ u) * s) @ wt).to(a.dtype)


def svt_exact(a: torch.Tensor, thresh: float) -> torch.Tensor:
    """Singular-value thresholding through the full SVD (Farrens et
    al.), in float64; returned in ``a``'s dtype."""
    u, s, vt = torch.linalg.svd(a.double(), full_matrices=False)
    return ((u * torch.clamp(s - thresh, min=0.0)) @ vt).to(a.dtype)


def nuclear_norm(x: torch.Tensor, omega: torch.Tensor) -> float:
    """The range finder's estimate of the nuclear norm of the (n, p)
    matrix: the nuclear norm of ``x @ omega``, float64."""
    yr = x.double() @ omega.double()
    s2 = torch.linalg.eigvalsh(yr.T @ yr)
    return float(torch.sum(torch.sqrt(torch.clamp(s2, min=0.0))))


def objective(Y, HX, X, lam: float, omega) -> float:
    data = 0.5 * torch.sum((Y.double() - HX.double()) ** 2)
    return float(data) + lam * nuclear_norm(X.reshape(X.shape[0], -1),
                                            omega)


def eq3_objective(Y, psfs, X, lam: float) -> float:
    """Eq. 3's own objective at ``X``: its nuclear norm from the
    singular values of the (n, S^2) matrix, float64 (a reading)."""
    HX = convolve(X.to(torch.float32), psf_spectrum(psfs.to(torch.float32)))
    data = 0.5 * torch.sum((Y.double() - HX.double()) ** 2)
    s = torch.linalg.svdvals(X.reshape(X.shape[0], -1).double())
    return float(data) + lam * float(s.sum())


def solve(Y: torch.Tensor, psfs: torch.Tensor, *, lam: float, rank: int,
          iterations: int, chunk: int, round_state=None,
          exact: bool = False):
    """Run the iteration from the back-projected start for
    ``iterations`` steps.  Returns ``(X, costs)``: the iterate and the
    objective at every chunk's end (and at the last iteration).
    ``exact`` takes Farrens et al.'s full SVD for the SVT in place of
    the range finder (a reading, not the reference that decides
    ``correct``; the objective stays the range finder's estimate).
    Products run in full float32 and float64: TF32 is off for the
    call, and restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _solve(Y, psfs, lam=lam, rank=rank, iterations=iterations,
                      chunk=chunk, round_state=round_state, exact=exact)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _solve(Y, psfs, *, lam, rank, iterations, chunk, round_state, exact):
    Y = Y.to(torch.float32)
    psfs = psfs.to(torch.float32)
    n = Y.shape[0]
    kf = psf_spectrum(psfs)
    nH = norm_H(kf, psfs.shape)
    sig = 0.5
    tau = 1.0 / (nH ** 2 / 2 + sig + 1e-12)
    omega = default_omega(Y.shape[-1] * Y.shape[-2], rank).to(Y.device)

    def keep(t):
        return t if round_state is None else t.to(round_state).to(
            torch.float32)

    X = keep(convolve(Y, kf, adjoint=True))
    HX = keep(convolve(X, kf))
    U = torch.zeros_like(X)
    costs = []
    for i in range(iterations):
        grad = convolve(HX - Y, kf, adjoint=True)
        X_new = torch.clamp(X - tau * grad - tau * U, min=0.0)
        X_bar = 2.0 * X_new - X
        V = U + sig * X_bar
        A = (V / sig).reshape(n, -1)
        S = svt_exact(A, lam / sig) if exact else svt(A, omega, lam / sig)
        U = keep(V - sig * S.reshape(V.shape))
        X = keep(X_new)
        HX = keep(convolve(X, kf))
        if (i + 1) % chunk == 0 or i == iterations - 1:
            costs.append(objective(Y, HX, X, lam, omega))
    return X, costs
