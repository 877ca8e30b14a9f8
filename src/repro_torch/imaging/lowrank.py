"""Nuclear-norm proximal operators for the low-rank deconvolution (Eq. 3)
and the low-rank matrix completion workload, on one device.  Port of
``repro.imaging.lowrank``.

Sequential reference: :func:`svt`, the exact SVT of the (n_images, S*S)
pixel matrix through ``torch.linalg.svd``.  On the card that call
checks its result on the host, so it waits for the device once a call.

Main path: :func:`randomized_svt_local`, the randomized range-finder SVT
of the JAX module, step for step:

    Y = A Omega                        (n, r)
    Q = Y V_G diag(lambda_G^-1/2)      (eigh of the Gram Y^T Y, r x r;
                                        directions under 1e-6 lambda_max
                                        clipped)
    B = Q^T A                          (r, p)
    A_svt = (Q U) max(S - t, 0) V^T    (U S V^T = svd(B))

with the two small factorizations on the card in the hand-written
Jacobi kernels (``kernels/jacobi``): ``jacobi.eigh`` for the Gram, and
for B a reduction first, B^T = Q_B R (``torch.linalg.qr``, reduced:
p x r and r x r), so B = R^T Q_B^T, then ``jacobi.svd`` of R^T = U S W^T
and V = Q_B W.  The CPU runs the same algebra, with the factorizations'
plain versions (``torch.linalg``) in place of the kernels.  Nothing on
the card's path waits for the device.

Both take a bucket of instances too (``solve_many``): (B, n, p) matrices
with one shared Omega and a threshold per instance (B,) run as batched
products, one batched ``torch.linalg.qr`` and one launch of each Jacobi
kernel over the (B, r, r) matrices.  The two products that sum over the
n records (the Gram Y^T Y and B = Q^T A) run as one 2-D product per
matrix (:func:`_over_records`): cuBLAS sums a long 2-D product more
accurately than its batched kernels do (split-K for the Gram), and the
range finder's lambda^-1/2 magnifies the difference; a batched bucket of
completions drifted several times farther from the fp64 trajectory than
its single solves (``tools/record_sums.py``, ``PERF.md``, PR 17).

``axes`` are the mesh axes the rows are split over (``core.compat``):
the Gram Y^T Y (r x r) and B = Q^T A (r x p) are summed over them
(``compat.psum``), so every rank factors the same matrices in the same
deterministic kernels and holds the same factors, while Q and the
thresholded rows stay the rank's own.

Random draws are a seam: the JAX module draws the test matrix Omega from
``PRNGKey(7)``, which torch cannot reproduce.  Here Omega is an argument
(``omega=``); without it :func:`make_test_matrix` draws it from a CPU
``torch.Generator`` seeded 7, the same on every device.

The workload :class:`LowRankCompletionProblem` (registered
``"lowrank"``) completes a matrix by proximal gradient with this SVT.
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batching import BatchAxes
from repro_torch.core.bundle import Bundle, gather_leaf
from repro_torch.core.compat import psum
from repro_torch.core.problem import Problem, register
from repro_torch.core.spans import span
from repro_torch.kernels.common import to_device
from repro_torch.kernels.jacobi import ops as jacobi_ops


def svt(mat: torch.Tensor, thresh) -> torch.Tensor:
    """Exact singular-value thresholding (sequential reference)."""
    u, s, vt = torch.linalg.svd(mat, full_matrices=False)
    s = torch.clamp(s - thresh, min=0.0)
    return (u * s[None, :]) @ vt


def _over_records(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x^T z, the sum over the record axis (the second last): one 2-D
    product per matrix of a batch, so each is summed as a single
    instance's is (module docstring)."""
    if x.dim() == 2:
        return x.T @ z
    return torch.stack([xi.T @ zi for xi, zi in zip(x, z)])


def randomized_svt_local(a_local: torch.Tensor, omega: torch.Tensor,
                         thresh, axes=None, eps: float = 1e-6, *,
                         use_kernel=None) -> torch.Tensor:
    """SVT of the (n, p) matrix, or of each of a (B, n, p) batch, through
    the range finder (module docstring).  ``omega``: (p, r) test matrix;
    ``thresh`` a number, a 0-d tensor on the device or one per matrix
    (B,).  ``axes``: the mesh axes the rows are split over (the two
    products over the rows are summed over them).  ``use_kernel=False``
    takes the factorizations' plain versions on the card, for
    comparison."""
    with span("lowrank.svt"):
        if isinstance(thresh, torch.Tensor) and thresh.dim():
            thresh = thresh.unsqueeze(-1)
        y = a_local @ omega                              # (n, r)
        gram = psum(_over_records(y, y), axes)           # (r, r)
        # orthogonalise through the Gram eigendecomposition (rank-deficient
        # safe: null directions are clipped)
        evals, evecs = jacobi_ops.eigh(gram, use_kernel=use_kernel)
        scale = torch.where(evals > eps * evals.amax(dim=-1, keepdim=True),
                            torch.rsqrt(torch.clamp(evals, min=1e-30)),
                            torch.zeros_like(evals))
        q = y @ (evecs * scale.unsqueeze(-2))            # (n, r) orthonormal
        b = psum(_over_records(q, a_local), axes)        # (r, p)
        # svd(B) through B^T = Q_B R: B = R^T Q_B^T, R^T = U S W^T
        q_b, r_b = torch.linalg.qr(b.mT)                 # (p, r), (r, r)
        u, s, wt = jacobi_ops.svd(r_b.mT, use_kernel=use_kernel)
        s = torch.clamp(s - thresh, min=0.0)
        return ((q @ u) * s.unsqueeze(-2)) @ (q_b @ wt.mT).mT   # (n, p)


# the range finder's columns beyond the target rank, where a caller names
# none (the deconvolution's low-rank mode)
OVERSAMPLE = 8


def make_test_matrix(p: int, rank: int, oversample: int = OVERSAMPLE, *,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
    """A (p, rank + oversample) Gaussian test matrix over sqrt(p), drawn
    on the CPU from ``generator`` (seed 7 when none is given) and then
    moved to ``device``."""
    g = generator if generator is not None \
        else torch.Generator().manual_seed(7)
    om = torch.randn((p, rank + oversample), generator=g) / math.sqrt(p)
    return om.to(device) if device is not None else om


def resolve_omega(omega, p: int, rank: int, oversample: int,
                  device) -> torch.Tensor:
    """The injected ``omega`` (numpy or tensor), checked against its
    (p, rank + oversample) shape, or a fresh draw, as fp32 on
    ``device``."""
    if omega is None:
        return make_test_matrix(p, rank, oversample, device=device)
    om = to_device(omega, device, torch.float32)
    if tuple(om.shape) != (p, rank + oversample):
        raise ValueError(f"omega must be ({p}, {rank + oversample}), got "
                         f"{tuple(om.shape)}")
    return om


# ---------------------------------------------------------------------
# Workload: low-rank matrix completion
# ---------------------------------------------------------------------

@dataclass(frozen=True)
class CompletionConfig:
    """min_X 0.5||M o (X - Y)||_F^2 + lam ||X||_* by proximal gradient:
    X <- SVT(X - step * M o (X - Y), lam * step), the SVT through the
    randomized range finder."""
    rank: int = 16                 # range-finder target rank
    lam: float = 0.1               # nuclear-norm weight
    step: float = 1.0              # <= 1/L; L = 1 for the masked id.
    oversample: int = 8
    max_iter: int = 200
    tol: float = 1e-4


def _masked_residual(d):
    return d["M"] * (d["X"] - d["Y"])


def nuclear_norm_rf(X_loc, omega, axes):
    """Range-finder nuclear norm: the sum of the square roots of the
    eigenvalues of the projection's (r, r) Gram (``jacobi.eigh``
    without vectors), which is the nuclear norm of X Omega: an estimate
    of ||X||_* scaled by Omega (E[Omega Omega^T] = (r / p) I, so about
    sqrt(r / p) of it), as the JAX module computes it.  Shared by the
    low-rank deconvolution objective and the completion workload.  The
    Gram is summed over ``axes``."""
    with span("lowrank.nuclear"):
        y = X_loc @ omega
        s2 = jacobi_ops.eigh(psum(_over_records(y, y), axes),
                             compute_v=False)
        return torch.sum(torch.sqrt(torch.clamp(s2, min=0.0)), dim=-1)


@register("lowrank")
class LowRankCompletionProblem(Problem):
    """Low-rank completion of an (n, p) matrix, declared once.

    Inputs: ``(Y, M)`` — observations (n, p) and a {0,1} mask of the
    same shape.  The broadcast side carries only the constant test matrix
    Omega, so there is no ``refresh_replicated``; the declared
    ``light_step`` + ``cost`` unlock every objective cadence (integer
    ``cost_every`` and ``"chunk"``).  ``omega`` injects Omega, (p, rank +
    oversample); left ``None`` it is drawn (see the module docstring).
    """

    batched_steps = True

    def __init__(self, cfg: Optional[CompletionConfig] = None, *,
                 omega=None):
        self.cfg = cfg if cfg is not None else CompletionConfig()
        self.omega = omega

    def init_bundle(self, inputs, device, mesh=None) -> Bundle:
        Y, M = inputs
        Y = to_device(Y, device, torch.float32)
        M = to_device(M, device, torch.float32)
        data = {"Y": Y * M, "M": M, "X": Y * M}
        # the default test matrix is a host draw and its copy
        with span("completion.draws") if self.omega is None \
                else nullcontext():
            omega = resolve_omega(self.omega, Y.shape[1], self.cfg.rank,
                                  self.cfg.oversample, device)
        return Bundle.create(data, device=device,
                             replicated={"omega": omega}, mesh=mesh)

    def _iterate(self, d, rep, axes):
        cfg = self.cfg
        with span("completion.grad"):
            X_half = d["X"] - cfg.step * _masked_residual(d)
        X_new = randomized_svt_local(X_half, rep["omega"],
                                     cfg.lam * cfg.step, axes=axes)
        return dict(d, X=X_new)

    def full_step(self, d, rep, axes):
        d_new = self._iterate(d, rep, axes)
        return d_new, self.cost(d_new, rep, axes)

    def light_step(self, d, rep, axes):
        return self._iterate(d, rep, axes)

    def cost(self, d, rep, axes):
        data_part = psum(0.5 * torch.sum(_masked_residual(d) ** 2,
                                         dim=(-2, -1)), axes)
        nuc = nuclear_norm_rf(d["X"], rep["omega"], axes)
        return {"cost": data_part + self.cfg.lam * nuc}

    def finalize(self, bundle, log) -> Tuple[np.ndarray, dict]:
        return gather_leaf(bundle, "X"), {}

    def batch_axes(self):
        # (Y, M) are row-major; Omega depends only on the config (or the
        # injected draw, constructor state shared by declaration), so one
        # copy serves a bucket
        return BatchAxes(record_axes=(0, 0), shared_in_batch=("omega",),
                         instance_invariant=("omega",))
