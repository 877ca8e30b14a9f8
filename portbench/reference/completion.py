"""Plain reference of the port's low-rank matrix completion, written from
the algorithm's definition in plain PyTorch.

    min_X  0.5 ||M o (X - Y)||_F^2 + lam ||X||_*

over an (n, p) matrix Y observed where the {0, 1} mask M is one (the
synthetic protocol of Cai, Candes & Shen 2010, Sec. 5.1), by proximal
gradient with a fixed step (the fixed-point iteration of FPCA, Ma,
Goldfarb & Chen 2011, without its continuation on lam; Soft-Impute at
step 1):

- the start is the observed entries, X_0 = M o Y;
- one iteration: ``X <- SVT(X - step M o (X - Y), lam step)``;
- the objective at every chunk's end: ``0.5 ||M o (X - Y)||^2 + lam
  ||X||_*``, with the range finder's nuclear norm below.

It departs from the source where the port does, and both departures are
the configuration's ``reduced``, as in ``deconv_lowrank``: the SVT's
full SVD is replaced by the port's randomized range finder (Halko et
al. 2011, Alg. 4.1, no power iterations) on its test matrix Omega,
(p, rank + oversample), a standard normal draw over sqrt(p) from a CPU
generator seeded 7, and the objective's nuclear norm is that of X Omega
(``deconv_lowrank.svt`` and ``.nuclear_norm``).

Everything runs in float64, state included: the iterate, the masked
step, the range finder and its factorizations through ``torch.linalg``.
``round_state`` makes the control: the iterate is rounded to that dtype
after every iteration (``torch.bfloat16`` for this float32
configuration).  ``exact`` takes the full SVD for the SVT (a reading, not
the reference that decides ``correct``).  Products run with TF32 off
(``reference.float32_products``).  Nothing here imports the port.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import float32_products
from portbench.reference.deconv_lowrank import nuclear_norm, svt, svt_exact
from portbench.reference.deconv_sparse import _cpu_normal


def default_omega(p: int, columns: int) -> torch.Tensor:
    """Omega, (p, columns) float32 on the CPU: the solver's default
    draw."""
    return _cpu_normal(7, (p, columns)) / math.sqrt(p)


def objective(X, Y, M, lam: float, omega) -> float:
    data = 0.5 * torch.sum((M * (X - Y)) ** 2)
    return float(data) + lam * nuclear_norm(X, omega)


def solve(A: torch.Tensor, M: torch.Tensor, *, lam: float, step: float,
          rank: int, oversample: int, iterations: int, chunk: int,
          round_state=None, exact: bool = False):
    """Run the iteration on the matrix ``A`` observed where ``M`` is one
    (only ``M o A`` is read).  Returns ``(X, costs)``: the float64
    iterate and the objective at every chunk's end (and at the last
    iteration)."""
    with float32_products():
        M = M.double()
        Y = A.double() * M
        omega = default_omega(Y.shape[1], rank + oversample).to(
            Y.device).double()

        def keep(t):
            return t if round_state is None else t.to(round_state).double()

        X = keep(Y.clone())
        costs = []
        for i in range(iterations):
            half = X - step * (M * (X - Y))
            X = keep(svt_exact(half, lam * step) if exact
                     else svt(half, omega, lam * step))
            if (i + 1) % chunk == 0 or i == iterations - 1:
                costs.append(objective(X, Y, M, lam, omega))
        return X, costs
