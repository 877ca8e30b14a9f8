"""One iteration of the low-rank Condat deconvolution at its shapes, and
the randomized SVT inside it.

For n stamps of S x S (p = S^2 pixels), an FFT grid of G x G (the
reference's padded grid) and a range finder of r = rank + oversample
columns (the shapes' ``columns``):

- bytes of an iteration: the observed stamps Y and the PSFs read once,
  the carried primal X and dual U read once and written once, and the
  SVT's two reads of the (n, p) matrix it thresholds (its range, then
  its projection; the rebuild is written into U's write); the test
  matrix Omega once; 4 bytes each.  H(X) is derived from X.
- matrix products: the SVT's three n p r products (A Omega, Q^T A and
  the rank-r rebuild, 2 n p r operations each), and its thin ones: the
  Gram Y^T Y, Q = Y V and Q U_B (2 n r^2 each), the QR of the (p, r)
  B^T (4 p r^2, its factor and its orthogonal columns) and Q_B W
  (2 p r^2).
- other operations: the two convolutions of the gradient (four real 2D
  FFTs of G x G, 2.5 G^2 log2 G^2 each, and two complex products over
  the half spectrum, 6 each), the residual H(X) - Y, the primal step
  with X_bar (7 a pixel), the dual step around the SVT (5 a pixel:
  U + sig X_bar, its scaling, and U + sig X_bar - sig SVT), and the two
  small factorizations (9 r^3 for the Gram's eigenvectors, 22 r^3 for
  the SVD of R^T) and the scaling of Q U_B's columns (n r).

The objective, once a chunk, is not counted.
"""
from __future__ import annotations

import math

EIGH_OPS = 9             # Jacobi eigendecomposition of r x r, per r^3
SVD_OPS = 22             # Jacobi SVD of r x r, per r^3


def _shapes(shapes: dict):
    return (int(shapes["n"]), int(shapes["stamp"]) ** 2,
            int(shapes["grid"]), int(shapes["columns"]))


def svt(shapes: dict) -> dict:
    """The randomized SVT of the (n, p) matrix alone: the matrix read
    twice and the result written once, Omega read once; its products
    and its two small factorizations."""
    n, p, _, r = _shapes(shapes)
    nbytes = 4 * (3 * n * p + p * r)
    matmul = 6 * n * p * r + 6 * n * r * r + 6 * p * r * r
    flops = (EIGH_OPS + SVD_OPS) * r ** 3 + n * r
    return {"bytes": float(nbytes), "matmul_flops": float(matmul),
            "flops": float(flops)}


def per_iteration(shapes: dict) -> dict:
    n, p, G, r = _shapes(shapes)
    s = svt(shapes)
    nbytes = 4 * (n * p * (1             # Y
                           + 1           # PSF
                           + 2           # X read and written
                           + 2           # U read and written
                           + 2)          # the SVT's two reads
                  + p * r)               # Omega
    fft = 2.5 * G * G * math.log2(G * G)
    spectral = 6 * G * (G // 2 + 1)
    flops = n * (4 * fft + 2 * spectral + (1 + 7 + 5) * p) + s["flops"]
    return {"bytes": float(nbytes), "matmul_flops": s["matmul_flops"],
            "flops": float(flops)}
