"""One iteration of the low-rank matrix completion at its shapes, and the
masked gradient step and the randomized SVT inside it.

For an (n, p) matrix and a range finder of r = rank + oversample
columns (the shapes' ``columns``):

- the masked gradient step ``X - step M o (X - Y)``: X, Y and M read
  once and the step's result written once, 4 bytes each; four
  operations an entry (the difference, the mask, the step, the
  subtraction), no products;
- the randomized SVT of that result, as in ``galaxy_deconv_lowrank``:
  the matrix read twice (its range, then its projection) and the result
  written once, Omega read once; its three n p r products (A Omega,
  Q^T A and the rank-r rebuild, 2 n p r operations each) and its thin
  ones (the Gram Y^T Y, Q = Y V and Q U_B, 2 n r^2 each; the QR of the
  (p, r) B^T, 4 p r^2, and Q_B W, 2 p r^2); the two small
  factorizations (9 r^3 for the Gram's eigenvectors, 22 r^3 for the SVD
  of R^T) and the scaling of Q U_B's columns (n r).

The objective, once a chunk, is not counted.
"""
from __future__ import annotations

EIGH_OPS = 9             # Jacobi eigendecomposition of r x r, per r^3
SVD_OPS = 22             # Jacobi SVD of r x r, per r^3
GRAD_OPS = 4             # the masked step, per entry


def _shapes(shapes: dict):
    return int(shapes["n"]), int(shapes["p"]), int(shapes["columns"])


def grad(shapes: dict) -> dict:
    """The masked gradient step alone: X, Y and M read, its result
    written."""
    n, p, _ = _shapes(shapes)
    return {"bytes": float(4 * 4 * n * p), "matmul_flops": 0.0,
            "flops": float(GRAD_OPS * n * p)}


def svt(shapes: dict) -> dict:
    """The randomized SVT of the (n, p) matrix alone."""
    n, p, r = _shapes(shapes)
    nbytes = 4 * (3 * n * p + p * r)
    matmul = 6 * n * p * r + 6 * n * r * r + 6 * p * r * r
    flops = (EIGH_OPS + SVD_OPS) * r ** 3 + n * r
    return {"bytes": float(nbytes), "matmul_flops": float(matmul),
            "flops": float(flops)}


def per_iteration(shapes: dict) -> dict:
    g, s = grad(shapes), svt(shapes)
    return {k: g[k] + s[k] for k in ("bytes", "matmul_flops", "flops")}
