"""One iteration of the sparse Condat deconvolution at its shapes.

What the algorithm must do per iteration, for n stamps of S x S, J
scales and an FFT grid of G x G (the reference's padded grid):

- bytes: the observed stamps Y and the PSFs read once, the carried
  primal X and dual U (J planes) read once and written once, and the
  weights (J per stamp) read once; 4 bytes each.  H(X) and Phi(X) are
  derived from X, so they are no state of the algorithm.
- other operations: the two convolutions of the gradient, H(X) - Y
  and its adjoint, as four real 2D FFTs of G x G (2.5 G^2 log2 G^2
  each) and two complex products over the half spectrum (6 each); one
  starlet forward (J smoothings of two 5-tap passes, 18 operations a
  pixel, and a difference) and its adjoint in Horner's form (2J - 1
  smoothings, 2J differences and sums); the primal step (5 a pixel) and
  the dual step (6 a coefficient).  The PSF's own spectrum is not
  counted: an implementation reads it or computes it, and either costs
  more than the PSF's bytes alone.
- matrix products: none.
"""
from __future__ import annotations

import math

SMOOTH_OPS = 18          # two separable passes of 5 taps: 5 mul + 4 add each


def per_iteration(shapes: dict) -> dict:
    n, S, J, G = (int(shapes[k]) for k in ("n", "stamp", "n_scales", "grid"))
    px = S * S
    nbytes = 4 * n * (px                # Y
                      + px              # PSF
                      + 2 * px          # X read and written
                      + 2 * J * px      # U read and written
                      + J)              # W
    fft = 2.5 * G * G * math.log2(G * G)
    spectral = 6 * G * (G // 2 + 1)
    forward = J * (SMOOTH_OPS + 1) * px
    adjoint = ((2 * J - 1) * SMOOTH_OPS + 2 * J) * px
    flops = n * (4 * fft + 2 * spectral + forward + adjoint
                 + 5 * px + 6 * J * px + px)
    return {"bytes": float(nbytes), "matmul_flops": 0.0,
            "flops": float(flops)}
