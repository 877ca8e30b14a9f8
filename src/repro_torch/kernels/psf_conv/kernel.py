"""The PSF convolution — the CUDA kernel's wrapper.

The kernel (``csrc/psf_conv.cu``, templates in ``csrc/psf_conv.cuh``)
replaces no TPU kernel: the JAX package leaves the FFT to XLA
(``jnp.fft`` in ``repro/imaging/psf.py``).  It replaces the port's cuFFT
route and the PyTorch around it (``ref.py``): rfft2 of the zero-padded
grid, the complex product, irfft2, the crop's copy, the pair's stack and
the gradient's separate ``HX - Y``.  One launch computes a stamp's whole
'same' convolution in shared memory, so only the operand, the spectrum
and the cropped output touch device memory.

It is bound by bytes: at 10 000 stamps of 41 x 41 on the 81-point grid a
convolution reads 67.2 MB of stamps and 265.7 MB of spectra and writes
67.2 MB, 0.119 ms at 3.35 TB/s (0.139 ms with ``HX - Y`` read on load;
the pair 0.239 ms counting both spectrum slabs, though its two operands'
blocks share one slab through L2).

A launch takes one operand, or two (the pair: one block per stamp and
operand, the two of a stamp side by side), of (n, S, S) fp32 stamps and
spectra of shape (n, G, G // 2 + 1) or (1, G, G // 2 + 1) (one for all
stamps) whose rows are contiguous and whose stamps lie a fixed stride
apart, as a view of the carried (n, 2, G, G // 2 + 1) pair is.  The
grid must be one with an instance (``GRIDS``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import common

# the largest grid with an instance: psf.pad_for of stamps and PSFs up to
# 64 wide; every stamp up to the grid then fits a block's shared memory
MAX_GRID = 128


def _smooth(n: int) -> bool:
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


# the grids with a kernel instance (``kGrids`` in csrc/psf_conv.cuh)
GRIDS = frozenset(g for g in range(1, MAX_GRID + 1) if _smooth(g))

WHAT = "psf_conv"


def check_operands(xs, spec, minus=None) -> None:
    """The shapes, grid and dtypes the kernel takes; anything else raises
    ``ValueError`` (before any device check, so on every device)."""
    x = xs[0]
    if x.dim() != 3 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"{WHAT}: expects (n, S, S) stamps, got "
                         f"{tuple(x.shape)}")
    for t in xs[1:] + (() if minus is None else (minus,)):
        if t.shape != x.shape:
            raise ValueError(f"{WHAT}: operand shapes differ: "
                             f"{tuple(x.shape)}, {tuple(t.shape)}")
    for t in xs + (() if minus is None else (minus,)):
        if t.dtype != torch.float32:
            raise ValueError(f"{WHAT}: expects float32 operands (bfloat16 "
                             f"ones go through float32 in the wrapper), got "
                             f"{t.dtype}")
    if spec.dtype != torch.complex64 or spec.dim() != 3:
        raise ValueError(f"{WHAT}: expects (n, G, G // 2 + 1) complex64 "
                         f"spectra, got {tuple(spec.shape)} {spec.dtype}")
    n, s = x.shape[0], x.shape[-1]
    g, h = spec.shape[-2:]
    if h != g // 2 + 1:
        raise ValueError(f"{WHAT}: spectra of shape {tuple(spec.shape)} are "
                         f"no half spectra of a square grid (the last axis "
                         f"must be G // 2 + 1)")
    if g not in GRIDS:
        raise ValueError(f"{WHAT}: no kernel instance for the grid {g}: the "
                         f"kernel takes the 5-smooth grids up to {MAX_GRID}")
    if s > g:
        raise ValueError(f"{WHAT}: stamps of {s} x {s} on a grid of {g}")
    if spec.shape[0] not in (1, n):
        raise ValueError(f"{WHAT}: {spec.shape[0]} spectra for {n} stamps "
                         f"(one a stamp, or one for all)")
    if spec.stride(-1) != 1 or spec.stride(-2) != h:
        raise ValueError(f"{WHAT}: a spectrum's rows must be contiguous, "
                         f"got strides {spec.stride()}")


def psf_conv_fwd(xs, spec, conj: Tuple[bool, ...], *, minus=None,
                 scale=None):
    """``xs``: one or two (n, S, S) fp32 CUDA tensors, contiguous;
    ``spec``: their spectra as above, on the same card; ``conj``: a flag
    per operand, conjugate the spectrum for it (the adjoint); ``minus``
    (one operand only): subtracted from it on load; ``scale``: a
    one-element fp32 tensor on the card that divides every operand entry
    as it is read (the power iteration's last norm).  Returns the tuple
    of 'same' convolutions, one per operand, and with ``scale`` also a
    (len(xs), n) fp32 tensor of each output stamp's sum of squares (the
    next norm's)."""
    xs = tuple(xs)
    check_operands(xs, spec, minus)
    if len(xs) not in (1, 2) or len(conj) != len(xs) \
            or (minus is not None and len(xs) != 1):
        raise ValueError(f"{WHAT}: one operand (with or without minus) or "
                         f"two, with a conjugation flag each")
    common.require_cuda(WHAT, *xs, *(() if minus is None else (minus,)))
    if spec.device != xs[0].device:
        raise ValueError(f"{WHAT}: spectra on {spec.device}, stamps on "
                         f"{xs[0].device}")
    if scale is not None:
        scale = common.device_scalar(scale, xs[0], WHAT, "scale")
    two = len(xs) == 2
    outs = tuple(torch.empty_like(x) for x in xs)
    sums = None if scale is None else torch.empty(
        (len(xs), xs[0].shape[0]), dtype=torch.float32, device=xs[0].device)
    err = common.library().repro_psf_conv(
        xs[0].data_ptr(), xs[1].data_ptr() if two else None,
        None if minus is None else minus.data_ptr(), spec.data_ptr(),
        spec.data_ptr(), spec.stride(0) if spec.shape[0] > 1 else 0,
        int(conj[0]), int(conj[-1]), outs[0].data_ptr(),
        outs[1].data_ptr() if two else None,
        None if scale is None else scale.data_ptr(),
        None if sums is None else sums.data_ptr(), xs[0].shape[0],
        xs[0].shape[-1], spec.shape[-2], len(xs), common.stream_ptr(xs[0]))
    common.check(err, WHAT)
    psf_conv_fwd.launches += 1
    # the pair (the power iteration's step) and the gradient's
    # Ht(HX - Y) are also counted apart
    psf_conv_fwd.launches_pair += int(two)
    psf_conv_fwd.launches_grad += int(minus is not None)
    return outs if sums is None else outs + (sums,)


psf_conv_fwd.launches = 0
psf_conv_fwd.launches_pair = 0
psf_conv_fwd.launches_grad = 0
