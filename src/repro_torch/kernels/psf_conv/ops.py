"""Public wrappers for the PSF convolution.

Dispatch rule: CPU tensors take the plain versions (``ref.py``), and
so do ``meta`` tensors (shapes only); any other tensor launches the CUDA
kernel or raises — there is no fallback.  ``use_kernel=False`` selects
the plain version on the card, for comparing the two;
``use_kernel=True`` on CPU tensors raises.

On the card leading batch axes are flattened into the kernel's stamp
axis: stamps (..., S, S) against spectra (..., G, G // 2 + 1) with the
same leading shape (a bucket's (B, n, S, S) against (B, n, 2, G, H)
slices), or one spectrum for all.  bfloat16 operands go through float32
(``HX - Y`` taken in their own dtype first, as the plain version does)
and the result is cast back.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.psf_conv.kernel import psf_conv_fwd
from repro_torch.kernels.psf_conv.ref import (_real, convolve_pair_ref,
                                              convolve_ref, power_step_ref)

# the chaos family (``kernel:psf_conv``); the JAX package has none (XLA
# runs its FFTs), so a plan names it only for the port
FAMILY = "psf_conv"


def _stamps(x: torch.Tensor) -> torch.Tensor:
    """(..., S, S) as a contiguous fp32 (N, S, S) stack."""
    return _real(x).reshape((-1,) + tuple(x.shape[-2:])).contiguous()


def _spectra(kf: torch.Tensor, lead: Tuple[int, ...]) -> torch.Tensor:
    """The spectra as a (N or 1, G, H) view: a copy only when the leading
    axes do not flatten to one stride, or to resolve a lazy conjugate
    (``torch.conj``), whose data the kernel would read unconjugated."""
    if tuple(kf.shape[:-2]) != lead and math.prod(kf.shape[:-2]) != 1:
        raise ValueError(f"psf_conv: spectra of shape {tuple(kf.shape)} "
                         f"for stamps of leading shape {lead} (one a "
                         f"stamp, or one for all)")
    spec = kf.resolve_conj().reshape((-1,) + tuple(kf.shape[-2:]))
    if spec.stride(-1) != 1 or spec.stride(-2) != spec.shape[-1]:
        spec = spec.contiguous()
    return spec


def convolve(x, kf, *, conj=False, minus=None, use_kernel=None):
    """'same' convolution of ``x - minus`` (or ``x``) with the spectra
    ``kf``; ``conj``: with their conjugates (the adjoint)."""
    common.chaos_point(FAMILY, x)
    if use_kernel is None:
        use_kernel = common.on_card(x)
    if not use_kernel:
        return convolve_ref(x, kf, conj=conj, minus=minus)
    if minus is not None and minus.shape != x.shape:
        raise ValueError(f"psf_conv: minus of shape {tuple(minus.shape)} "
                         f"for stamps of shape {tuple(x.shape)}")
    dtype = x.dtype
    if minus is not None and dtype != torch.float32:
        x, minus = x - minus, None
    (out,) = psf_conv_fwd((_stamps(x),), _spectra(kf, tuple(x.shape[:-2])),
                          (conj,),
                          minus=None if minus is None else _stamps(minus))
    return out.reshape(x.shape).to(dtype)


def convolve_pair(A, B, kf_pair, *, use_kernel=None):
    """(H A, Ht B) off the carried (kf, conj kf) pair, one launch: both
    operands read the forward slab, B's conjugated on the fly."""
    common.chaos_point(FAMILY, A)
    if use_kernel is None:
        use_kernel = common.on_card(A)
    if not use_kernel:
        return convolve_pair_ref(A, B, kf_pair)
    if A.shape != B.shape or kf_pair.dim() < 3 or kf_pair.shape[-3] != 2:
        raise ValueError(f"psf_conv: a pair of shapes {tuple(A.shape)}, "
                         f"{tuple(B.shape)} against spectra of shape "
                         f"{tuple(kf_pair.shape)} (..., 2, G, H)")
    spec = _spectra(kf_pair[..., 0, :, :], tuple(A.shape[:-2]))
    a, b = psf_conv_fwd((_stamps(A), _stamps(B)), spec, (False, True))
    return a.reshape(A.shape).to(A.dtype), b.reshape(B.shape).to(B.dtype)


def power_step(A, B, kf_pair, scale, *, use_kernel=None):
    """The power iteration's step: (H a, Ht b) of a = A / scale and
    b = B / scale, and the sums of squares of H a and of Ht b (0-d).  On
    the card one launch of the pair that divides as it reads and sums
    each output stamp's squares in a fixed order; the stamps' sums are
    then added by ``torch.sum``."""
    common.chaos_point(FAMILY, A)
    if use_kernel is None:
        use_kernel = common.on_card(A)
    if not use_kernel:
        return power_step_ref(A, B, kf_pair, scale)
    if A.shape != B.shape or A.dtype != torch.float32 \
            or B.dtype != torch.float32 or kf_pair.dim() < 3 \
            or kf_pair.shape[-3] != 2:
        raise ValueError(f"psf_conv: a power step of shapes "
                         f"{tuple(A.shape)}, {tuple(B.shape)} ({A.dtype}, "
                         f"{B.dtype}) against spectra of shape "
                         f"{tuple(kf_pair.shape)}: float32 stamps and "
                         f"(..., 2, G, H) spectra")
    spec = _spectra(kf_pair[..., 0, :, :], tuple(A.shape[:-2]))
    a, b, sums = psf_conv_fwd((_stamps(A), _stamps(B)), spec, (False, True),
                              scale=scale)
    return (a.reshape(A.shape), b.reshape(B.shape), torch.sum(sums[0]),
            torch.sum(sums[1]))
