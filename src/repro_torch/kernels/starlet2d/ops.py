"""Public wrapper for the starlet-smoothing kernel, plus the batched
transforms built from it.

``forward`` / ``adjoint`` are the batched counterparts of
``repro_torch.imaging.starlet.forward``/``adjoint`` over a whole
(N, H, W) stamp stack — the layout the Condat solver's dual updates use
every iteration.  The adjoint shares cumulative smoothing products
across scales (Horner evaluation, 2J - 1 kernel launches instead of
O(J^2)).

Dispatch rule: a CPU tensor takes the plain version (``ref.py``); any
other tensor launches the CUDA kernel or raises — there is no fallback.
``use_kernel=False`` selects the plain version on the card, for
comparing the two; ``use_kernel=True`` on a CPU tensor raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.starlet2d.kernel import smooth_fwd
from repro_torch.kernels.starlet2d.ref import smooth_ref


def smooth(imgs, *, scale: int, use_kernel=None):
    if use_kernel is None:
        use_kernel = imgs.device.type != "cpu"
    if not use_kernel:
        return smooth_ref(imgs, scale)
    return smooth_fwd(imgs, scale)


def _cascade(imgs, n_scales: int, **kw):
    """The J detail scales and the coarse scale of the analysis."""
    details = []
    c = imgs
    for j in range(n_scales):
        c_next = smooth(c, scale=j, **kw)
        details.append(c - c_next)
        c = c_next
    return details, c


def decompose(imgs, n_scales: int, **kw):
    """Batched starlet analysis: (N, H, W) -> (J + 1, N, H, W)."""
    details, coarse = _cascade(imgs, n_scales, **kw)
    return torch.stack(details + [coarse])


def forward(imgs, n_scales: int, **kw):
    """Batched Phi: detail scales only, (N, H, W) -> (J, N, H, W).

    Stacks the J details directly instead of slicing ``decompose``, so
    the result owns no coarse-scale storage."""
    return torch.stack(_cascade(imgs, n_scales, **kw)[0])


def adjoint(coeffs, n_scales: int, **kw):
    """Batched Phi^T: (J, N, H, W) -> (N, H, W).

    Horner evaluation of the cascade transpose (see
    ``repro_torch.imaging.starlet.adjoint``): v_j = (I - H_j) w_j, then
    acc_j = v_j + H_j acc_{j+1} from the finest carried scale down.
    ``coeffs[j]`` of a contiguous (J, N, H, W) stack is contiguous, so
    each smoothing reads the dual stack in place.
    """
    acc = coeffs[n_scales - 1] - smooth(coeffs[n_scales - 1],
                                        scale=n_scales - 1, **kw)
    for j in range(n_scales - 2, -1, -1):
        v = coeffs[j] - smooth(coeffs[j], scale=j, **kw)
        acc = v + smooth(acc, scale=j, **kw)
    return acc
