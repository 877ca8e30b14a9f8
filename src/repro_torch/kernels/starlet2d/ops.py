"""Public wrappers for the starlet kernels: one smoothing, and the batched
transforms Phi and Phi^T over a whole (N, H, W) stamp stack — the layout
the Condat solver's dual updates use every iteration.

``forward`` / ``adjoint`` are the batched counterparts of
``repro_torch.imaging.starlet.forward``/``adjoint``.  On the card each is
one launch of a fused cascade that keeps every scale on chip
(``kernel.py``).  ``decompose`` stays composed of single smoothings: no
solver calls it.

Dispatch rule: a CPU tensor takes the plain version (``ref.py``), and
so does a ``meta`` tensor (shapes only); any other tensor launches the CUDA kernel or raises — there is no fallback.
``use_kernel=False`` selects the plain version on the card, for
comparing the two; ``use_kernel=True`` on a CPU tensor raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.starlet2d.kernel import (smooth_fwd,
                                                  starlet_adjoint_fwd,
                                                  starlet_forward_fwd)
from repro_torch.kernels.starlet2d.ref import (adjoint_ref, cascade,
                                               forward_ref, smooth_ref)


def _kernel(t, use_kernel) -> bool:
    return common.on_card(t) if use_kernel is None else use_kernel


def smooth(imgs, *, scale: int, use_kernel=None):
    if not _kernel(imgs, use_kernel):
        return smooth_ref(imgs, scale)
    return smooth_fwd(imgs, scale)


def decompose(imgs, n_scales: int, **kw):
    """Batched starlet analysis: (N, H, W) -> (J + 1, N, H, W)."""
    details, coarse = cascade(
        imgs, n_scales, lambda c, j: smooth(c, scale=j, **kw))
    return torch.stack(details + [coarse])


def forward(imgs, n_scales: int, *, use_kernel=None):
    """Batched Phi: detail scales only, (N, H, W) -> (J, N, H, W)."""
    if not _kernel(imgs, use_kernel):
        return forward_ref(imgs, n_scales)
    return starlet_forward_fwd(imgs, n_scales)


def adjoint(coeffs, n_scales: int, *, use_kernel=None):
    """Batched Phi^T: (J, N, H, W) -> (N, H, W)."""
    if not _kernel(coeffs, use_kernel):
        return adjoint_ref(coeffs, n_scales)
    return starlet_adjoint_fwd(coeffs, n_scales)
