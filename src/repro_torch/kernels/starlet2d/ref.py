"""Plain PyTorch versions of the batched starlet kernels: one B3 a-trous
smoothing over a stack of stamps with periodic boundaries, matching
``repro_torch.imaging.starlet.smooth``, and the transforms Phi and Phi^T
composed from it with torch arithmetic in the input dtype.

The smoothing follows the kernel's contract, not the JAX oracle's: the
two passes accumulate in fp32 and the result is cast back to the input
dtype once (the JAX ``smooth_ref`` accumulates in the input dtype, which
differs for bf16 only)."""
from __future__ import annotations

import torch

_K = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def smooth_ref(imgs, scale: int):
    """imgs: (N, H, W) -> (N, H, W), one smoothing at dyadic ``scale``."""
    step = 1 << scale
    out = imgs.to(torch.float32)
    for dim in (-1, -2):
        acc = _K[2] * out
        for t, off in ((0, -2), (1, -1), (3, 1), (4, 2)):
            # torch.roll, like jnp.roll, wraps shifts longer than the axis
            acc = acc + _K[t] * torch.roll(out, off * step, dims=dim)
        out = acc
    return out.to(imgs.dtype)


def cascade(imgs, n_scales: int, smooth=smooth_ref):
    """The J detail scales and the coarse scale of the analysis, from J
    smoothings ``smooth(c, j)`` and differences in the input dtype."""
    details = []
    c = imgs
    for j in range(n_scales):
        c_next = smooth(c, j)
        details.append(c - c_next)
        c = c_next
    return details, c


def forward_ref(imgs, n_scales: int):
    """Phi: (N, H, W) -> (J, N, H, W), the detail scales only."""
    return torch.stack(cascade(imgs, n_scales)[0])


def horner(coeffs, n_scales: int, smooth=smooth_ref):
    """Phi^T from Horner's 2J - 1 smoothings ``smooth(c, j)`` (see
    ``repro_torch.imaging.starlet.adjoint``): v_j = (I - H_j) w_j, then
    acc_j = v_j + H_j acc_{j+1} from the coarsest carried scale down."""
    top = n_scales - 1
    acc = coeffs[top] - smooth(coeffs[top], top)
    for j in range(top - 1, -1, -1):
        v = coeffs[j] - smooth(coeffs[j], j)
        acc = v + smooth(acc, j)
    return acc


def adjoint_ref(coeffs, n_scales: int):
    """Phi^T: (J, N, H, W) -> (N, H, W), Horner's form of ``smooth_ref``."""
    return horner(coeffs, n_scales)
