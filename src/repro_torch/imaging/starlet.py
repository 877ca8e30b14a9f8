"""Isotropic undecimated wavelet transform (starlet / a-trous B3-spline).

The dictionary Phi of the paper's sparsity-regularised deconvolution
(Eq. 2).  Port of ``repro.imaging.starlet``: periodic boundaries, so
each smoothing is exactly self-adjoint and the adjoint cascade passes
the dot-product test to machine precision.

``smooth``, ``forward`` and ``adjoint`` go through the batched ops of
``kernels/starlet2d/ops`` on a (N, H, W) view of the input: on the card
one smoothing or one fused cascade a call, on the CPU the plain versions
— so no plain smoothing runs on the card.  ``decompose`` is composed of
``smooth``.

Random draws are a seam: the JAX module draws its power-iteration start
from ``PRNGKey(0)`` and its Monte-Carlo noise from ``PRNGKey(1)``.
Torch cannot reproduce those bits, so :func:`spectral_norm` takes
``x0=`` and :func:`noise_std_scales` takes ``noise=``; without them the
draws come from a CPU ``torch.Generator`` with the same seed (0 and 1),
which fixes them across devices.
"""
from __future__ import annotations

import functools
import threading

import torch

from repro_torch.core.spans import span
from repro_torch.kernels.common import resolve_device, to_device
from repro_torch.kernels.starlet2d import ops as starlet_batch
from repro_torch.kernels.starlet2d.ref import cascade

# serializes cold misses of the memoized default-start spectral norm so
# concurrent callers never duplicate the 30-step power iteration
_DEFAULT_NORM_LOCK = threading.Lock()


def smooth(img: torch.Tensor, scale: int) -> torch.Tensor:
    """One B3 smoothing at dyadic scale (2D, last two axes)."""
    h, w = img.shape[-2:]
    flat = img.reshape(-1, h, w).contiguous()
    return starlet_batch.smooth(flat, scale=scale).reshape(img.shape)


def decompose(img: torch.Tensor, n_scales: int) -> torch.Tensor:
    """Starlet analysis: (..., H, W) -> (n_scales + 1, ..., H, W).

    Output[0:n_scales] are detail scales, output[-1] is the coarse scale.
    Perfect reconstruction: the sum over axis 0 is the input.
    """
    details, coarse = cascade(img, n_scales, smooth)
    return torch.stack(details + [coarse])


def recompose(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`decompose` (sum of scales + coarse)."""
    return coeffs.sum(dim=0)


def forward(img: torch.Tensor, n_scales: int) -> torch.Tensor:
    """Phi: detail scales only (the paper drops the coarse scale),
    (..., H, W) -> (n_scales, ..., H, W)."""
    h, w = img.shape[-2:]
    flat = img.reshape(-1, h, w).contiguous()
    return starlet_batch.forward(flat, n_scales).reshape(
        (n_scales,) + tuple(img.shape))


def adjoint(coeffs: torch.Tensor, n_scales: int) -> torch.Tensor:
    """Phi^T for :func:`forward`, (n_scales, ..., H, W) -> (..., H, W):

        Phi^T w = v_0 + H_0 (v_1 + H_1 (v_2 + ... H_{J-2} v_{J-1}))

    with v_j = (I - H_j) w_j (see ``repro.imaging.starlet.adjoint``),
    evaluated as ``kernels/starlet2d/kernel.starlet_adjoint_fwd`` says on
    the card and Horner-style (2J - 1 smoothings) on the CPU.  Only the
    first ``n_scales`` planes of ``coeffs`` are read.
    """
    h, w = coeffs.shape[-2:]
    flat = coeffs[:n_scales].reshape(n_scales, -1, h, w).contiguous()
    return starlet_batch.adjoint(flat, n_scales).reshape(
        tuple(coeffs.shape[1:]))


def _cpu_normal(seed: int, shape) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(tuple(shape), generator=g, dtype=torch.float32)


def spectral_norm(n_scales: int, shape=(41, 41), iters: int = 30, *,
                  x0=None, device=None) -> float:
    """||Phi||_2 via power iteration (used for the Condat step sizes).

    ``x0`` is the (H, W) start vector (the JAX module draws it from
    ``PRNGKey(0)``).  The operator depends only on ``(n_scales, shape)``,
    so the default-start estimate is memoized per device: a loop of
    solves pays the power iteration once.
    """
    dev = resolve_device(device)
    if x0 is None:
        with _DEFAULT_NORM_LOCK:
            return _spectral_norm_default(int(n_scales), tuple(shape),
                                          int(iters), str(dev))
    x = to_device(x0, dev, torch.float32)
    return _spectral_norm_impl(n_scales, x, iters)


def _spectral_norm_impl(n_scales: int, x: torch.Tensor, iters: int) -> float:
    with span("deconvolve.norms"):
        nrm = None
        for _ in range(iters):
            x2 = adjoint(forward(x, n_scales), n_scales)
            nrm = torch.linalg.vector_norm(x2)
            x = x2 / (nrm + 1e-12)
        return float(torch.sqrt(nrm))


@functools.lru_cache(maxsize=None)
def _spectral_norm_default(n_scales: int, shape: tuple, iters: int,
                           device: str) -> float:
    with span("deconvolve.draws"):
        x = _cpu_normal(0, shape).to(device)
    return _spectral_norm_impl(n_scales, x, iters)


def noise_std_scales(n_scales: int, shape=(41, 41), n_mc: int = 8, *,
                     noise=None, device=None) -> torch.Tensor:
    """Per-scale noise amplification factors (for the weight matrix
    W^(k)): the population std of each detail scale under unit white
    noise, Monte-Carlo estimated from ``noise`` (n_mc, H, W) — the JAX
    module draws it from ``PRNGKey(1)``.  Returns a (J,) fp32 tensor."""
    dev = resolve_device(device)
    if noise is None:
        with span("deconvolve.draws"):
            noise = _cpu_normal(1, (n_mc,) + tuple(shape)).to(dev)
    noise = to_device(noise, dev, torch.float32)
    coeffs = forward(noise, n_scales)                 # (J, n_mc, H, W)
    # jnp.std is the population std: correction=0, not torch's default 1
    return torch.std(coeffs, dim=(1, 2, 3), correction=0)
