"""Space-variant PSF forward operator H and Euclid-like data simulation.

Port of ``repro.imaging.psf``.  H(X) = [H^0 x^0, ..., H^n x^n]: every
galaxy stamp is convolved with the PSF at its own sky position.
FFT-based 'same' convolution on a padded grid (``torch.fft``: cuFFT on
the card, pocketfft on the CPU); the adjoint is correlation, the
conjugate spectrum.

Paired-FFT engine: the grid is the smallest fast FFT size >= 2S - 1
(81 = 3^4 for S = 41), the kernel spectra are carried as the
``(kf, conj kf)`` pair so the adjoint never conjugates on the hot path,
and :func:`conv_pair_f` runs one forward and one adjoint convolution of
two independent operands as one batched rfft2 -> multiply -> irfft2.

Random draws are a seam: :func:`spectral_norm` takes its start vectors
as ``u0=``/``v0=`` and otherwise draws them from a CPU
``torch.Generator`` seeded 0; :func:`simulate` draws from a
``torch.Generator`` (seed 42 by default), so it matches the JAX
simulation in distribution only.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.common import resolve_device, to_device

STAMP = 41


def fast_size(n: int) -> int:
    """Smallest 5-smooth integer >= n (radix-2/3/5 FFT plans)."""
    m = max(int(n), 1)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def pad_for(stamp: int, kernel: int = 0) -> int:
    """FFT grid for 'same' convolution of a (stamp, stamp) image with a
    (kernel, kernel) PSF: smallest fast size >= stamp + kernel - 1 (full
    linear-convolution support, so the cropped window is alias-free)."""
    kernel = kernel or stamp
    return fast_size(stamp + kernel - 1)


def _real(x: torch.Tensor) -> torch.Tensor:
    """FFT operand dtype: half-precision stamps go through the engine in
    fp32 (results are cast back to the operand dtype by the callers)."""
    return x if x.is_floating_point() and x.element_size() >= 4 \
        else x.to(torch.float32)


def _fft_kernel(psf: torch.Tensor, pad: int) -> torch.Tensor:
    """Centred PSF -> rfft2 on the padded grid (kernel rolled to the
    origin)."""
    psf = _real(psf)
    h = psf.shape[-2]
    padded = psf.new_zeros(tuple(psf.shape[:-2]) + (pad, pad))
    padded[..., :h, :h] = psf
    padded = torch.roll(padded, (-(h // 2), -(h // 2)), dims=(-2, -1))
    return torch.fft.rfft2(padded)


def convolve_f(x: torch.Tensor, kf: torch.Tensor, adjoint: bool = False
               ) -> torch.Tensor:
    """'same' convolution of stamps off a precomputed kernel spectrum.
    Returns a contiguous tensor (the kernels downstream require it)."""
    s = x.shape[-1]
    pad = grid_of(kf)
    xf = torch.fft.rfft2(_real(x), s=(pad, pad))
    if adjoint:
        kf = torch.conj(kf)
    out = torch.fft.irfft2(xf * kf, s=(pad, pad))
    return out[..., :s, :s].to(x.dtype).contiguous()


def convolve(x: torch.Tensor, psf: torch.Tensor, adjoint: bool = False
             ) -> torch.Tensor:
    """'same' convolution of stamps with per-stamp PSFs (one-shot; loops
    precompute :func:`psf_fft_pair` instead)."""
    pad = pad_for(x.shape[-1], psf.shape[-2])
    return convolve_f(x, _fft_kernel(psf, pad), adjoint)


def H(X: torch.Tensor, psfs: torch.Tensor) -> torch.Tensor:
    """Forward operator over a stack: (n, S, S) x (n, S, S) -> (n, S, S)."""
    return convolve(X, psfs)


def Ht(Y: torch.Tensor, psfs: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`H`."""
    return convolve(Y, psfs, adjoint=True)


def psf_fft(psfs: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """The padded rfft2 PSF kernels."""
    return _fft_kernel(psfs, pad or pad_for(psfs.shape[-1]))


def psf_fft_pair(psfs: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """The ``(kf, conj kf)`` spectra stacked record-major —
    (n, 2, pad, pad // 2 + 1) complex64.  ``[:, 0]`` drives H,
    ``[:, 1]`` drives Ht (no conjugation on the hot path)."""
    kf = psf_fft(psfs, pad)
    return torch.stack([kf, torch.conj(kf)], dim=-3)


def grid_of(kf: torch.Tensor) -> int:
    """The (square) padded grid size of a kernel spectrum."""
    return kf.shape[-2]


def H_f(X: torch.Tensor, kf: torch.Tensor) -> torch.Tensor:
    """Forward convolution off a precomputed kernel spectrum."""
    return convolve_f(X, kf)


def Ht_f(Y: torch.Tensor, kf: torch.Tensor) -> torch.Tensor:
    """Adjoint convolution off a precomputed kernel spectrum."""
    return convolve_f(Y, kf, adjoint=True)


def H_fp(X: torch.Tensor, kf_pair: torch.Tensor) -> torch.Tensor:
    """Forward convolution off the carried pair."""
    return convolve_f(X, kf_pair[..., 0, :, :])


def Ht_fp(Y: torch.Tensor, kf_pair: torch.Tensor) -> torch.Tensor:
    """Adjoint convolution off the carried pair (conjugate precomputed)."""
    return convolve_f(Y, kf_pair[..., 1, :, :])


def conv_pair_f(A: torch.Tensor, B: torch.Tensor, kf_pair: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H(A), Ht(B)) for two independent operands in one batched FFT
    round trip: rfft2 of the stacked (n, 2, S, S) operand, one spectral
    multiply against the carried pair, one irfft2."""
    s = A.shape[-1]
    pad = grid_of(kf_pair)
    z = torch.stack([_real(A), _real(B)], dim=-3)
    zf = torch.fft.rfft2(z, s=(pad, pad))
    out = torch.fft.irfft2(zf * kf_pair, s=(pad, pad))[..., :s, :s]
    return (out[..., 0, :, :].to(A.dtype).contiguous(),
            out[..., 1, :, :].to(B.dtype).contiguous())


def spectral_norm(psfs: torch.Tensor, iters: int = 60, *, u0=None, v0=None,
                  kf_pair: Optional[torch.Tensor] = None) -> float:
    """||H||_2 via power iteration of the self-adjoint augmented operator
    A(u, v) = (Ht v, H u), one :func:`conv_pair_f` round trip per step.

    ``u0``/``v0`` are the start vectors, shaped like ``psfs`` (the JAX
    module draws them from the two halves of ``split(PRNGKey(0))``).
    """
    if kf_pair is None:
        kf_pair = psf_fft_pair(psfs)
    if u0 is None or v0 is None:
        g = torch.Generator().manual_seed(0)
        u0 = torch.randn(tuple(psfs.shape), generator=g)
        v0 = torch.randn(tuple(psfs.shape), generator=g)
    u = to_device(u0, psfs.device, torch.float32)
    v = to_device(v0, psfs.device, torch.float32)
    return float(_power_norm(u, v, kf_pair, iters))


def _power_norm(u, v, kf_pair, iters: int) -> torch.Tensor:
    nrm0 = torch.sqrt(torch.sum(u ** 2) + torch.sum(v ** 2))
    u, v = u / nrm0, v / nrm0
    nrm = None
    for _ in range(iters):
        Hu, Htv = conv_pair_f(u, v, kf_pair)
        nrm = torch.sqrt(torch.sum(Htv ** 2) + torch.sum(Hu ** 2)) + 1e-12
        u, v = Htv / nrm, Hu / nrm
    return nrm


class PsfData(NamedTuple):
    Y: torch.Tensor          # noisy observed stamps   (n, S, S)
    X_true: torch.Tensor     # ground-truth stamps     (n, S, S)
    psfs: torch.Tensor       # per-object PSFs         (n, S, S)
    sigma: float             # noise std


def _gaussian2d(stamp: int, cx, cy, sx, sy, theta, device):
    """Batched anisotropic Gaussians: each argument is an (n,) tensor
    (or a number); returns (n, stamp, stamp)."""
    ax = torch.arange(stamp, dtype=torch.float32, device=device)
    yy = ax[None, :, None]
    xx = ax[None, None, :]

    def col(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=device)
        return v.reshape(-1, 1, 1)

    cx, cy, sx, sy, theta = map(col, (cx, cy, sx, sy, theta))
    xr = (xx - cx) * torch.cos(theta) + (yy - cy) * torch.sin(theta)
    yr = -(xx - cx) * torch.sin(theta) + (yy - cy) * torch.cos(theta)
    return torch.exp(-0.5 * ((xr / sx) ** 2 + (yr / sy) ** 2))


def simulate(n: int, generator: Optional[torch.Generator] = None,
             stamp: int = STAMP, sigma: float = 0.02,
             dtype=torch.float32, device=None) -> PsfData:
    """Euclid-like simulation: n stamps + spatially varying PSFs.

    The draws come from ``generator`` (a CPU ``torch.Generator``; seed
    42 when omitted), so the same generator gives the same data on
    every device; the shapes are computed on ``device``."""
    dev = resolve_device(device)
    g = generator if generator is not None \
        else torch.Generator().manual_seed(42)
    c = stamp // 2

    # galaxies: 2-component elliptical blobs with random orientation
    u = torch.rand((n, 6), generator=g).to(dev)
    a = _gaussian2d(stamp, c + 4 * (u[:, 0] - .5), c + 4 * (u[:, 1] - .5),
                    2.0 + 3.0 * u[:, 2], 1.5 + 2.0 * u[:, 3],
                    math.pi * u[:, 4], dev)
    b = _gaussian2d(stamp, c, c, 1.0 + u[:, 5], 1.0 + u[:, 5], 0.0, dev)
    img = a + 0.5 * b
    X = (img / img.sum(dim=(-2, -1), keepdim=True)).to(dtype)

    # PSFs: anisotropy varies smoothly with a fake sky position
    pos = torch.rand((n, 2), generator=g).to(dev)
    e = 0.15 * torch.sin(2 * math.pi * pos[:, 0]) + 0.1 * pos[:, 1]
    k = _gaussian2d(stamp, c, c, 1.8 * (1 + e), 1.8 * (1 - e),
                    math.pi * (pos[:, 0] + pos[:, 1]), dev)
    psfs = (k / k.sum(dim=(-2, -1), keepdim=True)).to(dtype)

    noise = torch.randn((n, stamp, stamp), generator=g).to(dev)
    Y = H(X, psfs) + sigma * noise.to(dtype)
    return PsfData(Y=Y, X_true=X, psfs=psfs, sigma=sigma)
