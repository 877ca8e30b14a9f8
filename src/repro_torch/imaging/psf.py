"""Space-variant PSF forward operator H and Euclid-like data simulation.

Port of ``repro.imaging.psf``.  H(X) = [H^0 x^0, ..., H^n x^n]: every
galaxy stamp is convolved with the PSF at its own sky position.
FFT-based 'same' convolution on a padded grid; the adjoint is
correlation, the conjugate spectrum.

The grid is the smallest fast FFT size >= 2S - 1 (81 = 3^4 for S = 41);
the kernel spectra are built once (``rfft2`` of the rolled, zero-padded
PSFs) and carried as the ``(kf, conj kf)`` pair.  Every convolution off
a carried spectrum goes through ``kernels/psf_conv``: on the card one
launch of a hand-written kernel that runs a stamp's whole 2-D transform,
the spectral product and the inverse in shared memory, reading the
operand and the spectrum and writing the cropped result, with nothing
padded ever stored (:func:`Ht_fp_diff` forms the gradient's ``HX - Y``
on load, :func:`conv_pair_f` runs a forward and an adjoint convolution
of two operands in one launch, and the power iteration's step adds to
that pair the division by the last norm and the sums of squares of the
next); on the CPU the plain ``torch.fft`` version (pocketfft).

Random draws are a seam: :func:`spectral_norm` takes its start vectors
as ``u0=``/``v0=`` and otherwise draws them from a CPU
``torch.Generator`` seeded 0.  That default draw depends only on the
shape, so it is made once per shape and device and kept on the device,
least recently used first under a fixed total of bytes;
``DEFAULT_STARTS`` counts its hits and misses.  :func:`simulate` draws
from a ``torch.Generator`` (seed 42 by default), so it matches the JAX
simulation in distribution only.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.spans import span
from repro_torch.kernels.common import resolve_device, to_device
from repro_torch.kernels.psf_conv import ops as psf_conv
from repro_torch.kernels.psf_conv.ref import _real

STAMP = 41

# the default start vectors of spectral_norm, (u0, v0) on the device by
# (shape, device), least recently used first, at most _DEFAULT_STARTS_CAP
# bytes in all (a larger pair is drawn and used but not kept).  They are
# read only: _power_norm divides them out of place, and nothing may write
# into them.  The lock serializes lookups and fills, so concurrent
# callers of one shape draw once.
_DEFAULT_STARTS_CAP = 1 << 30
_DEFAULT_STARTS_LOCK = threading.Lock()
_default_starts: OrderedDict = OrderedDict()
# default-draw calls of spectral_norm that found their pair kept (hits)
# or drew it (misses); injected draws count in neither
DEFAULT_STARTS = {"hits": 0, "misses": 0}


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
    return psf_conv.convolve(x, kf, conj=adjoint)


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
    return psf_conv.convolve(X, kf_pair[..., 0, :, :])


def Ht_fp(Y: torch.Tensor, kf_pair: torch.Tensor) -> torch.Tensor:
    """Adjoint convolution off the carried pair (conjugate precomputed)."""
    return psf_conv.convolve(Y, kf_pair[..., 1, :, :])


def Ht_fp_diff(A: torch.Tensor, B: torch.Tensor, kf_pair: torch.Tensor
               ) -> torch.Tensor:
    """Ht(A - B) off the carried pair, the difference taken as the
    operand is read (the gradient's Ht(HX - Y): one launch on the card,
    no intermediate)."""
    return psf_conv.convolve(A, kf_pair[..., 1, :, :], minus=B)


def conv_pair_f(A: torch.Tensor, B: torch.Tensor, kf_pair: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H(A), Ht(B)) for two independent operands in one round trip: one
    launch on the card; on the CPU rfft2 of the stacked (n, 2, S, S)
    operand, one spectral multiply against the carried pair, one
    irfft2."""
    return psf_conv.convolve_pair(A, B, kf_pair)


def spectral_norm(psfs: torch.Tensor, iters: int = 60, *, u0=None, v0=None,
                  kf_pair: Optional[torch.Tensor] = None) -> float:
    """||H||_2 via power iteration of the self-adjoint augmented operator
    A(u, v) = (Ht v, H u), one round trip of the pair per step.

    ``u0``/``v0`` are the start vectors, shaped like ``psfs`` (the JAX
    module draws them from the two halves of ``split(PRNGKey(0))``).
    Without them the CPU seed-0 draw is taken, kept per shape and device
    (``DEFAULT_STARTS`` counts the hits and misses).
    """
    if kf_pair is None:
        kf_pair = psf_fft_pair(psfs)
    if u0 is None or v0 is None:
        u, v = _default_starts_for(tuple(psfs.shape), psfs.device)
    else:
        u = to_device(u0, psfs.device, torch.float32)
        v = to_device(v0, psfs.device, torch.float32)
    with span("deconvolve.norms"):
        return float(_power_norm(u, v, kf_pair, iters))


def _default_starts_for(shape: tuple, device: torch.device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CPU seed-0 draw of ``u0`` then ``v0``, fp32 on ``device``:
    kept from an earlier call, or drawn now (and kept if it fits)."""
    key = (shape, str(device))
    with _DEFAULT_STARTS_LOCK:
        pair = _default_starts.get(key)
        if pair is not None:
            _default_starts.move_to_end(key)
            DEFAULT_STARTS["hits"] += 1
            return pair
        DEFAULT_STARTS["misses"] += 1
        with span("deconvolve.draws"):
            g = torch.Generator().manual_seed(0)
            pair = tuple(torch.randn(shape, generator=g).to(device,
                                                           torch.float32)
                         for _ in range(2))
        size = _nbytes(pair)
        if size <= _DEFAULT_STARTS_CAP:
            kept = sum(map(_nbytes, _default_starts.values()))
            while kept + size > _DEFAULT_STARTS_CAP:
                kept -= _nbytes(_default_starts.popitem(last=False)[1])
            _default_starts[key] = pair
        return pair


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _power_norm(u, v, kf_pair, iters: int) -> torch.Tensor:
    """Each step convolves (u, v) / nrm, the last norm dividing the
    operands as they are read, and returns its outputs' sums of squares
    for the next norm (``psf_conv.power_step``: one launch on the card)."""
    scale = torch.sqrt(torch.sum(u ** 2) + torch.sum(v ** 2))
    nrm = None
    for _ in range(iters):
        Hu, Htv, sq_hu, sq_htv = psf_conv.power_step(u, v, kf_pair, scale)
        nrm = torch.sqrt(sq_htv + sq_hu) + 1e-12
        u, v, scale = Htv, Hu, nrm
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
