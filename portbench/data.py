"""The benchmark's inputs, made from ``--seed`` on the device in a few
large calls.

Galaxy catalogues follow the stand-ins of the port's
``imaging/psf.simulate`` (two-component elliptical galaxies normalized
to unit flux, anisotropic Gaussian PSFs whose shape varies with a sky
position, white noise of ``sigma``), convolved by the reference's own
operator.  Patch pairs follow ``data/synthetic.coupled_patches``: high-
resolution patches as sparse combinations (8 %) of a random unit
dictionary, low-resolution ones a fixed random projection of them, each
with noise 0.01."""
from __future__ import annotations

import math

import torch

from portbench.reference import deconv_sparse


def _gaussians(stamp, cx, cy, sx, sy, theta, device):
    ax = torch.arange(stamp, dtype=torch.float32, device=device)
    yy, xx = ax[None, :, None], ax[None, None, :]
    cx, cy, sx, sy, theta = (torch.as_tensor(v, dtype=torch.float32,
                                             device=device).reshape(-1, 1, 1)
                             for v in (cx, cy, sx, sy, theta))
    xr = (xx - cx) * torch.cos(theta) + (yy - cy) * torch.sin(theta)
    yr = -(xx - cx) * torch.sin(theta) + (yy - cy) * torch.cos(theta)
    return torch.exp(-0.5 * ((xr / sx) ** 2 + (yr / sy) ** 2))


def catalogue(n: int, gen: torch.Generator, *, stamp: int = 41,
              sigma: float = 0.02):
    """``(Y, psfs)``, each (n, stamp, stamp) float32 on the generator's
    device."""
    dev = gen.device
    c = stamp // 2
    u = torch.rand((n, 6), generator=gen, device=dev)
    a = _gaussians(stamp, c + 4 * (u[:, 0] - .5), c + 4 * (u[:, 1] - .5),
                   2.0 + 3.0 * u[:, 2], 1.5 + 2.0 * u[:, 3],
                   math.pi * u[:, 4], dev)
    b = _gaussians(stamp, c, c, 1.0 + u[:, 5], 1.0 + u[:, 5], 0.0, dev)
    img = a + 0.5 * b
    X = img / img.sum(dim=(-2, -1), keepdim=True)
    pos = torch.rand((n, 2), generator=gen, device=dev)
    e = 0.15 * torch.sin(2 * math.pi * pos[:, 0]) + 0.1 * pos[:, 1]
    k = _gaussians(stamp, c, c, 1.8 * (1 + e), 1.8 * (1 - e),
                   math.pi * (pos[:, 0] + pos[:, 1]), dev)
    psfs = k / k.sum(dim=(-2, -1), keepdim=True)
    noise = torch.randn((n, stamp, stamp), generator=gen, device=dev)
    Y = deconv_sparse.convolve(X, deconv_sparse.psf_spectrum(psfs)) \
        + sigma * noise
    return Y.contiguous(), psfs.contiguous()


def patch_pairs(K: int, p_dim: int, m_dim: int, n_atoms: int,
                gen: torch.Generator, *, sparsity: float = 0.08,
                noise: float = 0.01):
    """``(S_h (P, K), S_l (M, K))`` float32 on the generator's device."""
    dev = gen.device
    D = torch.randn((p_dim, n_atoms), generator=gen, device=dev)
    D = D / torch.linalg.norm(D, dim=0, keepdim=True)
    codes = torch.randn((n_atoms, K), generator=gen, device=dev)
    keep = torch.rand((n_atoms, K), generator=gen, device=dev) < sparsity
    S_h = D @ (codes * keep)
    R = torch.randn((m_dim, p_dim), generator=gen, device=dev) \
        / math.sqrt(p_dim)
    S_l = R @ S_h
    S_h = S_h + noise * torch.randn(S_h.shape, generator=gen, device=dev)
    S_l = S_l + noise * torch.randn(S_l.shape, generator=gen, device=dev)
    return S_h.contiguous(), S_l.contiguous()
