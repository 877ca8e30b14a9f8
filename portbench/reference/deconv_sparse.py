"""Plain reference of the sparse space-variant PSF deconvolution
(arXiv:1809.05956, Eq. 2; Condat's primal-dual splitting, after Farrens
et al. 2017), written from the algorithm's definition in plain PyTorch.

    min_X  0.5 ||Y - H(X)||_F^2 + ||W o Phi(X)||_1   s.t.  X >= 0

- ``H`` convolves each stamp with its own PSF: a 'same' linear
  convolution on the padded FFT grid (the smallest 5-smooth size >=
  2S - 1), its adjoint the correlation.
- ``Phi`` is the starlet transform's J detail scales: B3-spline a-trous
  smoothings with periodic boundaries, ``w_j = c_j - c_{j+1}``.  Its
  adjoint is evaluated term by term, ``sum_j H_0 ... H_{j-1} (I - H_j)
  w_j``, not in any factored form.
- The weights are ``k_sigma * sigma * std_j * ||psf_i||``, with
  ``std_j`` the population standard deviation of scale j over a
  Monte-Carlo draw of unit white noise.
- The step sizes come from power iterations: ``sig = 0.5 / ||Phi||^2``,
  ``tau = 1 / (||H||^2 / 2 + sig ||Phi||^2)``.

The random draws follow the solver's documented defaults, which are
part of its definition: the start vectors of the power iteration on H
are two standard normal draws shaped like the PSFs from a CPU generator
seeded 0 (60 steps); the starlet's is one (S, S) draw from a CPU
generator seeded 0 (30 steps); the noise calibration is an (8, 41, 41)
draw from a CPU generator seeded 1.

``round_state`` makes the control: the carried state is rounded to that
dtype after every iteration (``torch.bfloat16`` for this float32
configuration).  Nothing here imports the port.
"""
from __future__ import annotations

import torch

B3 = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)
NOISE_SHAPE = (8, 41, 41)


def fft_grid(stamp: int) -> int:
    """The smallest 5-smooth integer >= 2 * stamp - 1."""
    m = 2 * stamp - 1
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def psf_spectrum(psfs: torch.Tensor) -> torch.Tensor:
    """The rfft2 of each centred PSF on the padded grid, rolled so that
    its centre sits at the origin."""
    s = psfs.shape[-1]
    g = fft_grid(s)
    padded = psfs.new_zeros(tuple(psfs.shape[:-2]) + (g, g))
    padded[..., :s, :s] = psfs
    padded = torch.roll(padded, (-(s // 2), -(s // 2)), dims=(-2, -1))
    return torch.fft.rfft2(padded)


def convolve(x: torch.Tensor, kf: torch.Tensor, adjoint: bool = False):
    """'Same' convolution of each stamp with its PSF (``adjoint``: the
    correlation)."""
    s = x.shape[-1]
    g = kf.shape[-2]
    k = torch.conj(kf) if adjoint else kf
    out = torch.fft.irfft2(torch.fft.rfft2(x, s=(g, g)) * k, s=(g, g))
    return out[..., :s, :s].contiguous()


def smooth(x: torch.Tensor, j: int) -> torch.Tensor:
    """One B3 a-trous smoothing at hole 2^j, periodic, on the last two
    axes."""
    step = 1 << j
    for dim in (-1, -2):
        x = sum(B3[t] * torch.roll(x, (t - 2) * step, dims=dim)
                for t in range(5))
    return x


def phi(x: torch.Tensor, n_scales: int) -> torch.Tensor:
    """The J detail scales, (J, ...) for an input (...)."""
    out, c = [], x
    for j in range(n_scales):
        c_next = smooth(c, j)
        out.append(c - c_next)
        c = c_next
    return torch.stack(out)


def phi_adjoint(w: torch.Tensor, n_scales: int) -> torch.Tensor:
    """The adjoint of :func:`phi`, term by term."""
    total = torch.zeros_like(w[0])
    for j in range(n_scales):
        v = w[j] - smooth(w[j], j)
        for k in range(j - 1, -1, -1):
            v = smooth(v, k)
        total = total + v
    return total


def _cpu_normal(seed: int, shape) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(tuple(shape), generator=g, dtype=torch.float32)


def norm_H(kf: torch.Tensor, shape, iters: int = 60) -> float:
    """||H|| by the power iteration of the self-adjoint (u, v) ->
    (H^T v, H u), from the default start."""
    g = torch.Generator().manual_seed(0)
    u = torch.randn(tuple(shape), generator=g).to(kf.device)
    v = torch.randn(tuple(shape), generator=g).to(kf.device)
    n0 = torch.sqrt(torch.sum(u * u) + torch.sum(v * v))
    u, v = u / n0, v / n0
    nrm = None
    for _ in range(iters):
        Hu, Htv = convolve(u, kf), convolve(v, kf, adjoint=True)
        nrm = torch.sqrt(torch.sum(Htv * Htv) + torch.sum(Hu * Hu)) + 1e-12
        u, v = Htv / nrm, Hu / nrm
    return float(nrm)


def norm_phi(n_scales: int, stamp: int, device, iters: int = 30) -> float:
    """||Phi|| by the power iteration of Phi^T Phi, from the default
    start."""
    x = _cpu_normal(0, (stamp, stamp)).to(device)
    nrm = None
    for _ in range(iters):
        x2 = phi_adjoint(phi(x, n_scales), n_scales)
        nrm = torch.linalg.vector_norm(x2)
        x = x2 / (nrm + 1e-12)
    return float(torch.sqrt(nrm))


def weights(psfs: torch.Tensor, sigma: float, n_scales: int,
            k_sigma: float) -> torch.Tensor:
    """W, (J, n, 1, 1)."""
    noise = _cpu_normal(1, NOISE_SHAPE).to(psfs.device)
    std = torch.std(phi(noise, n_scales), dim=(1, 2, 3), correction=0)
    energy = torch.sqrt(torch.sum(psfs * psfs, dim=(-2, -1)))
    return ((k_sigma * sigma) * std[:, None] * energy[None, :])[..., None,
                                                                None]


def objective(Y, HX, CX, W) -> torch.Tensor:
    return 0.5 * torch.sum((Y - HX) ** 2) + torch.sum(torch.abs(W * CX))


def solve(Y: torch.Tensor, psfs: torch.Tensor, *, n_scales: int,
          sigma_noise: float, k_sigma: float, iterations: int, chunk: int,
          round_state=None):
    """Run the iteration from the back-projected start for
    ``iterations`` steps.  Returns ``(X, costs)``: the iterate and the
    objective at every chunk's end (and at the last iteration)."""
    Y = Y.to(torch.float32)
    psfs = psfs.to(torch.float32)
    kf = psf_spectrum(psfs)
    nH = norm_H(kf, psfs.shape)
    nL = norm_phi(n_scales, Y.shape[-1], Y.device)
    W = weights(psfs, sigma_noise, n_scales, k_sigma)
    sig = 0.5 / max(nL ** 2, 1e-12)
    tau = 1.0 / (nH ** 2 / 2 + sig * nL ** 2 + 1e-12)

    def keep(t):
        return t if round_state is None else t.to(round_state).to(
            torch.float32)

    X = keep(convolve(Y, kf, adjoint=True))
    HX = keep(convolve(X, kf))
    CX = keep(phi(X, n_scales))
    U = torch.zeros_like(CX)
    costs = []
    for i in range(iterations):
        grad = convolve(HX - Y, kf, adjoint=True)
        X = keep(torch.clamp(X - tau * grad - tau * phi_adjoint(U, n_scales),
                             min=0.0))
        CX_new = keep(phi(X, n_scales))
        U = keep(torch.clamp(U + sig * (2.0 * CX_new - CX), -W, W))
        CX = CX_new
        HX = keep(convolve(X, kf))
        if (i + 1) % chunk == 0 or i == iterations - 1:
            costs.append(float(objective(Y, HX, CX, W)))
    return X, costs
