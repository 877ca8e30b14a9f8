"""Condat primal-dual splitting for space-variant deconvolution
(Eq. 2/3).  Port of ``repro.imaging.condat``:

  sparse  : min_X  0.5||Y - H(X)||_F^2 + ||W o Phi(X)||_1   s.t. X >= 0
  lowrank : min_X  0.5||Y - H(X)||_F^2 + lam ||X||_*        s.t. X >= 0

The per-record pieces here are reused unchanged by
``imaging/deconvolve.py``.  Each iteration runs one forward and one
adjoint spectral multiply (H(X) carried).  In sparse mode it also runs
one starlet forward (Phi(X) carried, so the over-relaxed dual input is
2 Phi(X_new) - Phi(X)) and one starlet adjoint, with the elementwise
tails in the fused ``kernels/condat_elwise`` passes; in low-rank mode
(L = I) the primal pass also writes X_bar, and the dual update is an SVT.

Step sizes are computed once on the host, exactly as the JAX module
does (``float(spectral_norm)`` -> :func:`step_sizes`); the solvers then
hold them as 0-d fp32 device tensors, so no iteration syncs to the host.

Every per-record piece also takes a bucket of instances (``solve_many``):
stamps (B, n, S, S), the dual stack (J, B, n, S, S) — the same memory as
the (J, B * n, S, S) stack the starlet kernels write — and step sizes of
shape (B,), one per instance; the objectives then reduce per instance to
(B,).

Random draws are a seam: the operator norms and the noise calibration
take their draws as ``u0=``/``v0=`` (PSF power iteration), ``x0=``
(starlet power iteration) and ``noise=`` (noise calibration); low-rank
mode needs only ``u0``/``v0``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.imaging import lowrank as lr
from repro_torch.imaging import psf as psf_op
from repro_torch.imaging import starlet
from repro_torch.kernels.common import resolve_device, to_device
from repro_torch.kernels.condat_elwise.ops import condat_dual, condat_primal
from repro_torch.kernels.starlet2d import ops as starlet_batch


@dataclass(frozen=True)
class SolverConfig:
    mode: str = "sparse"            # sparse | lowrank
    n_scales: int = 4
    lam: float = 0.1                # low-rank threshold
    k_sigma: float = 3.0            # sparse threshold in noise sigmas
    tau: float = 0.0                # 0 -> derived from operator norms
    sigma_dual: float = 0.0
    rank: int = 32                  # randomized-SVT rank (low rank)
    max_iter: int = 300
    tol: float = 1e-4


class SolverState(NamedTuple):
    """The sequential solver's state, with the JAX module's fields."""
    X: torch.Tensor                 # primal    (n, S, S)
    U: torch.Tensor                 # dual      (sparse: (J, n, S, S); lowrank: (n, S, S))
    HX: torch.Tensor                # carried H(X)        (n, S, S)
    CX: torch.Tensor                # carried Phi(X)      (J, n, S, S); () in lowrank
    cost: torch.Tensor              # scalar


MODES = ("sparse", "lowrank")


def check_mode(cfg: SolverConfig) -> None:
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}; expected one of "
                         f"{MODES}")


# ---------------------------------------------------------------------
# Per-record pieces (used unchanged by imaging/deconvolve.py)
# ---------------------------------------------------------------------

def grad_data(X, Y, psfs):
    """grad of 0.5||Y - H(X)||^2 = H^T(H(X) - Y), one-shot (loops carry
    H(X) and use :func:`grad_from_HX`)."""
    return psf_op.Ht(psf_op.H(X, psfs) - Y, psfs)


def grad_from_HX(HX, Y, kf_pair):
    """grad of 0.5||Y - H(X)||^2 = H^T(H(X) - Y), off the carried H(X)
    and the precomputed conjugate spectrum (the difference formed as the
    carried H(X) is read)."""
    return psf_op.Ht_fp_diff(HX, Y, kf_pair)


def data_cost_from(HX, Y):
    """0.5||Y - H(X)||_F^2 off the carried forward model, per instance
    when the stamps carry an instance axis."""
    return 0.5 * torch.sum((Y - HX) ** 2, dim=(-3, -2, -1))


def data_cost(X, Y, psfs):
    """0.5||Y - H(X)||_F^2, one-shot (per instance, as
    :func:`data_cost_from`)."""
    return data_cost_from(psf_op.H(X, psfs), Y)


def per_instance(v, like):
    """A step size, 0-d or one per instance (B,), shaped to broadcast
    against ``like``, whose leading axis is the instance axis."""
    if v.dim() == 0:
        return v
    return v.reshape(tuple(v.shape) + (1,) * (like.dim() - v.dim()))


def weight_matrix(psfs, sigma: float, n_scales: int, k_sigma: float, *,
                  noise=None):
    """W^(k): per-scale noise-adaptive thresholds, (J, n, 1, 1).

    ``noise`` is the (8, 41, 41) Monte-Carlo draw of
    ``starlet.noise_std_scales``, which calibrates at its default 41x41
    shape whatever the stamp size, as the JAX module does."""
    scale_std = starlet.noise_std_scales(n_scales, noise=noise,
                                         device=psfs.device)     # (J,)
    psf_energy = torch.sqrt(torch.sum(psfs ** 2, dim=(-2, -1)))  # (n,)
    w = (k_sigma * sigma) * scale_std[:, None] * psf_energy[None, :]
    return w[:, :, None, None]


def sparse_dual_update(U, CX_new, CX, W, sig):
    """Clamp U + sig Phi(X_bar) to [-W, W], with Phi(X_bar) formed as
    2 CX_new - CX — one fused pass (``kernels/condat_elwise``)."""
    return condat_dual(U, CX_new, CX, W, sig)


def sparse_dual_adjoint(U, n_scales):
    """Batched Phi^T over the dual stack: (J, n, S, S) -> (n, S, S), or
    (J, B, n, S, S) -> (B, n, S, S) (one launch over all B n stamps)."""
    s = tuple(U.shape[-2:])
    out = starlet_batch.adjoint(U.reshape((U.shape[0], -1) + s), n_scales)
    return out.reshape(tuple(U.shape[1:]))


def sparse_forward(X, n_scales):
    """Batched Phi of the stamps: (n, S, S) -> (J, n, S, S), or
    (B, n, S, S) -> (J, B, n, S, S) (one launch over all B n stamps)."""
    s = tuple(X.shape[-2:])
    out = starlet_batch.forward(X.reshape((-1,) + s), n_scales)
    return out.reshape((n_scales,) + tuple(X.shape))


def primal_update(X, U_adj, grad, tau):
    """Fused gradient step + positivity prox (one elementwise pass)."""
    return condat_primal(X, U_adj, grad, tau)


def sparse_reg_cost(CX, W):
    """||W o Phi(X)||_1 off the carried coefficient stack, per instance
    when it carries an instance axis."""
    return torch.sum(torch.abs(W * CX), dim=(0, -3, -2, -1))


def step_sizes(Y, psfs, cfg: SolverConfig, sigma_noise: float,
               kf_pair=None, *, u0=None, v0=None, x0=None, noise=None):
    """Condat step sizes from operator norms: 1/tau - sig ||L||^2 >= b/2.
    Host floats, as in the JAX module; returns (tau, sig, W).  Low-rank
    mode has L = I: ||L|| = 1 and no weights (``W`` is ``None``)."""
    check_mode(cfg)
    norm_H = psf_op.spectral_norm(psfs, kf_pair=kf_pair, u0=u0, v0=v0)
    if cfg.mode == "sparse":
        norm_L = starlet.spectral_norm(cfg.n_scales, tuple(Y.shape[-2:]),
                                       x0=x0, device=Y.device)
        W = weight_matrix(psfs, sigma_noise, cfg.n_scales, cfg.k_sigma,
                          noise=noise)
    else:
        norm_L, W = 1.0, None
    sig = cfg.sigma_dual or 0.5 / max(norm_L ** 2, 1e-12)
    tau = cfg.tau or 1.0 / (norm_H ** 2 / 2 + sig * norm_L ** 2 + 1e-12)
    return tau, sig, W


# ---------------------------------------------------------------------
# Sequential solver
# ---------------------------------------------------------------------

def solve(Y, psfs, cfg: SolverConfig, sigma_noise: float = 0.02,
          n_iter: Optional[int] = None, cost_every: int = 1, *,
          device=None, u0=None, v0=None, x0=None, noise=None):
    """Run the sequential solver; returns (X*, cost history).

    ``cost_every``: evaluate the objective (a weighted reduction of the
    carried starlet stack in sparse mode, an SVD in low-rank mode) only
    every k-th iteration; skipped entries carry the last evaluated value
    forward (+inf before the first).  The history is a (n_iter,) tensor
    on the device.  In sparse mode the loop never syncs to the host.
    Low-rank mode is the exact reference: its SVT and its objective go
    through ``torch.linalg.svd``, which on the card waits for the device
    (once an iteration, twice on an objective's iteration); the chunked
    ``solve("deconvolve", ...)`` is the path that does not.
    """
    check_mode(cfg)
    dev = resolve_device(device)
    Y = to_device(Y, dev)
    psfs = to_device(psfs, dev)
    n_iter = n_iter or cfg.max_iter
    cost_every = max(int(cost_every), 1)
    sparse = cfg.mode == "sparse"
    kf_pair = psf_op.psf_fft_pair(psfs)
    tau, sig, W = step_sizes(Y, psfs, cfg, sigma_noise, kf_pair=kf_pair,
                             u0=u0, v0=v0, x0=x0, noise=noise)
    tau = torch.tensor(tau, dtype=torch.float32, device=dev)
    sig = torch.tensor(sig, dtype=torch.float32, device=dev)
    X = psf_op.Ht_fp(Y, kf_pair)
    HX = psf_op.H_fp(X, kf_pair)
    if sparse:
        U = torch.zeros((cfg.n_scales,) + tuple(Y.shape), device=dev)
        CX = starlet_batch.forward(X, cfg.n_scales)
    else:
        U = torch.zeros_like(Y)
    cost = torch.tensor(float("inf"), device=dev)
    costs = []
    for i in range(n_iter):
        grad = grad_from_HX(HX, Y, kf_pair)
        if sparse:
            U_adj = sparse_dual_adjoint(U, cfg.n_scales)
            X = primal_update(X, U_adj, grad, tau)
            CX_new = starlet_batch.forward(X, cfg.n_scales)
            U = sparse_dual_update(U, CX_new, CX, W, sig)
            CX = CX_new
        else:
            X, X_bar = condat_primal(X, U, grad, tau, with_xbar=True)
            V = U + sig * X_bar
            flat = (V / sig).reshape(V.shape[0], -1)
            U = V - sig * lr.svt(flat, cfg.lam / sig).reshape(V.shape)
        HX = psf_op.H_fp(X, kf_pair)
        if i % cost_every == 0:
            if sparse:
                cost = data_cost_from(HX, Y) + sparse_reg_cost(CX, W)
            else:
                s = torch.linalg.svdvals(X.reshape(X.shape[0], -1))
                cost = data_cost_from(HX, Y) + cfg.lam * torch.sum(s)
        costs.append(cost)
    return X, torch.stack(costs)
