"""Algorithm 1 — space-variant PSF deconvolution on one device, in
sparse or low-rank mode.  Port of ``repro.imaging.deconvolve``.

  1. initialise X_p, X_d; extract H            -> Ht warm start
  2. place Y, PSF, X_p, X_d in the bundle      -> Bundle.create
  3. sparse: map PSF -> W^(k)                  -> weights in the bundle
  6-11. iterate: update + cost                 -> chunked IterativeDriver
        (low rank: the randomized SVT of ``imaging/lowrank.py``, its
        small factorizations in the Jacobi kernels, so a chunk still
        holds one host sync)
  12. return X_p*                              -> finalize

The per-record math comes from ``imaging/condat.py`` unchanged.  The
workload is declared once as :class:`DeconvolutionProblem`, registered
under ``"deconvolve"``; run it with ``repro_torch.core.problem.solve``
(:func:`deconvolve` is the JAX package's deprecated shim over it).

Bundle layout: the JAX bundle keeps every leaf record-major and swaps
the per-scale leaves (``W``, ``Xd``, ``CX``) to scale-major inside every
iteration, which XLA makes free.  In PyTorch that swap is a copy of the
269 MB dual stack per leaf per iteration (or a non-contiguous view the
kernels refuse), so this bundle stores those three leaves scale-major,
(J, n, ...), with records on axis 1 (``Bundle.record_axes``).
``repro_torch.convert`` swaps them when state crosses packages.  In
low-rank mode the dual ``Xd`` has no scale axis: it is (n, S, S),
record-major, in both packages, beside the test matrix ``omega`` in
``replicated``.

Under a mesh (``build_bundle(mesh=)``, ``solve(..., mesh=)``) the step
sizes, the weights and the starting point come from the full stamps, as
the single solve computes them; each rank then keeps its block of stamps
(the scale-major leaves cut on axis 1) and the objective is summed over
the mesh's data axes, as are the low-rank range finder's two products
(``imaging/lowrank.py``).

A bucket of ``solve_many`` stacks each leaf at its record axis: stamps
(B, n, S, S), the scale-major leaves (J, B, n, S, S), which is the
(J, B * n, S, S) stack Phi writes over all of a bucket's stamps, so the
dual kernel reads it with no copy.  The steps below take either: each
iteration is one Phi, one Phi^T, one primal and one dual launch for the
whole bucket, with tau and sig one per instance.  An instance may carry
its own random draws as a trailing dict of its inputs, ``(Y, psfs,
{"u0": ..., "v0": ..., "x0": ..., "noise": ...})``; it overrides the
constructor's.
"""
from __future__ import annotations

import warnings
from contextlib import nullcontext
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batching import BatchAxes
from repro_torch.core.bundle import Bundle, gather_leaf
from repro_torch.core.compat import psum
from repro_torch.core.problem import Problem, register, solve
from repro_torch.core.spans import span
from repro_torch.imaging import lowrank as lr
from repro_torch.imaging import psf as psf_op
from repro_torch.imaging.condat import (SolverConfig, check_mode,
                                        data_cost_from, grad_from_HX,
                                        per_instance, primal_update,
                                        sparse_dual_adjoint,
                                        sparse_dual_update, sparse_forward,
                                        sparse_reg_cost, step_sizes)
from repro_torch.kernels.common import resolve_device, to_device
from repro_torch.kernels.condat_elwise.ops import condat_primal
from repro_torch.kernels.starlet2d import ops as starlet_batch

# per-scale leaves of sparse mode, stored scale-major (records on axis 1)
SCALE_MAJOR = ("W", "Xd", "CX")


def scale_major(data) -> tuple:
    """The leaves of ``data`` stored scale-major: the per-scale leaves of
    a sparse bundle, which carries ``CX`` beside its dual.  A low-rank
    bundle has neither ``CX`` nor ``W``, and its ``Xd`` is record-major."""
    return SCALE_MAJOR if "CX" in data else ()


def build_bundle(Y, psfs, cfg: SolverConfig, *, device=None,
                 sigma_noise: float = 0.02, u0=None, v0=None, x0=None,
                 noise=None, omega=None, mesh=None
                 ) -> Tuple[Bundle, dict]:
    """Steps 1-5: place the inputs and derived state in the bundle.

    Beyond the paper's arrays the bundle carries ``psf_fp`` (the
    (kf, conj kf) spectrum pair), ``HX`` (H of the current primal) and,
    in sparse mode, ``CX`` (Phi of the current primal), so each
    iteration runs one convolution each way and one starlet forward.
    The step sizes are host floats (returned) and 0-d fp32 device
    tensors (``replicated``).  ``u0``/``v0``/``x0``/``noise`` are the
    random draws of the operator norms and the noise calibration (see
    ``condat.step_sizes``); ``omega`` is low-rank mode's (S*S, rank +
    ``lowrank.OVERSAMPLE``) test matrix (see ``imaging/lowrank.py``).
    With ``mesh`` every quantity is computed from all the stamps first,
    then the bundle keeps this rank's block of them.
    """
    check_mode(cfg)
    dev = resolve_device(device)
    Y = to_device(Y, dev)
    psfs = to_device(psfs, dev)
    kf_pair = psf_op.psf_fft_pair(psfs)
    tau, sig, W = step_sizes(Y, psfs, cfg, sigma_noise, kf_pair=kf_pair,
                             u0=u0, v0=v0, x0=x0, noise=noise)
    X0 = psf_op.Ht_fp(Y, kf_pair)
    data = {"Y": Y, "psf_fp": kf_pair, "Xp": X0,
            "HX": psf_op.H_fp(X0, kf_pair)}
    replicated = {"tau": torch.tensor(tau, dtype=torch.float32),
                  "sig": torch.tensor(sig, dtype=torch.float32)}
    if cfg.mode == "sparse":
        data["W"] = W                                         # (J, n, 1, 1)
        data["Xd"] = torch.zeros((cfg.n_scales,) + tuple(Y.shape),
                                 dtype=torch.float32, device=dev)
        data["CX"] = starlet_batch.forward(X0, cfg.n_scales)  # (J, n, S, S)
    else:
        data["Xd"] = torch.zeros_like(Y)                      # (n, S, S)
        # the default test matrix is a host draw, like the norms' starts
        with span("deconvolve.draws") if omega is None else nullcontext():
            replicated["omega"] = lr.resolve_omega(
                omega, Y.shape[-1] * Y.shape[-2], cfg.rank, lr.OVERSAMPLE,
                dev)
    bundle = Bundle.create(data, replicated=replicated, device=dev,
                           record_axes={k: 1 for k in scale_major(data)},
                           mesh=mesh)
    return bundle, {"tau": tau, "sig": sig}


def _sparse_update(d, rep, cfg: SolverConfig):
    """Steps 7-8 (sparse): primal + dual updates, no cost.  Returns the
    new data plus the (W, CX_new) the objective reuses."""
    U, W, CX = d["Xd"], d["W"], d["CX"]               # (J, n, ...)
    U_adj = sparse_dual_adjoint(U, cfg.n_scales)
    grad = grad_from_HX(d["HX"], d["Y"], d["psf_fp"])
    X_new = primal_update(d["Xp"], U_adj, grad, rep["tau"])
    CX_new = sparse_forward(X_new, cfg.n_scales)
    U_new = sparse_dual_update(U, CX_new, CX, W, rep["sig"])
    return dict(d, Xp=X_new, Xd=U_new, CX=CX_new,
                HX=psf_op.H_fp(X_new, d["psf_fp"])), (W, CX_new)


def _lowrank_update(d, rep, axes, cfg: SolverConfig):
    """Steps 7-8 (low rank): the primal pass with X_bar, then the dual
    update U + sig X_bar - sig SVT((U + sig X_bar) / sig, lam / sig)
    through the randomized SVT."""
    U, sig = d["Xd"], rep["sig"]
    grad = grad_from_HX(d["HX"], d["Y"], d["psf_fp"])
    X_new, X_bar = condat_primal(d["Xp"], U, grad, rep["tau"],
                                 with_xbar=True)
    s = per_instance(sig, U)
    V = U + s * X_bar
    flat = (V / s).reshape(tuple(V.shape[:-2]) + (-1,))
    svt_flat = lr.randomized_svt_local(flat, rep["omega"], cfg.lam / sig,
                                       axes=axes)
    U_new = V - s * svt_flat.reshape(V.shape)
    return dict(d, Xp=X_new, Xd=U_new, HX=psf_op.H_fp(X_new, d["psf_fp"]))


def _nuclear(d, rep, axes):
    """The range finder's nuclear norm of the primal."""
    X = d["Xp"]
    return lr.nuclear_norm_rf(X.reshape(tuple(X.shape[:-2]) + (-1,)),
                              rep["omega"], axes)


def make_step_fn(cfg: SolverConfig):
    """One iteration with its objective (steps 7-9)."""
    check_mode(cfg)

    def step(d, rep, axes):
        if cfg.mode == "sparse":
            d_new, (W, CX_new) = _sparse_update(d, rep, cfg)
            cost = data_cost_from(d_new["HX"], d["Y"]) + \
                sparse_reg_cost(CX_new, W)
            return d_new, {"cost": psum(cost, axes)}
        d_new = _lowrank_update(d, rep, axes, cfg)
        return d_new, {"cost": psum(data_cost_from(d_new["HX"], d["Y"]), axes)
                       + cfg.lam * _nuclear(d_new, rep, axes)}

    return step


def make_light_step_fn(cfg: SolverConfig):
    """The same iteration without the objective (``cost_every`` > 1):
    no reduction in sparse mode, no Gram eigendecomposition in low-rank
    mode."""
    check_mode(cfg)

    def step(d, rep, axes):
        if cfg.mode == "sparse":
            return _sparse_update(d, rep, cfg)[0]
        return _lowrank_update(d, rep, axes, cfg)

    return step


def make_cost_fn(cfg: SolverConfig):
    """The objective of the post-iteration state (``cost_every="chunk"``):
    in sparse mode the carried CX is Phi(Xp), so it is a weighted
    reduction with no transform at all; in low-rank mode the data term
    off the carried HX plus the range finder's nuclear norm."""
    check_mode(cfg)

    def cost(d, rep, axes):
        data_part = data_cost_from(d["HX"], d["Y"])
        if cfg.mode == "sparse":
            return {"cost": psum(data_part + sparse_reg_cost(d["CX"], d["W"]),
                                 axes)}
        return {"cost": psum(data_part, axes)
                + cfg.lam * _nuclear(d, rep, axes)}

    return cost


@register("deconvolve")
class DeconvolutionProblem(Problem):
    """Algorithm 1, declared once.

    ``cfg.mode`` selects the regulariser: ``"sparse"`` (starlet + noise-
    adaptive weights) or ``"lowrank"`` (the randomized SVT).
    ``u0``/``v0``/``x0``/``noise`` inject the random draws of the
    operator norms and the noise calibration, ``omega`` low-rank mode's
    test matrix (the JAX package draws them from fixed ``PRNGKey``s that
    torch cannot reproduce); left ``None``, they come from seeded CPU
    ``torch.Generator``s.  A trailing dict of the inputs overrides
    ``u0``/``v0``/``x0``/``noise`` for that instance.
    """

    batched_steps = True

    def __init__(self, cfg: Optional[SolverConfig] = None,
                 sigma_noise: float = 0.02, *, u0=None, v0=None, x0=None,
                 noise=None, omega=None):
        self.cfg = cfg if cfg is not None else SolverConfig()
        check_mode(self.cfg)
        self.sigma_noise = sigma_noise
        self.u0, self.v0, self.x0, self.noise = u0, v0, x0, noise
        self.omega = omega
        self._step = make_step_fn(self.cfg)
        self._light = make_light_step_fn(self.cfg)
        self._cost = make_cost_fn(self.cfg)

    def init_bundle(self, inputs, device, mesh=None) -> Bundle:
        Y, psfs, *rest = inputs
        draws = {"u0": self.u0, "v0": self.v0, "x0": self.x0,
                 "noise": self.noise}
        if rest:
            (own,) = rest
            unknown = set(own) - set(draws)
            if unknown:
                raise ValueError(f"unknown draws {sorted(unknown)}; an "
                                 f"instance may carry {sorted(draws)}")
            draws.update(own)
        bundle, _ = build_bundle(Y, psfs, self.cfg, device=device,
                                 sigma_noise=self.sigma_noise,
                                 omega=self.omega, mesh=mesh, **draws)
        return bundle

    def full_step(self, d, rep, axes):
        return self._step(d, rep, axes)

    def light_step(self, d, rep, axes):
        return self._light(d, rep, axes)

    def cost(self, d, rep, axes):
        return self._cost(d, rep, axes)

    def finalize(self, bundle, log) -> Tuple[np.ndarray, dict]:
        return gather_leaf(bundle, "Xp"), {}

    def batch_axes(self):
        # (Y, psfs) are both stamp-major, an instance's own draws (a
        # trailing dict) carry no records; the test matrix depends only on
        # the config (or the injected draw) and is shared across a
        # bucket; the noise level and the constructor's draws are shared
        # by declaration
        shared = ("omega",) if self.cfg.mode == "lowrank" else ()
        return BatchAxes(record_axes=(0, 0, None), shared_in_batch=shared,
                         instance_invariant=("sigma_noise", "u0", "v0",
                                             "x0", "noise", "omega"))


def deconvolve(Y, psfs, cfg: SolverConfig, mesh=None,
               sigma_noise: float = 0.02, max_iter: Optional[int] = None,
               tol: Optional[float] = None, chunk: int = 8, cost_every=1,
               *, device=None, **draws):
    """End-to-end Algorithm 1.  Returns (X*, the driver's log).

    .. deprecated::
        Thin shim over ``solve(DeconvolutionProblem(cfg, sigma_noise,
        **draws), Y, psfs, ...)``, bit for bit; use the ``solve()`` entry
        point.  ``draws`` are the constructor's random draws (``u0``,
        ``v0``, ``x0``, ``noise``, ``omega``), ``device`` the port's
        placement (``None`` = ``"cuda"``).
    """
    warnings.warn(
        "deconvolve(...) is deprecated; use repro_torch.core.problem.solve("
        '"deconvolve", Y, psfs, cfg=cfg, ...)', DeprecationWarning,
        stacklevel=2)
    sol = solve(DeconvolutionProblem(cfg, sigma_noise=sigma_noise, **draws),
                Y, psfs, device=device, mesh=mesh, max_iter=max_iter,
                tol=tol, chunk=chunk, cost_every=cost_every)
    return sol.x, sol.log
