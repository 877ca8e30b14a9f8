"""Algorithm 2 — Sparse Coupled Dictionary Learning, on one device.
Port of ``repro.imaging.scdl``.

ADMM for Eq. (4): recover coupled low/high-resolution dictionaries
X_l, X_h and shared sparse codes from paired observations S_l, S_h.

  1.   place S_h, S_l sample-major in the bundle          -> build_bundle
  2/3. initialise dictionaries from chosen sample columns -> init_dicts
  4/5. add W_h, W_l and the stacked multipliers YZ         -> same bundle
  6-10. per iteration:
     7. the dictionaries + factor-once solve operators for
        (2 X^T X + (c+c3) I)^-1                           -> replicated
     8. local W / multiplier updates (GEMMs + admm_elwise)
     9. S^T W (P x A), W^T W (A x A) (dict_outer_pair)
    10. damped least-squares dictionary update + column norm clipping

The math is the JAX package's, step for step; the workload is declared
once as :class:`SCDLProblem`, registered under ``"scdl"``.  The ridge
solves and the dictionary update are plain ``torch`` matrix products
and ``torch.linalg`` factorizations, as the JAX package leaves them to
XLA; the two kernels are ``admm_elwise`` and ``dict_outer_pair``.

Differences from the JAX module, each deliberate:

- **Atom choice.** ``init_dicts`` in JAX draws the A initial columns
  with ``jax.random.choice(PRNGKey(3), ...)``, which torch cannot
  reproduce.  Here the chosen columns are an argument (``idx``); without
  it they come from a CPU ``torch.Generator`` seeded 3, the same on
  every device.
- **Cholesky without a host sync.** ``torch.linalg.cholesky`` checks
  its result on the host, which on the card waits for the device;
  ``cholesky_ex`` leaves that check out (the matrices are SPD by
  construction: a ridge or a damping term is always added).
- **Plane-major ``YZ``.** The JAX bundle stacks the multipliers as
  (K, 5, A) and reads ``YZ[:, 3]``/``YZ[:, 4]`` as strided planes, free
  under XLA; a torch matrix product on such a view would copy 82 MB per
  plane per iteration at K = 40 000, A = 512.  The port stores
  (5, K, A), records on axis 1 (``Bundle.record_axes``), so each plane
  is one contiguous block; ``repro_torch.convert`` swaps at the
  boundary.
- The deprecated ``train`` shim is not ported; use ``solve("scdl", ...)``.

Under a mesh (``build_bundle(mesh=)``, ``solve(..., mesh=)``) the atoms
are chosen and the normalizers ``n_h``/``n_l`` taken over all K samples,
as the single solve does; each rank then keeps its block of samples.
The four outer products of step 9 are summed over the mesh's data axes
in one all-reduce, as are the two residuals of the objective, so every
rank computes the same dictionaries and factors from the same sums.

The steps also take a bucket of instances (``solve_many``, which buckets
SCDL instances only with equal K): every leaf with an instance axis in
front (``YZ`` (5, B, K, A)), the ridge products and factorizations
batched, ``admm_elwise`` once over the flattened bucket (its scalars come
from the config), and ``dict_outer_pair`` once per instance: its kernel
computes one instance's products, and at the paper's K one launch fills
the card.  An instance may carry its own atom choice as a trailing dict
of its inputs, ``(S_h, S_l, {"idx": ...})``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batching import BatchAxes
from repro_torch.core.bundle import Bundle
from repro_torch.core.compat import psum_tree
from repro_torch.core.problem import Problem, register
from repro_torch.kernels.admm_elwise.ops import admm_elwise
from repro_torch.kernels.common import resolve_device, to_device
from repro_torch.kernels.dict_outer.ops import dict_outer_pair

# leaves stored plane-major (records on axis 1)
PLANE_MAJOR = ("YZ",)


@dataclass(frozen=True)
class SCDLConfig:
    n_atoms: int = 512             # A
    lam_h: float = 0.01
    lam_l: float = 0.01
    c1: float = 0.4
    c2: float = 0.4
    c3: float = 0.8
    delta: float = 1e-2
    max_iter: int = 100
    tol: float = 0.0               # paper runs to i_max


def _atom_indices(idx, K: int, A: int) -> torch.Tensor:
    """The A chosen sample columns as a CPU int64 tensor, checked."""
    if A > K:
        raise ValueError(f"n_atoms = {A} exceeds the {K} samples: no "
                         f"choice of {A} distinct columns exists")
    if idx is None:
        g = torch.Generator().manual_seed(3)
        return torch.randperm(K, generator=g)[:A]
    idx = idx.cpu() if isinstance(idx, torch.Tensor) else np.array(idx)
    idx = torch.as_tensor(idx, dtype=torch.int64)
    if tuple(idx.shape) != (A,):
        raise ValueError(f"idx must hold n_atoms = {A} column indices, got "
                         f"shape {tuple(idx.shape)}")
    if A and (int(idx.min()) < 0 or int(idx.max()) >= K
              or int(torch.unique(idx).numel()) != A):
        raise ValueError(f"idx must hold {A} distinct indices in [0, {K})")
    return idx


def init_dicts(S_h, S_l, cfg: SCDLConfig, idx=None):
    """Steps 2/3: chosen sample columns -> initial unit-norm dictionaries.

    ``S_h`` (P, K) and ``S_l`` (M, K) are tensors on one device; ``idx``
    (A indices into K) injects the choice, else it is drawn (see the
    module docstring)."""
    cols = _atom_indices(idx, S_h.shape[1], cfg.n_atoms).to(S_h.device)
    X_h = S_h[:, cols]
    X_l = S_l[:, cols]
    X_h = X_h / torch.linalg.norm(X_h, dim=0, keepdim=True).clamp_min(1e-8)
    X_l = X_l / torch.linalg.norm(X_l, dim=0, keepdim=True).clamp_min(1e-8)
    return X_h, X_l


def _cho_solve(G, B):
    """``G^-1 B`` for SPD ``G``, with no host sync (``cholesky_ex``).

    A bucket's (B, n, n) matrices factor in one batched call, and each
    then solves on its own: PyTorch's batched ``cholesky_solve`` on the
    card goes through MAGMA, whose many small launches left a bucket's
    iteration host-bound (``PERF.md``, PR 17)."""
    L = torch.linalg.cholesky_ex(G).L
    if G.dim() == 2:
        return torch.cholesky_solve(B, L)
    B = B.expand(tuple(L.shape[:-2]) + tuple(B.shape[-2:]))
    return torch.stack([torch.cholesky_solve(b, l) for b, l in zip(B, L)])


def _solve_factor(X, c):
    """Factor-once payload for applying ``(2 X^T X + c I)^-1`` (X: (P, A)).

    The Gram is a rank-P update of the ridge, so for P < A the O(.^3)
    work happens on the (P, P) Woodbury companion ``B = c/2 I + X X^T``:

        (2 X^T X + c I)^-1 = (1/c) [I - X^T (c/2 I + X X^T)^-1 X]

    Three regimes, chosen by static shape:

    - ``2P < A`` — *thin apply*: ``{"C": B^-1 X}`` (P, A), applied in
      the bracketed form [4PA flops per sample row].
    - ``P < A <= 2P`` — *dense apply, Woodbury build*: the (A, A)
      inverse ``Gi`` from ``C`` [2A^2 per row].
    - ``P >= A`` — *dense apply, direct build*: Cholesky of the (A, A)
      Gram, solved against the identity.

    Dense payloads also carry ``B2 = 2 X G^-1``, so the per-sample solve
    folds in the right-hand-side assembly: ``w = S B2 + Z G^-1``.
    """
    P, A = X.shape[-2:]

    def eye(n):
        return torch.eye(n, dtype=X.dtype, device=X.device)

    if P < A:
        C = _cho_solve(0.5 * c * eye(P) + X @ X.mT, X)
        if 2 * P < A:
            return {"C": C}
        Gi = (eye(A) - X.mT @ C) / c
    else:
        Gi = _cho_solve(2.0 * X.mT @ X + c * eye(A), eye(A))
    return {"Gi": Gi, "B2": 2.0 * X @ Gi}


def _ridge_solve(S, Z, X, F, c):
    """Row-wise solve ``(2 X^T X + c I) w = 2 S @ X + Z`` with the
    factor ``F`` from :func:`_solve_factor` — matrix products only."""
    if "Gi" in F:
        return S @ F["B2"] + Z @ F["Gi"]
    rhs = 2.0 * (S @ X) + Z
    return (rhs - (rhs @ X.mT) @ F["C"]) / c


def broadcast_factors(Xh, Xl, cfg: SCDLConfig):
    """Step 7's broadcast payload: the dictionaries plus the factor-once
    solve operators for the W ridge systems."""
    return {"Xh": Xh, "Xl": Xl,
            "Fh": _solve_factor(Xh, cfg.c1 + cfg.c3),
            "Fl": _solve_factor(Xl, cfg.c2 + cfg.c3)}


def build_bundle(S_h, S_l, cfg: SCDLConfig, *, device=None,
                 idx=None, mesh=None) -> Bundle:
    """Steps 1-5: the sample-major bundle on ``device`` (``None`` =
    ``"cuda"``).  ``S_h`` (P, K) and ``S_l`` (M, K) are numpy arrays or
    tensors, in the JAX layout.

    Data: ``Sh`` (K, P), ``Sl`` (K, M), ``Wh``/``Wl`` (K, A) and the
    plane-major multipliers ``YZ`` (5, K, A).  Replicated: the
    dictionaries, their solve factors ``Fh``/``Fl`` (dicts) and the
    constant objective normalizers ``n_h``/``n_l`` = ||S||^2 (0-d fp32
    device tensors).  With ``mesh`` the bundle keeps this rank's block
    of the samples, everything else computed from all of them."""
    dev = resolve_device(device)
    S_h = to_device(S_h, dev)
    S_l = to_device(S_l, dev)
    X_h, X_l = init_dicts(S_h, S_l, cfg, idx)
    A = cfg.n_atoms
    K = S_h.shape[1]
    zeros = dict(dtype=S_h.dtype, device=dev)
    data = {
        "Sh": S_h.T.contiguous(), "Sl": S_l.T.contiguous(),
        "Wh": torch.zeros((K, A), **zeros),
        "Wl": torch.zeros((K, A), **zeros),
        # stacked multiplier state [Y1, Y2, Y3, Z1, Z2], plane-major
        "YZ": torch.zeros((5, K, A), **zeros),
    }
    replicated = dict(broadcast_factors(X_h, X_l, cfg),
                      n_h=torch.sum(S_h.to(torch.float32) ** 2),
                      n_l=torch.sum(S_l.to(torch.float32) ** 2))
    return Bundle.create(data, replicated=replicated, device=dev,
                         record_axes={k: 1 for k in PLANE_MAJOR}, mesh=mesh)


def _code_updates(d, rep, cfg: SCDLConfig):
    """Step 8: the two ridge solves against the broadcast factors, then
    the soft-threshold and three dual steps in one ``admm_elwise``
    pass."""
    c1, c2, c3 = cfg.c1, cfg.c2, cfg.c3
    YZ = d["YZ"]
    Wh = _ridge_solve(d["Sh"], YZ[3], rep["Xh"], rep["Fh"], c1 + c3)
    Wl = _ridge_solve(d["Sl"], YZ[4] + c3 * Wh, rep["Xl"], rep["Fl"],
                      c2 + c3)
    # a bucket runs as one flat (5, B K, A) pass: the scalars are shared
    A = Wh.shape[-1]
    YZ = admm_elwise(Wh.reshape(-1, A), Wl.reshape(-1, A),
                     YZ.reshape(5, -1, A), c1=c1, c2=c2, c3=c3,
                     t1=cfg.lam_h / c1, t2=cfg.lam_l / c2).reshape(YZ.shape)
    return dict(d, Wh=Wh, Wl=Wl, YZ=YZ)


def _outer_products(d, axes):
    """Step 9: S^T W and W^T W of both pairs, one ``dict_outer_pair``
    launch (one per instance of a bucket), summed over ``axes`` in one
    all-reduce."""
    keys = ("ShWh", "SlWl", "phi_h", "phi_l")
    operands = (d["Sh"], d["Sl"], d["Wh"], d["Wl"])
    if d["Sh"].dim() == 2:
        return psum_tree(dict(zip(keys, dict_outer_pair(*operands))), axes)
    lanes = [dict_outer_pair(*(x[b] for x in operands))
             for b in range(d["Sh"].shape[0])]
    return {k: torch.stack([lane[i] for lane in lanes])
            for i, k in enumerate(keys)}


def _dict_update(rep, outer, cfg: SCDLConfig):
    """Step 10 / Eq. (6-7): damped least-squares dictionary update
    ``X = (S W^T)(phi + delta I)^-1`` through Cholesky (phi + delta I is
    SPD), then unit-norm column clipping."""
    A = rep["Xh"].shape[-1]
    dt = rep["Xh"].dtype
    eye = torch.eye(A, dtype=dt, device=rep["Xh"].device)

    def update(phi, SW):
        X = _cho_solve(phi.to(dt) + cfg.delta * eye, SW.mT.to(dt)).mT
        X = X / torch.linalg.norm(X, dim=-2, keepdim=True).clamp_min(1.0)
        return X.contiguous()

    return {"Xh": update(outer["phi_h"], outer["ShWh"]),
            "Xl": update(outer["phi_l"], outer["SlWl"])}


def _iterate(d, rep, axes, cfg: SCDLConfig):
    """Steps 8-10 minus the objective: the shared body of the full and
    cost-free step variants."""
    d = _code_updates(d, rep, cfg)
    return d, _dict_update(rep, _outer_products(d, axes), cfg)


def _nrmse(d, rep, Xh, Xl, axes):
    """The paper's Fig. 14 metric: reconstruction error of the
    dictionaries, as 0-d device tensors (the residuals summed over
    ``axes``)."""
    res = psum_tree({
        "h": torch.sum((d["Sh"] - d["Wh"] @ Xh.mT) ** 2, dim=(-2, -1)),
        "l": torch.sum((d["Sl"] - d["Wl"] @ Xl.mT) ** 2, dim=(-2, -1))},
        axes)
    nrmse_h = torch.sqrt(res["h"] / (rep["n_h"] + 1e-12))
    nrmse_l = torch.sqrt(res["l"] / (rep["n_l"] + 1e-12))
    return {"cost": 0.5 * (nrmse_h + nrmse_l),
            "nrmse_h": nrmse_h, "nrmse_l": nrmse_l}


def make_step_fn(cfg: SCDLConfig):
    """One full ADMM iteration (steps 7-10) with its objective.

    Returns ``(data', {"cost", "nrmse_h", "nrmse_l", "Xh", "Xl"})``: the
    new dictionaries ride in the output and :func:`make_refresh_fn`
    folds them (and their solve factors) into the replicated side."""

    def step(d, rep, axes):
        d, new = _iterate(d, rep, axes, cfg)
        return d, {**_nrmse(d, rep, new["Xh"], new["Xl"], axes), **new}

    return step


def make_light_step_fn(cfg: SCDLConfig):
    """The same iteration without the objective: ``(data', {"Xh",
    "Xl"})``, so the dictionaries still advance every iteration."""

    def step(d, rep, axes):
        return _iterate(d, rep, axes, cfg)

    return step


def make_cost_fn(cfg: SCDLConfig):
    """The NRMSE objective of the post-iteration state (the per-chunk
    cost mode): the refreshed replicated side holds the iteration's
    dictionaries."""

    def cost(d, rep, axes):
        return _nrmse(d, rep, rep["Xh"], rep["Xl"], axes)

    return cost


def make_refresh_fn(cfg: SCDLConfig):
    """Step 7's per-iteration broadcast: fold the new dictionaries into
    the replicated side with their factor-once solve operators."""

    def refresh(rep, out):
        return dict(rep, **broadcast_factors(out["Xh"], out["Xl"], cfg))

    return refresh


@register("scdl")
class SCDLProblem(Problem):
    """Algorithm 2, declared once.

    The dictionaries and their solve factors are part of the iterate:
    ``replicated_in_carry`` makes the driver advance the replicated side
    on every iteration, and the declared ``cost`` enables
    ``cost_every="chunk"``.  ``idx`` injects the initial atom columns
    (see :func:`init_dicts`).
    """

    replicated_in_carry = True
    batched_steps = True

    def __init__(self, cfg: Optional[SCDLConfig] = None, *, idx=None):
        self.cfg = cfg if cfg is not None else SCDLConfig()
        self.idx = idx
        self._step = make_step_fn(self.cfg)
        self._light = make_light_step_fn(self.cfg)
        self._cost = make_cost_fn(self.cfg)
        self._refresh = make_refresh_fn(self.cfg)

    def init_bundle(self, inputs, device, mesh=None) -> Bundle:
        S_h, S_l, *rest = inputs
        idx = self.idx
        if rest:
            (own,) = rest
            if set(own) - {"idx"}:
                raise ValueError(f"unknown draws {sorted(set(own) - {'idx'})}"
                                 f"; an instance may carry ('idx',)")
            idx = own.get("idx", idx)
        return build_bundle(S_h, S_l, self.cfg, device=device, idx=idx,
                            mesh=mesh)

    def full_step(self, d, rep, axes):
        return self._step(d, rep, axes)

    def light_step(self, d, rep, axes):
        return self._light(d, rep, axes)

    def cost(self, d, rep, axes):
        return self._cost(d, rep, axes)

    def refresh_replicated(self, rep, out):
        return self._refresh(rep, out)

    def finalize(self, bundle, log) -> Tuple[Tuple[np.ndarray, np.ndarray],
                                             dict]:
        rep = bundle.replicated
        return (rep["Xh"].detach().cpu().numpy(),
                rep["Xl"].detach().cpu().numpy()), {}

    def batch_axes(self):
        # samples live on axis 1 of the raw (P, K)/(M, K) patch matrices,
        # an instance's own atom choice (a trailing dict) has none;
        # no record padding (the dictionaries are sensitive to the
        # reduction's grouping), and the injected atom choice is shared
        # by declaration
        return BatchAxes(record_axes=(1, 1, None), pad_records=False,
                         instance_invariant=("idx",))
