"""Plain reference of sparse coupled dictionary learning (SCDL,
arXiv:1809.05956, use case (b), Algorithm 2), written from the
algorithm's definition in plain PyTorch.

ADMM on the coupled problem: with patch matrices S_h (P, K) and S_l
(M, K), dictionaries X_h (P, A), X_l (M, A), codes W_h, W_l (K, A),
multipliers Y1, Y2, Y3 and the right-hand sides Z1, Z2, every
iteration

    W_h = (2 S_h^T X_h + Z1) (2 X_h^T X_h + (c1 + c3) I)^-1
    W_l = (2 S_l^T X_l + Z2 + c3 W_h) (2 X_l^T X_l + (c2 + c3) I)^-1
    P   = soft(W_h - Y1 / c1, lam_h / c1),  Q = soft(W_l - Y2 / c2, lam_l / c2)
    Y1 += c1 (P - W_h),  Y2 += c2 (Q - W_l),  Y3 += c3 (W_h - W_l)
    Z1  = c1 P + Y1 - Y3 + c3 W_l,  Z2 = c2 Q + Y2 + Y3
    X_h = (S_h W_h) (W_h^T W_h + delta I)^-1, each column divided by
          max(its norm, 1); X_l likewise

and the objective is the mean of the two normalized reconstruction
errors ``sqrt(||S - X W^T||^2 / ||S||^2)``.  The linear systems are
solved by LU (``torch.linalg.solve``), with no Woodbury identity and no
Cholesky factor.

The initial dictionaries are the sample columns of the solver's
documented default choice (the first A of a permutation of the K
samples from a CPU generator seeded 3), each scaled to unit norm.

``matmul`` makes the control: ``"tf32"`` rounds both operands of every
matrix product to TF32 (10 mantissa bits, round to nearest), the
precision the card's tensor cores would use for this float32
configuration with TF32 on.  Nothing here imports the port.
"""
from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def default_atoms(K: int, A: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(3)
    return torch.randperm(K, generator=g)[:A]


def _unit_columns(X, floor):
    return X / torch.linalg.norm(X, dim=0, keepdim=True).clamp_min(floor)


def train(S_h: torch.Tensor, S_l: torch.Tensor, *, n_atoms: int,
          lam_h: float, lam_l: float, c1: float, c2: float, c3: float,
          delta: float, iterations: int, chunk: int, matmul: str = "fp32"):
    """Returns ``(X_h, X_l, costs)``: the dictionaries after
    ``iterations`` steps and the objective at every chunk's end (and at
    the last iteration)."""
    if matmul not in ("fp32", "tf32"):
        raise ValueError(f"matmul must be 'fp32' or 'tf32', not {matmul!r}")

    def mm(a, b):
        if matmul == "tf32":
            a, b = tf32(a), tf32(b)
        return a @ b

    S_h = S_h.to(torch.float32)
    S_l = S_l.to(torch.float32)
    K = S_h.shape[1]
    A = n_atoms
    cols = default_atoms(K, A).to(S_h.device)
    X_h = _unit_columns(S_h[:, cols], 1e-8)
    X_l = _unit_columns(S_l[:, cols], 1e-8)
    Sh, Sl = S_h.T, S_l.T                                   # (K, P), (K, M)
    eye = torch.eye(A, dtype=torch.float32, device=S_h.device)
    zeros = torch.zeros((K, A), dtype=torch.float32, device=S_h.device)
    Y1, Y2, Y3, Z1, Z2 = (zeros.clone() for _ in range(5))
    n_h = torch.sum(S_h * S_h)
    n_l = torch.sum(S_l * S_l)
    costs = []
    for i in range(iterations):
        G_h = 2.0 * mm(X_h.T, X_h) + (c1 + c3) * eye
        W_h = torch.linalg.solve(G_h, (2.0 * mm(Sh, X_h) + Z1).T).T
        G_l = 2.0 * mm(X_l.T, X_l) + (c2 + c3) * eye
        W_l = torch.linalg.solve(G_l, (2.0 * mm(Sl, X_l) + Z2
                                       + c3 * W_h).T).T
        Vh, Vl = W_h - Y1 / c1, W_l - Y2 / c2
        P = Vh - torch.clamp(Vh, -lam_h / c1, lam_h / c1)
        Q = Vl - torch.clamp(Vl, -lam_l / c2, lam_l / c2)
        Y1 = Y1 + c1 * (P - W_h)
        Y2 = Y2 + c2 * (Q - W_l)
        Y3 = Y3 + c3 * (W_h - W_l)
        Z1 = c1 * P + Y1 - Y3 + c3 * W_l
        Z2 = c2 * Q + Y2 + Y3
        X_h = torch.linalg.solve(mm(W_h.T, W_h) + delta * eye,
                                 mm(W_h.T, Sh)).T
        X_l = torch.linalg.solve(mm(W_l.T, W_l) + delta * eye,
                                 mm(W_l.T, Sl)).T
        X_h = _unit_columns(X_h, 1.0)
        X_l = _unit_columns(X_l, 1.0)
        if (i + 1) % chunk == 0 or i == iterations - 1:
            r_h = torch.sum((Sh - mm(W_h, X_h.T)) ** 2)
            r_l = torch.sum((Sl - mm(W_l, X_l.T)) ** 2)
            costs.append(float(0.5 * (torch.sqrt(r_h / (n_h + 1e-12))
                                      + torch.sqrt(r_l / (n_l + 1e-12)))))
    return X_h, X_l, costs


def fit(S_h: torch.Tensor, S_l: torch.Tensor, X_h: torch.Tensor,
        X_l: torch.Tensor, *, c_h: float, c_l: float) -> float:
    """How well a pair of dictionaries represents the patches: the mean
    normalized reconstruction error of each with the codes of one ridge
    solve, ``W = 2 S^T X (2 X^T X + c I)^-1`` (``c``: the code update's
    ridge, ``c1 + c3`` and ``c2 + c3``).  It reads the dictionaries
    alone, so it judges the ones a training returns."""
    out = []
    for S, X, c in ((S_h, X_h, c_h), (S_l, X_l, c_l)):
        S = S.to(torch.float32)
        X = torch.as_tensor(X, dtype=torch.float32, device=S.device)
        A = X.shape[1]
        G = 2.0 * X.T @ X + c * torch.eye(A, dtype=torch.float32,
                                          device=S.device)
        W = torch.linalg.solve(G, 2.0 * X.T @ S).T              # (K, A)
        r = torch.sum((S - X @ W.T) ** 2) / (torch.sum(S * S) + 1e-12)
        out.append(torch.sqrt(r))
    return float(0.5 * (out[0] + out[1]))
