"""Plain PyTorch versions of the fused Condat elementwise passes
(Algorithm 1's primal-dual iteration):

  primal:  X_new = max(X - tau grad - tau Phi^T U, 0)        [prox of >=0]
  dual:    U_new = clip(U + sig (2 C_new - C_old), -W, W)

The dual folds the over-relaxation through the linear transform:
Phi(2 X_new - X) = 2 Phi(X_new) - Phi(X), with C = Phi(X) carried across
iterations, so X_bar is never formed on the sparse path.
``with_xbar=True`` (the low-rank path) also returns X_bar = 2 X_new - X.

Accumulation in fp32, results cast back to the input dtype (the kernel
contract).  ``tau``/``sig`` may be Python numbers or one-element fp32
tensors on the operands' device, or one step size per instance of a
bucket, (B,): the operands then carry the instance axis fourth from the
end, (..., B, n, S, S), and the step size broadcasts as (B, 1, 1, 1)."""
from __future__ import annotations

import torch


def _scalar(v, like):
    """The step size, shaped to broadcast against ``like``: a scalar, or
    (B, 1, 1, 1) against a (..., B, n, S, S) operand."""
    t = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    if t.numel() == 1:
        return t.reshape(())
    if like.dim() < 4 or like.shape[-4] != t.numel():
        raise ValueError(f"{t.numel()} step sizes for an operand of shape "
                         f"{tuple(like.shape)} (instance axis fourth from "
                         f"the end)")
    return t.reshape(-1, 1, 1, 1)


def condat_primal_ref(X, U_adj, grad, tau, *, with_xbar: bool = False):
    dt = X.dtype
    x = X.to(torch.float32)
    t = _scalar(tau, X)
    xn = torch.clamp(x - t * grad.to(torch.float32)
                     - t * U_adj.to(torch.float32), min=0.0)
    if with_xbar:
        return xn.to(dt), (2.0 * xn - x).to(dt)
    return xn.to(dt)


def condat_dual_ref(U, C_new, C_old, W, sig):
    dt = U.dtype
    s = _scalar(sig, U)
    v = U.to(torch.float32) + s * (2.0 * C_new.to(torch.float32)
                                   - C_old.to(torch.float32))
    w = W.to(torch.float32)
    return torch.clamp(v, -w, w).to(dt)
