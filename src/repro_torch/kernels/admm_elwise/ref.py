"""Plain PyTorch version of the fused SCDL ADMM elementwise tail
(Algorithm 2, step 8): given fresh codes Wh/Wl (K, A) and the stacked
multiplier state ``YZ = [Y1, Y2, Y3, Z1, Z2]``, soft-threshold the
splitting variables and take the three dual ascent steps:

    P  = soft(Wh - Y1/c1, t1),  t1 = lam_h/c1
    Q  = soft(Wl - Y2/c2, t2),  t2 = lam_l/c2
    Y1 = Y1 + c1 (P - Wh)
    Y2 = Y2 + c2 (Q - Wl)
    Y3 = Y3 + c3 (Wh - Wl)

The state carries, instead of P and Q, the right-hand-side terms the
next W solves consume:

    Z1 = c1 P + Y1 - Y3 + c3 Wl
    Z2 = c2 Q + Y2 + Y3

With soft(V, t) = V - clip(V, -t, t) each dual step collapses to a
clamp, Y1' = -c1 clip(Wh - Y1/c1, +-t1), and c1 P = (c1 Wh - Y1) + Y1'.

Layout: the port keeps ``YZ`` plane-major, (5, K, A), so each plane is
one contiguous (K, A) block (the JAX package stores (K, 5, A); see
``repro_torch/imaging/scdl.py``).  The old Z1, Z2 planes are not read.
Arithmetic in fp32, result cast back to the input dtype (the kernel
contract)."""
from __future__ import annotations

import torch


def admm_elwise_ref(Wh, Wl, YZ, *, c1, c2, c3, t1, t2):
    """Wh/Wl: (K, A); YZ: (5, K, A).  Returns the updated (5, K, A)."""
    dt = YZ.dtype
    wh, wl = Wh.to(torch.float32), Wl.to(torch.float32)
    y1, y2, y3 = (YZ[i].to(torch.float32) for i in range(3))
    Y1n = -c1 * torch.clamp(wh - y1 / c1, -t1, t1)
    Y2n = -c2 * torch.clamp(wl - y2 / c2, -t2, t2)
    Y3n = y3 + c3 * (wh - wl)
    Z1 = (c1 * wh - y1) + 2.0 * Y1n - Y3n + c3 * wl
    Z2 = (c2 * wl - y2) + 2.0 * Y2n + Y3n
    return torch.stack([Y1n, Y2n, Y3n, Z1, Z2]).to(dt)
