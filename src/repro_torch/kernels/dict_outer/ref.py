"""Plain PyTorch versions of the fused SCDL outer-product accumulation
(Algorithm 2, step 9): given a sample block S (K, P) and codes W (K, A),
produce S^T W (P, A) and W^T W (A, A) in fp32.  ``dict_outer_pair_ref``
is the coupled high/low-resolution form the dictionary update
consumes."""
from __future__ import annotations

import torch


def dict_outer_ref(S, W):
    Sf = S.to(torch.float32)
    Wf = W.to(torch.float32)
    return Sf.T @ Wf, Wf.T @ Wf


def dict_outer_pair_ref(Sh, Sl, Wh, Wl):
    ShWh, phi_h = dict_outer_ref(Sh, Wh)
    SlWl, phi_l = dict_outer_ref(Sl, Wl)
    return ShWh, SlWl, phi_h, phi_l
