"""Coupled high/low-resolution patch pairs for SCDL.

Port of ``repro.data.synthetic.coupled_patches`` (nothing else of that
module is needed by the port).  The JAX version draws from
``PRNGKey(seed)``, which torch cannot reproduce: this one draws from a
CPU ``torch.Generator`` (seed 0, the JAX default, when none is given),
so it matches the JAX data in distribution only, and the same generator
gives the same data on every device.  The products run on ``device``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import resolve_device

# the JAX defaults: share of nonzero codes, noise standard deviation
SPARSITY, NOISE = 0.08, 0.01


def coupled_patches(n: int, p_dim: int, m_dim: int, n_atoms: int,
                    generator: Optional[torch.Generator] = None, *,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """n coupled patch pairs (HS: P=25/M=9, GS: P=289/M=81).

    HR patches are sparse combinations of a ground-truth dictionary of
    ``n_atoms`` unit columns; LR patches are a fixed random projection of
    them, each with Gaussian noise.  Returns ``(S_h (P, n), S_l (M, n))``
    in fp32 on ``device`` (``None`` = ``"cuda"``), the JAX layout."""
    dev = resolve_device(device)
    g = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    D = torch.randn((p_dim, n_atoms), generator=g).to(dev)
    D = D / torch.linalg.norm(D, dim=0, keepdim=True)
    codes = torch.randn((n_atoms, n), generator=g).to(dev)
    keep = torch.rand((n_atoms, n), generator=g).to(dev) < SPARSITY
    S_h = D @ (codes * keep)
    R = torch.randn((m_dim, p_dim), generator=g).to(dev) / math.sqrt(p_dim)
    S_l = R @ S_h
    S_h = S_h + NOISE * torch.randn(S_h.shape, generator=g).to(dev)
    S_l = S_l + NOISE * torch.randn(S_l.shape, generator=g).to(dev)
    return S_h.to(torch.float32), S_l.to(torch.float32)
