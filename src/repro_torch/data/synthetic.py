"""Deterministic synthetic data: LM token batches and coupled
high/low-resolution patch pairs for SCDL.

Port of ``repro.data.synthetic``.  The JAX versions draw from
``PRNGKey``, which torch cannot reproduce.  So the draws are arguments
where a test needs JAX's own (``lm_batch``'s ``draws=``), and otherwise
come from CPU ``torch.Generator``s: the data then match the JAX data in
distribution only, and the same seed gives the same data on every
device.  The arithmetic runs on ``device``.
"""
from __future__ import annotations

import hashlib
import math
import struct
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device, to_device

# the JAX defaults: share of nonzero codes, noise standard deviation
SPARSITY, NOISE = 0.08, 0.01
# lm_batch: the share of noisy transitions, the drift's range [lo, hi)
# and the embeddings' scale, as in the JAX version
LM_NOISE, LM_DRIFT, LM_EMBED_SCALE = 0.05, (1, 7), 0.02


def lm_seed(seed: int, step: int) -> int:
    """The seed of ``lm_batch``'s CPU generator for ``(seed, step)``, in
    the stead of JAX's ``fold_in(PRNGKey(seed), step)``: the 32-bit
    little-endian BLAKE2b digest of the two as unsigned 64-bit
    little-endian integers.  The CPU generator keeps only the low 32
    bits of its seed, so ``seed * 2**32 + step`` would give every seed
    the same stream; a digest mixes both into those bits."""
    if not (0 <= seed < 2 ** 64 and 0 <= step < 2 ** 64):
        raise ValueError(f"seed {seed} and step {step} must lie in "
                         f"[0, 2**64)")
    digest = hashlib.blake2b(struct.pack("<QQ", seed, step),
                             digest_size=4).digest()
    return int.from_bytes(digest, "little")


def lm_draws(cfg: ModelConfig, batch: int, seq: int, seed: int,
             step: int) -> Dict[str, torch.Tensor]:
    """``lm_batch``'s draws for ``(seed, step)`` on the CPU: ``start``
    (batch, 1) in [0, V), ``drift`` (batch, 1) in [1, 7), ``noise``
    (batch, seq + 1) bool, true with probability 0.05, from the
    generator seeded ``lm_seed(seed, step)``; for ``frontend ==
    "embed"`` also ``embeds`` (batch, seq, d_model), standard normal
    fp32, from ``lm_seed(seed + 1, step)``."""
    g = torch.Generator().manual_seed(lm_seed(seed, step))
    draws = {"start": torch.randint(0, cfg.vocab_size, (batch, 1),
                                    generator=g),
             "drift": torch.randint(*LM_DRIFT, (batch, 1), generator=g),
             "noise": torch.rand((batch, seq + 1), generator=g) < LM_NOISE}
    if cfg.frontend == "embed":
        ge = torch.Generator().manual_seed(lm_seed(seed + 1, step))
        draws["embeds"] = torch.randn((batch, seq, cfg.d_model),
                                      generator=ge)
    return draws


def lm_batch(cfg: ModelConfig, batch: int, seq: int, seed: int, step: int,
             *, draws: Optional[Dict] = None, device=None
             ) -> Dict[str, torch.Tensor]:
    """Markov-ish token stream: next-token structure a model can learn.

    tokens[t+1] = (a * tokens[t] + drift + noise) mod V — low-entropy
    transitions give a learnable signal (loss drops measurably within
    hundreds of steps at 10-100M scale).

    ``draws`` (numpy arrays or tensors, keys as :func:`lm_draws`
    returns; ``embeds`` is the standard normal draw, which is scaled
    here) replaces the draws of ``(seed, step)``: a test passes JAX's
    own.  Returns int32 ``labels`` and ``tokens`` (batch, seq), or
    ``labels`` and fp32 ``embeds`` (batch, seq, d_model) for the
    ``"embed"`` frontend, on ``device`` (``None`` = ``"cuda"``)."""
    dev = resolve_device(device)
    if draws is None:
        draws = lm_draws(cfg, batch, seq, seed, step)
    i32 = torch.int32
    start = to_device(draws["start"], dev, i32)
    drift = to_device(draws["drift"], dev, i32)
    noise = to_device(draws["noise"], dev, torch.bool)
    ar = torch.arange(seq + 1, dtype=i32, device=dev)[None, :]
    # int32 throughout, as in JAX (a bool cumsum is int64 in torch)
    stream = (start + drift * ar + noise.cumsum(-1, dtype=i32)) \
        % cfg.vocab_size
    out = {"labels": stream[:, 1:]}
    if cfg.frontend == "embed":
        out["embeds"] = LM_EMBED_SCALE * to_device(draws["embeds"], dev,
                                                   torch.float32)
    else:
        out["tokens"] = stream[:, :-1]
    return out


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
