"""Plain PyTorch version of the batched starlet smoothing: one B3 a-trous
smoothing over a stack of stamps with periodic boundaries, matching
``repro_torch.imaging.starlet.smooth``.

It follows the kernel's contract, not the JAX oracle's: the two passes
accumulate in fp32 and the result is cast back to the input dtype once
(the JAX ``smooth_ref`` accumulates in the input dtype, which differs
for bf16 only)."""
from __future__ import annotations

import torch

_K = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def smooth_ref(imgs, scale: int):
    """imgs: (N, H, W) -> (N, H, W), one smoothing at dyadic ``scale``."""
    step = 1 << scale
    out = imgs.to(torch.float32)
    for dim in (-1, -2):
        acc = _K[2] * out
        for t, off in ((0, -2), (1, -1), (3, 1), (4, 2)):
            # torch.roll, like jnp.roll, wraps shifts longer than the axis
            acc = acc + _K[t] * torch.roll(out, off * step, dims=dim)
        out = acc
    return out.to(imgs.dtype)
