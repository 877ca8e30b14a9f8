"""Batched starlet (a-trous B3) smoothing — the CUDA kernel's wrapper.

The kernel (``csrc/starlet2d.cu``) replaces the Pallas ``smooth_fwd``
(``repro/kernels/starlet2d/kernel.py``): one thread block per stamp,
the stamp and its W-pass result held in shared memory, the H pass
written straight to the output.  Unlike the TPU version it needs no
padding of the stamp batch: blocks are per stamp, so any N launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common

# dynamic shared memory a block may use on Hopper (227 KB)
_MAX_SMEM = 232_448


def smooth_fwd(imgs: torch.Tensor, scale: int) -> torch.Tensor:
    """imgs: (N, H, W) CUDA tensor, fp32 or bf16, contiguous; one B3
    smoothing at dyadic ``scale``.  Returns a new tensor."""
    what = "starlet2d.smooth"
    common.require_cuda(what, imgs)
    if imgs.dim() != 3:
        raise ValueError(f"{what}: expects (N, H, W), got "
                         f"{tuple(imgs.shape)}")
    n, h, w = imgs.shape
    if 2 * h * w * 4 > _MAX_SMEM:
        raise ValueError(f"{what}: a {h}x{w} stamp needs "
                         f"{2 * h * w * 4} bytes of shared memory, more "
                         f"than the {_MAX_SMEM} a block can have")
    if scale < 0 or scale > 30:
        raise ValueError(f"{what}: scale must lie in [0, 30], got {scale}")
    out = torch.empty_like(imgs)
    err = common.library().repro_starlet_smooth(
        imgs.data_ptr(), out.data_ptr(), n, h, w, 1 << scale,
        common.DTYPE_CODES[imgs.dtype], common.stream_ptr(imgs))
    common.check(err, what)
    smooth_fwd.launches += 1
    return out


smooth_fwd.launches = 0
