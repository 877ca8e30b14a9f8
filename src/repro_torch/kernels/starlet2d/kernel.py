"""Batched starlet (a-trous B3) smoothing and the fused transforms Phi
and Phi^T — the CUDA kernels' wrappers.

The kernels (``csrc/starlet2d.cu``) replace the Pallas ``smooth_fwd``
(``repro/kernels/starlet2d/kernel.py``) and the cascades that
``repro/kernels/starlet2d/ops.py`` composes from it.  ``smooth`` runs one
smoothing, one thread block per stamp held in shared memory.
``forward`` and ``adjoint`` run all J scales of Phi or Phi^T in one
launch, so only the input planes and the output touch device memory: for
square stamps up to ``MAX_REGS_SIDE`` wide each thread holds a stamp
column in registers (128 // S stamps a block), other shapes keep one
stamp a block in shared memory.  Unlike the TPU version they need no
padding of the stamp batch: any N launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common

# dynamic shared memory a block may use on Hopper (227 KB)
_MAX_SMEM = 232_448
# threads of a forward / adjoint block (kThreads in csrc/starlet2d.cu):
# a thread owns a column, so a stamp may be at most this wide
_CASCADE_THREADS = 128
# the largest J of the fused transforms (kMaxScales; holes up to 128)
MAX_SCALES = 8
# the widest square stamp of the register kernels (kMaxRegsSide): two
# columns of 41 floats fill the 128 registers of four blocks an SM
MAX_REGS_SIDE = 41


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


def _check_cascade(what: str, t: torch.Tensor, rank: int, n_scales: int,
                   buffers: int) -> None:
    """The checks both transforms share; ``buffers`` stamp-sized fp32
    buffers of shared memory per block."""
    common.require_cuda(what, t)
    if t.dim() != rank:
        raise ValueError(f"{what}: expects a rank-{rank} tensor, got "
                         f"{tuple(t.shape)}")
    if not 1 <= n_scales <= MAX_SCALES:
        raise ValueError(f"{what}: n_scales must lie in [1, {MAX_SCALES}], "
                         f"got {n_scales}")
    h, w = t.shape[-2:]
    if w > _CASCADE_THREADS:
        raise ValueError(f"{what}: stamps at most {_CASCADE_THREADS} wide, "
                         f"got {h}x{w}")
    if buffers * h * w * 4 > _MAX_SMEM:
        raise ValueError(f"{what}: a {h}x{w} stamp needs "
                         f"{buffers * h * w * 4} bytes of shared memory, "
                         f"more than the {_MAX_SMEM} a block can have")


def starlet_forward_fwd(imgs: torch.Tensor, n_scales: int) -> torch.Tensor:
    """Phi in one launch: (N, H, W) -> (J, N, H, W), the J detail scales.

    imgs: CUDA tensor, fp32 or bf16, contiguous.  Limits: 1 <= J <= 8,
    W <= 128 and 8 H W bytes of shared memory within 227 KB (stamps up to
    128 x 227).  Square stamps up to ``MAX_REGS_SIDE`` (41) wide run the
    register kernel, every other shape the shared-memory one."""
    what = "starlet2d.forward"
    _check_cascade(what, imgs, 3, n_scales, buffers=2)
    n, h, w = imgs.shape
    out = torch.empty((n_scales, n, h, w), dtype=imgs.dtype,
                      device=imgs.device)
    err = common.library().repro_starlet_forward(
        imgs.data_ptr(), out.data_ptr(), n, h, w, n_scales,
        common.DTYPE_CODES[imgs.dtype], common.stream_ptr(imgs))
    common.check(err, what)
    starlet_forward_fwd.launches += 1
    return out


starlet_forward_fwd.launches = 0


def starlet_adjoint_fwd(coeffs: torch.Tensor, n_scales: int) -> torch.Tensor:
    """Phi^T in one launch: (J, N, H, W) -> (N, H, W).  fp32 square
    stamps up to ``MAX_REGS_SIDE`` (41) wide run the register kernel, J
    smoothings (w_j + H_j (acc - w_j)); every other case the shared-memory
    one, Horner's 2J - 1.

    coeffs: CUDA tensor, fp32 or bf16, contiguous, with J = n_scales
    planes.  Limits: 1 <= J <= 8, W <= 128 and 16 H W bytes of shared
    memory within 227 KB (square stamps up to 120 x 120)."""
    what = "starlet2d.adjoint"
    _check_cascade(what, coeffs, 4, n_scales, buffers=4)
    if coeffs.shape[0] != n_scales:
        raise ValueError(f"{what}: expects {n_scales} planes, got "
                         f"{tuple(coeffs.shape)}")
    _, n, h, w = coeffs.shape
    out = torch.empty((n, h, w), dtype=coeffs.dtype, device=coeffs.device)
    err = common.library().repro_starlet_adjoint(
        coeffs.data_ptr(), out.data_ptr(), n, h, w, n_scales,
        common.DTYPE_CODES[coeffs.dtype], common.stream_ptr(coeffs))
    common.check(err, what)
    starlet_adjoint_fwd.launches += 1
    return out


starlet_adjoint_fwd.launches = 0
