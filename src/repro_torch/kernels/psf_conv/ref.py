"""Plain PyTorch versions of the PSF convolution (``torch.fft``: cuFFT on
the card, pocketfft on the CPU):

  convolve:       irfft2(rfft2(x - minus, s=(G, G)) * kf, s=(G, G))[:S, :S]
                  (``conj``: the conjugate spectrum, the adjoint)
  convolve_pair:  (H a, Ht b) of two operands in one batched round trip
                  against the carried (kf, conj kf) pair
  power_step:     the pair of (a / nrm, b / nrm), the power iteration's
                  step, with each output's sum of squares

on the grid G the spectrum carries, (..., G, G // 2 + 1) complex64.
Half-precision stamps go through in fp32; results are cast back to the
operand's dtype, contiguous.  They are the CPU's route and the reference
the kernel is held to on the card."""
from __future__ import annotations

import torch


def _real(x: torch.Tensor) -> torch.Tensor:
    """FFT operand dtype: half-precision stamps go through the engine in
    fp32 (results are cast back to the operand dtype by the callers)."""
    return x if x.is_floating_point() and x.element_size() >= 4 \
        else x.to(torch.float32)


def convolve_ref(x, kf, *, conj=False, minus=None):
    if minus is not None:
        x = x - minus
    s = x.shape[-1]
    pad = kf.shape[-2]
    xf = torch.fft.rfft2(_real(x), s=(pad, pad))
    if conj:
        kf = torch.conj(kf)
    out = torch.fft.irfft2(xf * kf, s=(pad, pad))
    return out[..., :s, :s].to(x.dtype).contiguous()


def convolve_pair_ref(A, B, kf_pair):
    s = A.shape[-1]
    pad = kf_pair.shape[-2]
    z = torch.stack([_real(A), _real(B)], dim=-3)
    zf = torch.fft.rfft2(z, s=(pad, pad))
    out = torch.fft.irfft2(zf * kf_pair, s=(pad, pad))[..., :s, :s]
    return (out[..., 0, :, :].to(A.dtype).contiguous(),
            out[..., 1, :, :].to(B.dtype).contiguous())


def power_step_ref(A, B, kf_pair, scale):
    HA, HtB = convolve_pair_ref(A / scale, B / scale, kf_pair)
    return HA, HtB, torch.sum(HA ** 2), torch.sum(HtB ** 2)
