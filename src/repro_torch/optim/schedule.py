"""Learning-rate schedules (pure functions of the step counter).

Port of ``repro.optim.schedule``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import resolve_device


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1, device=None) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor`` x peak; returns the
    multiplicative lr scale for the step, a 0-d fp32 tensor.

    A tensor ``step`` (the optimizer's device step) keeps its device and
    makes no host sync; an integer step is placed on ``device``
    (``None`` means ``"cuda"``)."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
    else:
        step = torch.full((), step, dtype=torch.float32,
                          device=resolve_device(device))
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
