"""Plain references of the benchmark's configurations and the
comparisons that decide ``correct``.  They import nothing of the port."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def float32_products():
    """Matrix products in full float32 (TF32 off) for the block, as the
    configurations state; restored after."""
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
