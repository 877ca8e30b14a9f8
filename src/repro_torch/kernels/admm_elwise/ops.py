"""Public wrapper for the fused SCDL ADMM elementwise tail.

Dispatch rule: CPU tensors take the plain version (``ref.py``), and
so do ``meta`` tensors (shapes only); any other tensor launches the CUDA kernel or raises — there is no fallback.
``use_kernel=False`` selects the plain version on the card, for
comparing the two; ``use_kernel=True`` on CPU tensors raises.

``YZ`` is plane-major, (5, K, A) — see ``ref.py``.
"""
from __future__ import annotations

from repro_torch.kernels import common
from repro_torch.kernels.admm_elwise.kernel import admm_elwise_fwd
from repro_torch.kernels.admm_elwise.ref import admm_elwise_ref


# the chaos family (``kernel:admm_elwise``), the JAX package's name
FAMILY = "admm_elwise"


def admm_elwise(Wh, Wl, YZ, *, c1, c2, c3, t1, t2, use_kernel=None):
    common.chaos_point(FAMILY, YZ)
    if use_kernel is None:
        use_kernel = common.on_card(YZ)
    if not use_kernel:
        return admm_elwise_ref(Wh, Wl, YZ, c1=c1, c2=c2, c3=c3, t1=t1,
                               t2=t2)
    return admm_elwise_fwd(Wh, Wl, YZ, c1=c1, c2=c2, c3=c3, t1=t1, t2=t2)
