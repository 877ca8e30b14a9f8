"""Public wrappers for the fused SCDL outer products.

Dispatch rule: CPU tensors take the plain versions (``ref.py``), and
so do ``meta`` tensors (shapes only); any other tensor launches the CUDA kernel or raises — there is no fallback.
``use_kernel=False`` selects the plain version on the card, for
comparing the two; ``use_kernel=True`` on CPU tensors raises.  Both
return fp32 whatever the input dtype.
"""
from __future__ import annotations

from repro_torch.kernels import common
from repro_torch.kernels.dict_outer.kernel import (dict_outer_fwd,
                                                   dict_outer_pair_fwd)
from repro_torch.kernels.dict_outer.ref import (dict_outer_pair_ref,
                                                dict_outer_ref)


# the chaos family (``kernel:dict_outer``), the JAX package's name
FAMILY = "dict_outer"


def dict_outer(S, W, *, use_kernel=None):
    """(S^T W, W^T W) for S (K, P), W (K, A)."""
    common.chaos_point(FAMILY, W)
    if use_kernel is None:
        use_kernel = common.on_card(W)
    if not use_kernel:
        return dict_outer_ref(S, W)
    return dict_outer_fwd(S, W)


def dict_outer_pair(Sh, Sl, Wh, Wl, *, use_kernel=None):
    """One pass over the coupled pair: (Sh^T Wh, Sl^T Wl, phi_h, phi_l)."""
    common.chaos_point(FAMILY, Wh)
    if use_kernel is None:
        use_kernel = common.on_card(Wh)
    if not use_kernel:
        return dict_outer_pair_ref(Sh, Sl, Wh, Wl)
    return dict_outer_pair_fwd(Sh, Sl, Wh, Wl)
