"""Carry deconvolution state between the JAX package and the port.

The JAX bundle (``repro.imaging.deconvolve.build_bundle``), taken to the
host with ``repro.core.bundle.gather`` plus its ``replicated`` dict, is
a dict of numpy arrays, every leaf record-major:

  Y, Xp, HX (n, S, S) float32; psf_fp (n, 2, P, P // 2 + 1) complex64;
  W (n, J, 1, 1); Xd, CX (n, J, S, S); tau, sig () float32.

The port's bundle stores ``W``, ``Xd`` and ``CX`` scale-major,
(J, n, ...) (see ``imaging/deconvolve.py``): :func:`bundle_from_numpy`
swaps their first two axes on the way in and :func:`bundle_to_numpy`
swaps them back, so the numpy side is always in the JAX layout.  Every
other leaf, ``psf_fp`` included, keeps its layout.  The conversion
itself lives in the tests' hands on the JAX side; this module imports
nothing of it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from repro_torch.core.bundle import Bundle
from repro_torch.imaging.deconvolve import SCALE_MAJOR


def bundle_from_numpy(data: Mapping[str, np.ndarray],
                      replicated: Mapping[str, np.ndarray], *,
                      device=None) -> Bundle:
    """JAX-layout numpy state -> the port's ``Bundle`` on ``device``
    (``None`` = ``"cuda"``)."""
    moved = {k: (np.swapaxes(np.asarray(v), 0, 1) if k in SCALE_MAJOR
                 else np.asarray(v)) for k, v in data.items()}
    # swapaxes gives strided views; the kernels want contiguous leaves
    moved = {k: np.ascontiguousarray(v) for k, v in moved.items()}
    rep = {k: np.asarray(v, dtype=np.float32) for k, v in replicated.items()}
    return Bundle.create(moved, replicated=rep, device=device,
                         record_axes={k: 1 for k in SCALE_MAJOR
                                      if k in moved})


def bundle_to_numpy(bundle: Bundle) -> Tuple[Dict[str, np.ndarray],
                                             Dict[str, np.ndarray]]:
    """The port's ``Bundle`` -> (data, replicated) numpy dicts in the
    JAX layout."""
    data = {}
    for k, v in bundle.data.items():
        a = v.detach().cpu().numpy()
        data[k] = np.ascontiguousarray(np.swapaxes(a, 0, 1)) \
            if k in SCALE_MAJOR else a
    rep = {k: v.detach().cpu().numpy() for k, v in bundle.replicated.items()}
    return data, rep
