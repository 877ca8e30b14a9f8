"""Carry solver state between the JAX package and the port.

A JAX bundle, taken to the host with ``repro.core.bundle.gather`` plus
its ``replicated`` dict, is a dict of numpy arrays with every data leaf
record-major.  The port keeps a few leaves with another axis first, so
that the kernels and matrix products read contiguous blocks; the
functions here swap the first two axes of exactly those leaves on the
way in, and of every leaf the bundle records on axis 1
(``Bundle.record_axes``) on the way out, so the numpy side is always in
the JAX layout.  Every other leaf keeps its layout.  One pair of
functions serves every workload: their leaf names do not collide.

Deconvolution (``repro.imaging.deconvolve.build_bundle``):

  Y, Xp, HX (n, S, S) float32; psf_fp (n, 2, P, P // 2 + 1) complex64;
  tau, sig () float32; then by mode:
  sparse:  W (n, J, 1, 1); Xd, CX (n, J, S, S).  The port stores W, Xd,
           CX scale-major, (J, n, ...) (``imaging/deconvolve.py``).
  lowrank: Xd (n, S, S), record-major in both packages; replicated
           omega (S * S, rank + 8) float32.  No leaf is swapped: a
           bundle's ``Xd`` is scale-major only beside its ``CX``
           (``deconvolve.scale_major``).

Low-rank completion (``repro.imaging.lowrank``, ``"lowrank"``):

  Y, M, X (n, p) float32; replicated omega (p, rank + oversample)
  float32.  Every leaf keeps the JAX layout.

SCDL (``repro.imaging.scdl.build_bundle``):

  Sh (K, P), Sl (K, M), Wh, Wl (K, A), YZ (K, 5, A) float32; replicated
  Xh (P, A), Xl (M, A), the solve factors Fh, Fl (dicts holding ``C``,
  or ``Gi`` and ``B2``), n_h, n_l () float32.
  The port stores YZ plane-major, (5, K, A) (``imaging/scdl.py``); the
  factor dicts stay nested (``core/bundle.py``).

The conversion to numpy on the JAX side lives in the tests' hands; this
module imports nothing of it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from repro_torch.core.bundle import Bundle
from repro_torch.imaging.deconvolve import scale_major
from repro_torch.imaging.scdl import PLANE_MAJOR


def _swapped(data: Mapping[str, object]) -> Tuple[str, ...]:
    """The leaves of ``data`` the port keeps with records on axis 1; the
    names of the workloads do not collide, so one rule serves all."""
    return tuple(k for k in scale_major(data) + PLANE_MAJOR if k in data)


def _rep_from(v):
    if isinstance(v, Mapping):
        return {k: np.asarray(x, dtype=np.float32) for k, x in v.items()}
    return np.asarray(v, dtype=np.float32)


def _rep_to(v):
    if isinstance(v, Mapping):
        return {k: x.detach().cpu().numpy() for k, x in v.items()}
    return v.detach().cpu().numpy()


def bundle_from_numpy(data: Mapping[str, np.ndarray],
                      replicated: Mapping[str, object], *,
                      device=None) -> Bundle:
    """JAX-layout numpy state of any workload (nested ``Fh``/``Fl``
    dicts included) -> the port's ``Bundle`` on ``device`` (``None`` =
    ``"cuda"``)."""
    swapped = _swapped(data)
    moved = {k: (np.swapaxes(np.asarray(v), 0, 1) if k in swapped
                 else np.asarray(v)) for k, v in data.items()}
    # swapaxes gives strided views; the kernels want contiguous leaves
    moved = {k: np.ascontiguousarray(v) for k, v in moved.items()}
    rep = {k: _rep_from(v) for k, v in replicated.items()}
    return Bundle.create(moved, replicated=rep, device=device,
                         record_axes={k: 1 for k in swapped})


def bundle_to_numpy(bundle: Bundle) -> Tuple[Dict[str, np.ndarray],
                                             Dict[str, object]]:
    """The port's ``Bundle`` -> (data, replicated) numpy dicts in the JAX
    layout: every leaf whose records lie on axis 1 is swapped back."""
    data = {}
    for k, v in bundle.data.items():
        a = v.detach().cpu().numpy()
        data[k] = np.ascontiguousarray(np.swapaxes(a, 0, 1)) \
            if bundle.record_axis(k) == 1 else a
    rep = {k: _rep_to(v) for k, v in bundle.replicated.items()}
    return data, rep
