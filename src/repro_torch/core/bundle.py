"""The bundled dataset on one device.

Port of ``repro.core.bundle`` without the mesh: a ``Bundle`` is a flat
dict of tensors that travel together through the iteration (noisy
stamps, PSF spectra, primal and dual variables, weights) plus a dict of
broadcast state (``replicated``: step sizes, dictionaries and the
like).  A replicated entry is a tensor or one level of nested dict of
tensors, as SCDL's solve factors ``Fh``/``Fl`` are (their keys name the
factor regime, so they stay a dict rather than flattened names).

Every data leaf carries the same number of records.  The record axis
is axis 0 unless ``record_axes`` names another: the deconvolution
bundle keeps its per-scale leaves scale-major, (J, n, ...), with
records on axis 1, so the kernels read each scale as one contiguous
(n, S, S) block instead of copying a transposed view every iteration.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device, to_device


def _copy_to(x: Any, device: torch.device) -> torch.Tensor:
    """A fresh tensor on ``device`` (never a view of the caller's
    array): the loop may then update bundle tensors freely."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    return to_device(x, device)


def _copy_rep(x: Any, device: torch.device):
    """A replicated entry: a tensor, or a dict of tensors."""
    if isinstance(x, Mapping):
        return {k: _copy_to(v, device) for k, v in x.items()}
    return _copy_to(x, device)


def _rep_leaves(replicated: Mapping[str, Any]):
    """(name, tensor) for every tensor of the replicated side, nested
    entries named ``outer.inner``."""
    for k, v in replicated.items():
        if isinstance(v, Mapping):
            yield from ((f"{k}.{kk}", vv) for kk, vv in v.items())
        else:
            yield k, v


@dataclass
class Bundle:
    """Co-located record-wise tensors + broadcast state on one device."""
    data: Dict[str, torch.Tensor]
    replicated: Dict[str, Any]
    device: torch.device
    record_axes: Mapping[str, int] = field(default_factory=dict)

    @classmethod
    def create(cls, data: Mapping[str, Any], *,
               replicated: Optional[Mapping[str, Any]] = None,
               device=None,
               record_axes: Optional[Mapping[str, int]] = None
               ) -> "Bundle":
        """Copy ``data`` and ``replicated`` (numpy arrays or tensors)
        onto ``device`` (``None`` = ``"cuda"``) and check the record
        invariant."""
        dev = resolve_device(device)
        b = cls(data={k: _copy_to(v, dev) for k, v in data.items()},
                replicated={k: _copy_rep(v, dev)
                            for k, v in (replicated or {}).items()},
                device=dev, record_axes=dict(record_axes or {}))
        b.validate()
        return b

    def record_axis(self, key: str) -> int:
        return self.record_axes.get(key, 0)

    @property
    def n_records(self) -> int:
        for k, v in self.data.items():
            return int(v.shape[self.record_axis(k)])
        return 0

    def validate(self) -> None:
        """The bundle invariant: every leaf holds the same number of
        records on its record axis, and lives on the bundle's device."""
        n = self.n_records
        for k, v in self.data.items():
            if v.shape[self.record_axis(k)] != n:
                raise ValueError(
                    f"bundle leaf {k!r} holds {v.shape[self.record_axis(k)]}"
                    f" records on axis {self.record_axis(k)}, others {n}")
        for k, v in [*self.data.items(), *_rep_leaves(self.replicated)]:
            if v.device != self.device:
                raise ValueError(f"bundle leaf {k!r} lies on {v.device}, "
                                 f"the bundle on {self.device}")

    def with_data(self, data: Dict[str, torch.Tensor],
                  replicated: Any = "keep") -> "Bundle":
        rep = self.replicated if replicated == "keep" else replicated
        return Bundle(data=data, replicated=rep, device=self.device,
                      record_axes=self.record_axes)


def gather(bundle: Bundle) -> Dict[str, np.ndarray]:
    """collect(): the bundle's data as host numpy arrays (in the
    bundle's own layout)."""
    return {k: v.detach().cpu().numpy() for k, v in bundle.data.items()}
