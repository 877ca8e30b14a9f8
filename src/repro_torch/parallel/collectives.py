"""Distributed-optimization collectives: hierarchical reduction and
int8 error-feedback compression.  Port of ``repro.parallel.collectives``.

At two pods and more the data-parallel reduction crosses the slow link
between pods.  Two standard schedules, in plain PyTorch on
``torch.distributed`` (the JAX package computes them outside any
Pallas kernel too):

  hierarchical_psum_local : reduce-scatter within the pod, all-reduce
      the scattered block across pods (1/data_size of the bytes on the
      slow link), all-gather within the pod.

  CompressedReducer : int8 quantisation with error feedback for the
      cross-pod hop; the quantisation residual is carried to the next
      step (EF-SGD), the scale is one per tensor.

The JAX functions run inside ``shard_map``, where axis names resolve
to the enclosing mesh.  The port runs one process per device, so each
function takes the mesh beside the axis names; every rank calls it on
its own block, as each shard does in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core import compat


def hierarchical_psum_local(x: torch.Tensor, mesh, *, pod_axis: str = "pod",
                            data_axis: str = "data") -> torch.Tensor:
    """The sum over (pod, data), scheduled as reduce-scatter over data,
    all-reduce over pod, all-gather over data; a ragged leading axis
    falls back to the flat sum."""
    data = compat.axes_of(mesh, (data_axis,))
    pod = compat.axes_of(mesh, (pod_axis,))
    if x.shape[0] % compat.axis_size(data) == 0:
        block = compat.reduce_scatter(x, data)
        block = compat.psum(block, pod)
        return compat.all_gather(block, data)
    return compat.psum(compat.psum(x, data), pod)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation: ``(q, scale)``."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_cross_pod_mean(x: torch.Tensor, error: torch.Tensor, mesh, *,
                              pod_axis: str = "pod"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean over the pod axis: ``(mean, new_error)``.
    The residual int8 lost is added back before the next quantisation.
    The all-reduce sums the dequantised values (the wire format would
    be int8 and one fp32 scale per pod; this models the arithmetic, as
    the JAX function does)."""
    pod = compat.axes_of(mesh, (pod_axis,))
    corrected = x + error
    q, scale = quantize_int8(corrected)
    decoded = dequantize_int8(q, scale)
    new_error = corrected - decoded
    return compat.psum(decoded, pod) / compat.axis_size(pod), new_error


class CompressedReducer:
    """Gradient reducer with persistent error-feedback state::

        mean_g, ef = reducer.reduce_local(g, ef)   # on every rank

    The exact mean over ``data`` within a pod, then the compressed mean
    over ``pod`` when the mesh has that axis."""

    def __init__(self, mesh, *, pod_axis: str = "pod",
                 data_axis: str = "data"):
        self.mesh = mesh
        self.pod_axis = pod_axis
        self.data_axis = data_axis

    def init_error(self, grads: Dict[str, Any]) -> Dict[str, Any]:
        return {k: torch.zeros(g.shape, dtype=torch.float32,
                               device=g.device) for k, g in grads.items()}

    def reduce_local(self, grads: Dict[str, torch.Tensor],
                     error: Dict[str, torch.Tensor]):
        """``(mean grads, new error)``, dicts of ``grads``' keys."""
        data = compat.axes_of(self.mesh, (self.data_axis,))
        has_pod = self.pod_axis in compat.mesh_shape(self.mesh)
        means, errs = {}, {}
        for k, g in grads.items():
            g = compat.pmean(g, data)
            if has_pod:
                g, e = compressed_cross_pod_mean(g, error[k], self.mesh,
                                                 pod_axis=self.pod_axis)
            else:
                e = error[k]
            means[k], errs[k] = g, e
        return means, errs
