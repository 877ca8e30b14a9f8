"""The bundled dataset: k co-partitioned tensors plus broadcast state.

Port of ``repro.core.bundle``.  A ``Bundle`` is a flat dict of tensors
that travel together through the iteration (noisy stamps, PSF spectra,
primal and dual variables, weights) plus a dict of broadcast state
(``replicated``: step sizes, dictionaries and the like).  A replicated
entry is a tensor or one level of nested dict of tensors, as SCDL's
solve factors ``Fh``/``Fl`` are (their keys name the factor regime, so
they stay a dict rather than flattened names).

Every data leaf carries the same number of records.  The record axis
is axis 0 unless ``record_axes`` names another: the deconvolution
bundle keeps its per-scale leaves scale-major, (J, n, ...), with
records on axis 1, so the kernels read each scale as one contiguous
(n, S, S) block instead of copying a transposed view every iteration.

The mesh half.  The JAX package shards each leaf's records over the
mesh's data axes and runs the paper's map and reduce under
``shard_map``.  The port runs one process per device: every rank calls
``Bundle.create(..., mesh=)`` with the same full inputs and keeps its
own contiguous block of records, cut on each leaf's own record axis
(the scale-major leaves on axis 1), in the order of its rank along the
axes (``("pod", "data")`` by default, those of them the mesh has).  The
records must divide into the partitions.  :func:`bundle_map` applies a
function to the rank's block, :func:`bundle_map_reduce` sums its
partial results over the axes in one all-reduce, and :func:`gather`
all-gathers each leaf along its record axis, so every rank holds the
whole array, as ``jax.device_get`` of a sharded array gives.

The copy back.  :func:`gather_leaf` copies a leaf on the card into
page-locked host memory, so that the copy is one DMA at the host link's
rate, and hands it out as the caller's numpy array.  The buffers are
host arrays registered with the CUDA driver, pooled by byte size: a
buffer returns to the pool when the caller has dropped the array and
every view of it, and the next result of its size is copied into it.
At most ``_PINNED_CAP`` bytes are registered, in callers' hands and free
together: a new buffer that would cross it evicts free ones, least
recently returned first, where that makes room, and otherwise the result
is copied to pageable memory.  ``PINNED_RESULTS`` counts the results
copied into a reused buffer, into a new one, and to pageable memory.
"""
from __future__ import annotations

import ctypes
import mmap
import os
import threading
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core import compat
from repro_torch.core.compat import NO_AXES, Axes
from repro_torch.kernels.common import resolve_device, to_device


def _dp_axes(mesh, axes: Optional[Sequence[str]] = None) -> Tuple[str, ...]:
    """The data-parallel axes of ``mesh``: ``axes`` (default
    ``("pod", "data")``) restricted to the mesh's dimensions."""
    if mesh is None:
        return ()
    if axes is None:
        axes = ("pod", "data")
    shape = compat.mesh_shape(mesh)
    return tuple(a for a in axes if a in shape)


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


def _block(x: Any, axis: int, lo: int, hi: int) -> Any:
    """Records ``[lo, hi)`` of ``x`` along ``axis`` (a view)."""
    if isinstance(x, torch.Tensor):
        return x.narrow(axis, lo, hi - lo)
    x = np.asarray(x)
    index = [slice(None)] * x.ndim
    index[axis] = slice(lo, hi)
    return x[tuple(index)]


@dataclass
class Bundle:
    """Co-located record-wise tensors + broadcast state on one device,
    this rank's block of records when ``mesh`` is set."""
    data: Dict[str, torch.Tensor]
    replicated: Dict[str, Any]
    device: torch.device
    record_axes: Mapping[str, int] = field(default_factory=dict)
    mesh: Any = None
    axes: Axes = NO_AXES
    # every rank's records together, and where this rank's block starts
    n_total: Optional[int] = None
    record_start: int = 0

    @classmethod
    def create(cls, data: Mapping[str, Any], *,
               replicated: Optional[Mapping[str, Any]] = None,
               device=None,
               record_axes: Optional[Mapping[str, int]] = None,
               mesh=None, axes: Optional[Sequence[str]] = None
               ) -> "Bundle":
        """Copy ``data`` and ``replicated`` (numpy arrays or tensors)
        onto ``device`` (``None`` = ``"cuda"``) and check the record
        invariant.  With ``mesh``, keep this rank's block of records
        along ``axes`` (module docstring)."""
        dev = resolve_device(device)
        rec = dict(record_axes or {})
        if mesh is not None and not compat.is_mesh(mesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                            f"(repro_torch.launch.mesh.make_mesh), got "
                            f"{type(mesh).__name__}")
        if mesh is not None and mesh.device_type != dev.type:
            raise ValueError(f"the mesh is over {mesh.device_type!r} "
                             f"devices, the bundle on {dev}")
        counts = {k: int(np.shape(v)[rec.get(k, 0)])
                  for k, v in data.items()}
        n = next(iter(counts.values()), 0)
        for k, c in counts.items():
            if c != n:
                raise ValueError(f"bundle leaf {k!r} holds {c} records on "
                                 f"axis {rec.get(k, 0)}, others {n}")
        ax = compat.axes_of(mesh, _dp_axes(mesh, axes))
        lo, hi = compat.block_range(n, ax)
        if ax.size > 1:
            data = {k: _block(v, rec.get(k, 0), lo, hi)
                    for k, v in data.items()}
        b = cls(data={k: _copy_to(v, dev).contiguous() if ax.size > 1
                      else _copy_to(v, dev) for k, v in data.items()},
                replicated={k: _copy_rep(v, dev)
                            for k, v in (replicated or {}).items()},
                device=dev, record_axes=rec, mesh=mesh, axes=ax,
                n_total=n, record_start=lo)
        b.validate()
        return b

    def record_axis(self, key: str) -> int:
        return self.record_axes.get(key, 0)

    @property
    def n_records(self) -> int:
        """The records this rank holds."""
        for k, v in self.data.items():
            return int(v.shape[self.record_axis(k)])
        return 0

    @property
    def n_partitions(self) -> int:
        return self.axes.size

    @property
    def record_range(self) -> Tuple[int, int]:
        """This rank's records ``[lo, hi)`` among all ranks' records."""
        return self.record_start, self.record_start + self.n_records

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
                      record_axes=self.record_axes, mesh=self.mesh,
                      axes=self.axes, n_total=self.n_total,
                      record_start=self.record_start)

    def zip(self, other: "Bundle") -> "Bundle":
        """The paper's RDD.zip: one bundle of two co-partitioned ones
        (their data keys must differ)."""
        if other.n_records != self.n_records \
                or other.record_range != self.record_range:
            raise ValueError("zip requires equal record counts")
        shared = set(self.data) & set(other.data)
        if shared:
            raise ValueError(f"zip: both bundles hold {sorted(shared)}")
        out = self.with_data({**self.data, **other.data})
        out.record_axes = {**self.record_axes, **other.record_axes}
        return out


def bundle_map(fn: Callable, bundle: Bundle, *,
               has_replicated: bool = False) -> Bundle:
    """map: ``fn(data)`` (or ``fn(data, replicated)``) on this rank's
    block, no communication; ``fn`` keeps each leaf's record count."""
    out = (fn(bundle.data, bundle.replicated) if has_replicated
           else fn(bundle.data))
    return bundle.with_data(out)


def bundle_map_reduce(map_fn: Callable, bundle: Bundle, *,
                      has_replicated: bool = False):
    """map + reduce: ``map_fn``'s partial results (a tensor or a dict of
    them) summed over the bundle's axes in one all-reduce, the same on
    every rank."""
    part = (map_fn(bundle.data, bundle.replicated) if has_replicated
            else map_fn(bundle.data))
    if isinstance(part, dict):
        return compat.psum_tree(part, bundle.axes)
    return compat.psum(part, bundle.axes)


# the pinned host buffers of gather_leaf (module docstring): at most
# _PINNED_CAP bytes registered in all, in callers' hands and free
_PINNED_CAP = 1 << 30
# results of gather_leaf from the card copied into a pooled buffer taken
# again (reused), into a newly registered one (allocated), or, with the
# cap reached, to pageable memory (pageable)
PINNED_RESULTS = {"reused": 0, "allocated": 0, "pageable": 0}


def _pin(nbytes: int) -> Optional[np.ndarray]:
    """``nbytes`` of host memory registered with the CUDA driver as
    page-locked for every device, or ``None`` if the driver refuses.
    The mapping is populated first: registering resident pages takes
    about half the time of faulting them in one by one."""
    mem = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                    | mmap.MAP_POPULATE)
    buf = np.frombuffer(mem, np.uint8)
    err = torch.cuda.cudart().cudaHostRegister(buf.ctypes.data, nbytes,
                                               1)  # cudaHostRegisterPortable
    if int(err) == 0:
        return buf
    _forget_cuda_error()
    return None


def _forget_cuda_error() -> None:
    """Reset the CUDA runtime's last error, which a refused registration
    leaves for the next kernel launch to raise.  torch binds no
    ``cudaGetLastError``: this calls the runtime library torch loaded,
    and does nothing where there is none to find."""
    name = f"libcudart.so.{torch.version.cuda.split('.')[0]}"
    try:
        rt = ctypes.CDLL(name, mode=os.RTLD_NOLOAD | os.RTLD_NOW)
    except OSError:
        return
    rt.cudaGetLastError()


def _unpin(buf: np.ndarray) -> None:
    torch.cuda.cudart().cudaHostUnregister(buf.ctypes.data)


class _PinnedPool:
    """The registered buffers: handed out by :meth:`take`, back through
    the finalizer that :meth:`copy` puts on each result.  The lock
    serializes takes, registrations and evictions; a release only
    appends to ``returned`` (atomic, and safe from a finalizer that the
    garbage collector runs inside the lock's own region), drained at the
    next take."""

    def __init__(self):
        self.lock = threading.Lock()
        self.free: List[np.ndarray] = []    # least recently returned first
        self.returned: deque = deque()
        self.held = 0                       # bytes registered, free or not

    def take(self, nbytes: int) -> Optional[np.ndarray]:
        """A free buffer of ``nbytes``, a new one within the cap, or
        ``None`` (copy to pageable memory)."""
        with self.lock:
            while self.returned:
                self.free.append(self.returned.popleft())
            for i in reversed(range(len(self.free))):
                if self.free[i].nbytes == nbytes:
                    PINNED_RESULTS["reused"] += 1
                    return self.free.pop(i)
            in_hands = self.held - sum(b.nbytes for b in self.free)
            buf = None
            if in_hands + nbytes <= _PINNED_CAP:
                while self.held + nbytes > _PINNED_CAP:
                    old = self.free.pop(0)
                    _unpin(old)
                    self.held -= old.nbytes
                buf = _pin(nbytes)
            if buf is None:
                PINNED_RESULTS["pageable"] += 1
                return None
            self.held += nbytes
            PINNED_RESULTS["allocated"] += 1
            return buf

    def copy(self, x: torch.Tensor) -> np.ndarray:
        """``x`` as a C-ordered host array in a pooled buffer, or in
        pageable memory past the cap."""
        buf = self.take(x.numel() * x.element_size())
        if buf is None:
            return x.cpu().numpy()
        # a fresh view of the buffer for this result alone: the tensor
        # over it, every torch view of that and the returned array (whose
        # base is the tensor) keep it alive, and its finalizer returns
        # the buffer once all of them are gone
        own = buf[:]
        weakref.finalize(own, self.returned.append, buf).atexit = False
        out = torch.from_numpy(own).view(x.dtype).view(x.shape)
        out.copy_(x)
        return out.numpy()


_pinned_pool = _PinnedPool()


def gather_leaf(bundle: Bundle, key: str) -> np.ndarray:
    """One data leaf, every rank's records, as a host array.

    A leaf on the card comes back in page-locked host memory, a buffer
    the caller holds until it drops the array and every view of it, at
    most 1 GiB of them in all (``_PINNED_CAP``; past it, pageable
    memory); a CPU leaf comes back as ``.numpy()`` of it, sharing its
    memory."""
    x = compat.all_gather(bundle.data[key], bundle.axes,
                          dim=bundle.record_axis(key)).detach()
    if x.device.type != "cuda" or x.numel() == 0:
        return x.cpu().numpy()
    return _pinned_pool.copy(x)


def gather(bundle: Bundle) -> Dict[str, np.ndarray]:
    """collect(): the bundle's data, every rank's records, as host numpy
    arrays (in the bundle's own layout)."""
    return {k: gather_leaf(bundle, k) for k in bundle.data}
