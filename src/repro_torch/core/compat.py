"""The mesh axes a step reduces over, the one reduction helper, and the
``torch.distributed`` calls the port makes, behind shims.

Port of ``repro.core.compat``.  The JAX package is single-controller: a
step runs under ``shard_map`` and ``jax.lax.psum(x, axes)`` sums over
named mesh axes.  The port is SPMD, one process per device: a step runs
in every rank on that rank's block of records, and a sum over mesh axes
is an all-reduce over the process group of the ranks that differ only
along those axes.

- :class:`Axes` is what a step receives as ``axes``: a tuple of mesh
  axis names (empty, hence falsy, without a mesh, so the reference's
  ``if axes:`` reads the same) carrying the process group of those axes,
  built once per mesh and names by :func:`axes_of`.  Several names make
  one flattened group: ``("pod", "data")`` sums over both at once, as
  the JAX call does.
- :func:`psum` and :func:`psum_tree` sum a tensor, or a dict of them, in
  one all-reduce: the leaves are packed into one flat buffer, each at a
  512-byte boundary as a fresh allocation would be, and come back as
  views of the reduced buffer.  The partials are never reduced in
  place, so a carried leaf is never written (the supervisor's ring and
  the checkpoint spill read carried leaves).  ``meta`` tensors (the
  contract checks) pass through untouched.
- :func:`all_gather`, :func:`reduce_scatter` and :func:`send_recv` cover
  the collectives whose names moved between PyTorch versions
  (``all_gather_into_tensor`` is deprecated in favour of
  ``all_gather_single`` in recent releases).

``COLLECTIVES["launches"]`` counts the collectives issued, the way each
kernel wrapper counts its launches.  Importing this module initializes
no process group and touches no device.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

# collectives issued by this process (all-reduce, all-gather,
# reduce-scatter and each point-to-point batch)
COLLECTIVES = {"launches": 0}

# elements of a 512-byte boundary at 4 bytes (the caching allocator's)
_ALIGN_BYTES = 512


class Axes(tuple):
    """Mesh axis names plus the process group of those axes.

    ``group`` is ``None`` for the empty value (no mesh), ``size`` the
    number of ranks the axes span and ``rank`` this process's index
    among them (its partition along the axes).  ``lead`` is true for
    the first replica of each partition (the ranks whose coordinates on
    the mesh's other dimensions are all 0), which alone writes the
    partition's checkpoint shard."""

    def __new__(cls, names: Sequence[str] = (), group=None, size: int = 1,
                rank: int = 0, lead: bool = True):
        self = super().__new__(cls, tuple(names))
        self.group = group
        self.size = int(size)
        self.rank = int(rank)
        self.lead = bool(lead)
        return self

    def __repr__(self) -> str:
        return f"Axes({tuple(self)!r}, size={self.size}, rank={self.rank})"


NO_AXES = Axes()


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``jax`` ``mesh.shape``)."""
    names = mesh.mesh_dim_names or ()
    return dict(zip(names, tuple(mesh.mesh.shape)))


def is_mesh(obj) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(obj, DeviceMesh)


# (id(mesh), names) -> (mesh, Axes); the mesh is kept so its id stays its
_AXES: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, Axes]] = {}


def axes_of(mesh, names: Sequence[str]) -> Axes:
    """The :class:`Axes` of ``names`` on ``mesh``, its group built once.

    Every rank must call this with the same mesh and names in the same
    order: creating a process group is itself collective
    (``dist.new_group`` is entered by every rank for every group).  The
    first call also makes one all-reduce on the new group, so that NCCL
    creates its communicator here and not inside a solve's first
    chunk."""
    names = tuple(names)
    if mesh is None or not names:
        return NO_AXES
    key = (id(mesh), names)
    hit = _AXES.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    dims = list(mesh.mesh_dim_names or ())
    missing = [a for a in names if a not in dims]
    if missing:
        raise ValueError(f"axes {missing} are not dimensions of the mesh "
                         f"{tuple(dims)}")
    ranks = mesh.mesh
    pos = [dims.index(a) for a in names]
    rest = [i for i in range(ranks.dim()) if i not in pos]
    me = dist.get_rank()
    mine = None
    # one group per coordinate of the other dimensions, in a fixed order
    # (the first is the lead replica's)
    for coord in itertools.product(*(range(ranks.shape[i]) for i in rest)):
        sub = ranks
        for i, c in sorted(zip(rest, coord), reverse=True):
            sub = sub.select(i, c)
        members = sorted(int(r) for r in sub.reshape(-1).tolist())
        group = dist.new_group(members)
        if me in members:
            mine = (group, members, not any(coord))
    group, members, lead = mine
    axes = Axes(names, group=group, size=len(members),
                rank=members.index(me), lead=lead)
    warm = torch.zeros(1, device=_mesh_device(mesh))
    dist.all_reduce(warm, group=group)
    _AXES[key] = (mesh, axes)
    return axes


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(axes) -> int:
    """The number of partitions along ``axes`` (1 without a mesh)."""
    return axes.size if isinstance(axes, Axes) else 1


def _reduces(axes, x: torch.Tensor) -> bool:
    if axes and not isinstance(axes, Axes):
        raise TypeError(f"axes={axes!r}: reductions over mesh axes take the "
                        f"Axes of a mesh (compat.axes_of), not bare names")
    return bool(axes) and x.device.type != "meta"


def _pad(n: int, itemsize: int) -> int:
    step = max(_ALIGN_BYTES // itemsize, 1)
    return -(-n // step) * step


def psum_tree(tree: Dict[str, torch.Tensor], axes) -> Dict[str, torch.Tensor]:
    """Sum every tensor of a flat dict over ``axes`` in one all-reduce
    (one per dtype); unchanged without a mesh."""
    if not axes or not tree:
        return tree
    first = next(iter(tree.values()))
    if not _reduces(axes, first):
        return tree
    out: Dict[str, torch.Tensor] = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for k, v in tree.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for dtype, keys in by_dtype.items():
        offsets, n = [], 0
        for k in keys:
            offsets.append(n)
            n += _pad(tree[k].numel(), tree[k].element_size())
        buf = torch.empty(n, dtype=dtype, device=first.device)
        for k, o in zip(keys, offsets):
            buf[o:o + tree[k].numel()].view(tree[k].shape).copy_(tree[k])
        dist.all_reduce(buf, group=axes.group)
        COLLECTIVES["launches"] += 1
        for k, o in zip(keys, offsets):
            out[k] = buf[o:o + tree[k].numel()].view(tree[k].shape)
    return {k: out[k] for k in tree}


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """``jax.lax.psum(x, axes)``: the sum over the ranks of ``axes``, in
    a fresh tensor (``x`` is never written); ``x`` itself without a
    mesh."""
    if not _reduces(axes, x):
        return x
    return psum_tree({"x": x}, axes)["x"]


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    """``jax.lax.pmean``: :func:`psum` over the axes' size."""
    if not _reduces(axes, x):
        return x
    return psum(x, axes) / axis_size(axes)


def all_gather(x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` in the
    axes' rank order (``jax.lax.all_gather(..., tiled=True)``)."""
    if not _reduces(axes, x):
        return x
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] * axes.size,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    backend = dist.get_backend(axes.group)
    if backend == "nccl" and hasattr(dist, "all_gather_single"):
        dist.all_gather_single(out, src, group=axes.group)
    elif backend == "nccl":
        dist.all_gather_into_tensor(out, src, group=axes.group)
    else:
        # gloo gathers into a list (its single-tensor form varies by
        # version)
        dist.all_gather(list(out.chunk(axes.size)), src, group=axes.group)
    COLLECTIVES["launches"] += 1
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, axes) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axes, scatter_dimension=0,
    tiled=True)``: this rank's block of the sum over the axes (the
    leading axis divides by the axes' size)."""
    if not _reduces(axes, x):
        return x
    src = x.contiguous()
    out = torch.empty((src.shape[0] // axes.size,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    backend = dist.get_backend(axes.group)
    if backend == "nccl" and hasattr(dist, "reduce_scatter_single"):
        dist.reduce_scatter_single(out, src, group=axes.group)
    elif backend == "nccl":
        dist.reduce_scatter_tensor(out, src, group=axes.group)
    else:
        # gloo has no reduce-scatter: sum, then keep this rank's block
        total = src.clone()
        dist.all_reduce(total, group=axes.group)
        out.copy_(total.chunk(axes.size)[axes.rank])
    COLLECTIVES["launches"] += 1
    return out


def send_recv(x: torch.Tensor, axes, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to the rank at index ``to`` of the axes' group and
    receive a tensor like it from the rank at index ``frm``
    (``jax.lax.ppermute`` for one source and one target per rank)."""
    if not _reduces(axes, x) or axes.size == 1:
        return x.clone() if _reduces(axes, x) else x
    src = x.contiguous()
    out = torch.empty_like(src)
    peer = _global_rank(axes.group, to)
    back = _global_rank(axes.group, frm)
    ops = [dist.P2POp(dist.isend, src, peer, group=axes.group),
           dist.P2POp(dist.irecv, out, back, group=axes.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    COLLECTIVES["launches"] += 1
    return out


def _global_rank(group, group_rank: int) -> int:
    if hasattr(dist, "get_global_rank"):
        return dist.get_global_rank(group, group_rank)
    return dist.distributed_c10d._get_global_rank(group, group_rank)


def block_range(n: int, axes) -> Tuple[int, int]:
    """This rank's contiguous block ``[lo, hi)`` of ``n`` records split
    over ``axes``; ``ValueError`` when they do not divide."""
    parts = axis_size(axes)
    if n % parts:
        raise ValueError(f"{n} records not divisible into {parts} "
                         f"partitions")
    per = n // parts
    rank = axes.rank if isinstance(axes, Axes) else 0
    return rank * per, (rank + 1) * per
