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

- :class:`Control` is a mesh's control plane on the host
  (:func:`control_of`, and ``Axes.control``): a gloo group over the
  mesh's ranks and the default group's key-value store.  Host decisions
  travel on it, so none of them waits for a card: the supervisor's
  votes and agreements, the merged recovery report, the service's
  dispatches and lane control.  :func:`tear_down` frees every process
  group of this process after a fault one rank met alone, so that its
  gloo peers raise at once; under NCCL each rank's watch thread aborts
  its communicators when a peer tears down, so a rank blocked on its
  card's stream is freed as well.

``COLLECTIVES["launches"]`` counts the collectives issued, the way each
kernel wrapper counts its launches.  Importing this module initializes
no process group and touches no device.
"""
from __future__ import annotations

import gc
import itertools
import threading
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# collectives issued by this process (all-reduce, all-gather,
# reduce-scatter and each point-to-point batch)
COLLECTIVES = {"launches": 0}

# elements of a 512-byte boundary at 4 bytes (the caching allocator's)
_ALIGN_BYTES = 512

# the process groups this module made or uses, by id: Axes and Control
# hold ids, so that tear_down can free every group of the process (gloo
# closes a group's connections only when the group object is freed)
_GROUPS: Dict[int, Any] = {}
_GROUP_IDS = itertools.count()


def _keep(group) -> Optional[int]:
    if group is None:
        return None
    gid = next(_GROUP_IDS)
    _GROUPS[gid] = group
    return gid


def _group(gid: Optional[int]):
    if gid is None:
        return None
    try:
        return _GROUPS[gid]
    except KeyError:
        raise RuntimeError("the process groups of this process were torn "
                           "down after a mesh fault (compat.tear_down); "
                           "start a new process group") from None


class Axes(tuple):
    """Mesh axis names plus the process group of those axes.

    ``group`` is ``None`` for the empty value (no mesh), ``size`` the
    number of ranks the axes span and ``rank`` this process's index
    among them (its partition along the axes).  ``lead`` is true for
    the first replica of each partition (the ranks whose coordinates on
    the mesh's other dimensions are all 0), which alone writes the
    partition's checkpoint shard."""

    def __new__(cls, names: Sequence[str] = (), group=None, size: int = 1,
                rank: int = 0, lead: bool = True, control=None):
        self = super().__new__(cls, tuple(names))
        self._gid = _keep(group)
        self.size = int(size)
        self.rank = int(rank)
        self.lead = bool(lead)
        # the mesh's control plane (None without a mesh)
        self.control = control
        return self

    @property
    def group(self):
        return _group(self._gid)

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
                rank=members.index(me), lead=lead,
                control=control_of(mesh))
    warm = torch.zeros(1, device=mesh_device(mesh))
    dist.all_reduce(warm, group=group)
    _AXES[key] = (mesh, axes)
    return axes


# ------------------------------------------------------------------
# The control plane
# ------------------------------------------------------------------

# id(mesh) -> (mesh, Control)
_CONTROLS: Dict[int, Tuple[Any, "Control"]] = {}
_CONTROL_IDS = itertools.count()
# the stores in use, kept past tear_down (a TCPStore's server lives in
# rank 0's process, and the peers read the fault from it)
_STORES: List[Any] = []
# the key a rank sets when it meets a fault alone (tear_down)
FAULT_KEY = "repro_torch/mesh_fault"


def _wait_key(store, key: str) -> None:
    """Block until ``key`` is set.  The wait is the store's own (a
    TCPStore's server answers when the key is set), so nothing polls; it
    starts over after the store's timeout."""
    while True:
        try:
            store.wait([key])
            return
        except RuntimeError:
            # the store's timeout; a store that is gone raises again here
            store.check([key])


class Control:
    """The control plane of one mesh on the host.

    ``group`` is a gloo group over the mesh's ranks (the default group
    itself when that is gloo's: a gloo mesh is its own control group),
    ``store`` the default group's key-value store.  Every rank makes the
    same calls in the same order, as for any collective.  Nothing here
    touches a card, and no wait polls the store: a waiting rank blocks in
    the store's ``wait``, and :func:`tear_down` sets the keys the other
    ranks may be waiting for.

    ``aborted`` is the fault a peer declared while this rank's NCCL
    groups were watched (:func:`_watch`): the watch aborted them, so work
    they had pending ended without its result."""

    def __init__(self, group, store, rank: int, size: int, prefix: str):
        self._gid = _keep(group)
        self.store = store
        self.rank = int(rank)
        self.size = int(size)
        self.prefix = prefix
        self._ids = itertools.count()
        # dispatches a served mesh has made (serve.service): the same
        # count on every rank
        self.dispatches = 0
        self.aborted: Optional[str] = None
        # the watch's thread under NCCL (control_of)
        self.watch: Optional[threading.Thread] = None

    @property
    def group(self):
        return _group(self._gid)

    def next_id(self) -> int:
        """A fresh number for one run's keys: the same on every rank."""
        return next(self._ids)

    def key(self, *parts) -> str:
        return "/".join([self.prefix] + [str(p) for p in parts])

    # ------------------------------------------------ collectives
    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast(self, obj=None, src: int = 0):
        """Rank ``src``'s ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]

    # ------------------------------------------------ the store
    def fault(self) -> Optional[str]:
        """The fault a rank declared (:func:`tear_down`), if any."""
        if self.store.check([FAULT_KEY]):
            return self.store.get(FAULT_KEY).decode()
        return None

    def vote(self, key: str, ballot: str, timeout_s: float) -> bool:
        """True when every rank casts ``ballot`` under ``key`` within
        ``timeout_s``; false on every rank that looks when one rank
        timed out first (the verdict is set once, by compare-and-set, so
        no two ranks read it differently)."""
        verdict_key = self.key("vote", key)
        if self.store.add(self.key("vote", key, ballot), 1) >= self.size:
            self.store.compare_set(verdict_key, "", "go")
        try:
            self.store.wait([verdict_key], timedelta(seconds=timeout_s))
        except RuntimeError:            # the bound passed
            pass
        return self.store.compare_set(verdict_key, "", "dead") == b"go"

    def next_dispatch(self) -> None:
        """Rank 0: wake the ranks waiting in :meth:`await_dispatch`."""
        self.store.set(self.key("dispatch", self.dispatches), "go")
        self.dispatches += 1

    def await_dispatch(self) -> None:
        """The other ranks: wait, without a time limit, for rank 0's next
        :meth:`next_dispatch`; ``MeshFaultError`` when a rank tears the
        mesh down meanwhile (:func:`tear_down` sets this key to its
        reason)."""
        key = self.key("dispatch", self.dispatches)
        _wait_key(self.store, key)
        self.dispatches += 1
        said = self.store.get(key).decode()
        if said != "go":
            from repro_torch.resilience.errors import MeshFaultError
            raise MeshFaultError(said)

    def _wake(self, reason: str) -> None:
        """Set every key another rank of this mesh may be waiting for:
        the next dispatch's and each other rank's watch (this rank's own
        watch stops)."""
        self.store.set(self.key("dispatch", self.dispatches), reason)
        for r in range(self.size):
            self.store.set(self.key("watch", r),
                           "stop" if r == self.rank else reason)


def _watch(ctl: Control, store) -> None:
    """The body of an NCCL mesh's watch thread (``store`` its own
    connection): when a peer tears the mesh down, record its reason in
    ``ctl.aborted`` and abort this process's NCCL communicators.  A rank
    whose peer faulted alone after a collective is blocked on its card's
    stream, which waits for NCCL work that peer never joins; the abort
    ends that work, the wait returns, and the supervisor raises
    ``MeshFaultError`` (``resilience.supervisor``)."""
    key = ctl.key("watch", ctl.rank)
    try:
        _wait_key(store, key)
        said = store.get(key).decode()
    except RuntimeError:                # the store is gone
        return
    if said == "stop":
        return
    ctl.aborted = said
    groups = {}
    for g in list(_GROUPS.values()) + [dist.group.WORLD]:
        try:
            backend = g._get_backend(torch.device("cuda"))
        except (RuntimeError, AttributeError):
            continue
        if type(backend).__name__ == "ProcessGroupNCCL":
            groups[g] = backend
    if not groups:
        return
    # one NCCL group call around the aborts, as
    # torch.distributed.distributed_c10d._abort_process_group makes, so
    # that no abort waits for another communicator's
    first = next(iter(groups.values()))
    grouped = hasattr(first, "_group_start")
    if grouped:
        first._group_start()
    for g in groups:
        g.abort()
    if grouped:
        first._group_end()


def _default_store():
    from torch.distributed import distributed_c10d as c10d
    return c10d._get_default_store()


def control_of(mesh) -> Control:
    """The :class:`Control` of ``mesh``, built once (collectively: every
    rank calls this, or ``make_mesh``/``axes_of``, in the same order).
    Under NCCL a daemon thread watches for a peer's fault
    (:func:`_watch`) for as long as the process lives."""
    hit = _CONTROLS.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    ranks = sorted(int(r) for r in mesh.mesh.reshape(-1).tolist())
    backend = str(dist.get_backend())
    if backend == "gloo" and len(ranks) == dist.get_world_size():
        group = dist.group.WORLD
    else:
        group = dist.new_group(ranks, backend="gloo")
    store = _default_store()
    if not any(s is store for s in _STORES):
        _STORES.append(store)
    ctl = Control(group, store, ranks.index(dist.get_rank()), len(ranks),
                  f"repro_torch/control{next(_CONTROL_IDS)}")
    if "nccl" in backend:
        ctl.watch = threading.Thread(
            target=_watch, args=(ctl, store.clone()), daemon=True,
            name=f"mesh-fault-watch-{ctl.prefix}")
        ctl.watch.start()
    _CONTROLS[id(mesh)] = (mesh, ctl)
    return ctl


def tear_down(reason: str) -> None:
    """Declare a mesh fault and free every process group of this
    process: a gloo peer blocked in a collective with this rank then
    raises at once, an NCCL peer once its watch has aborted its groups,
    and a follower waiting for a dispatch wakes and raises.  The store
    stays, so the peers read ``reason`` from it."""
    for store in _STORES:
        try:
            store.compare_set(FAULT_KEY, "", reason)
        except RuntimeError:            # the store went with its server
            pass
    controls = [ctl for _, ctl in _CONTROLS.values()]
    for ctl in controls:
        try:
            ctl._wake(reason)
        except RuntimeError:
            pass
    # this rank's own watch ends (stopped, or done aborting) before the
    # groups are destroyed
    for ctl in controls:
        if ctl.watch is not None:
            ctl.watch.join(timeout=60.0)
    _AXES.clear()
    _CONTROLS.clear()
    _GROUPS.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


def make_mesh(shape, axes, device=None):
    """``repro.core.compat.make_mesh``'s counterpart: the mesh of
    ``launch.mesh.make_mesh`` (which imports this module)."""
    from repro_torch.launch.mesh import make_mesh as _make_mesh
    return _make_mesh(shape, axes, device)


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` computes on."""
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
