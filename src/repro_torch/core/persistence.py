"""Moving state between the card and the host: checkpoint payloads, the
batched driver's retired lanes, and the paper's two persistence policies.

Port of ``repro.core.persistence``.  Host trees hold CPU tensors (numpy
cannot hold bf16; ``checkpoint.checkpointer`` turns them into ``.npy``
files).  Trees are dicts of tensors, nested one level or more, flattened
in sorted key order (``core.checks.leaves_with_path``).

Two ways off the card:

- :func:`to_host` — a copy the caller can read on return: it waits for
  the device.  Used where the host needs the values now (re-compaction,
  final states).
- :func:`spill_async` — the checkpoint path.  Each leaf is copied with
  ``non_blocking=True`` into pinned host memory and one CUDA event is
  recorded after the copies; the checkpoint writer thread waits on that
  event before it touches the bytes.  The calling thread never waits.
  Stream order keeps the snapshot intact: the copies are queued before
  any later work on the stream, and the port's steps write out of place
  (every step returns new tensors, none is written in place), so no
  later kernel writes into a tensor the copy still has to read.
  :func:`assert_out_of_place` is the check a step's new state is held to.

Policies (``Policy``, ``wrap_step``): in the JAX package MEMORY_ONLY
rematerialises a step's intermediates with ``jax.checkpoint``.  Under
``torch.no_grad`` eager PyTorch keeps no activations between operations,
so there is nothing to rematerialise: ``wrap_step`` returns the step
unchanged for both policies.

Under a mesh each rank checkpoints its own block of records:
:func:`bundle_shard` is the port's counterpart of ``bundle_shardings``,
the layout ``checkpoint.save`` writes beside a payload (each record
leaf's axis, the rank's range among all records) and
``checkpoint.restore(records=)`` reads a block back from, under any
number of ranks.
"""
from __future__ import annotations

import enum
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.bundle import Bundle
from repro_torch.core.checks import label, leaves_with_path


class Policy(enum.Enum):
    MEMORY_ONLY = "memory_only"
    MEMORY_AND_DISK = "memory_and_disk"


def wrap_step(step_fn: Callable, policy: Policy) -> Callable:
    """The step under ``policy``: unchanged for both (module docstring)."""
    if not isinstance(policy, Policy):
        raise TypeError(f"policy must be a Policy, got {policy!r}")
    return step_fn


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of dict trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _host_copy(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    return x.detach().to("cpu", copy=True)


def to_host(tree: Any) -> Any:
    """A host copy of a tree of tensors, valid on return (a CUDA leaf
    makes this wait for the device)."""
    return tree_map(_host_copy, tree)


def spill_async(tree: Any):
    """Start copying a tree to pinned host memory without waiting.

    Returns ``(host_tree, event)``: ``event`` is the CUDA event recorded
    after the copies (``None`` when no leaf lies on the card); the host
    tree is valid once ``event.synchronize()`` returns.  CPU and numpy
    leaves are copied at once."""
    cards = []

    def copy(x):
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x.detach(), non_blocking=True)
            cards.append(x.device)
            return host
        return _host_copy(x) if isinstance(x, (torch.Tensor, np.ndarray)) \
            else x

    host = tree_map(copy, tree)
    event = None
    if cards:
        if len(set(cards)) > 1:
            raise ValueError(f"spill_async: leaves on {sorted(set(cards))}")
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cards[0]))
    return host, event


def assert_out_of_place(old: Any, new: Any, what: str) -> None:
    """A step's new state shares no storage with the state it was given,
    except leaves it passed through unchanged (the same tensor object):
    the condition under which a queued :func:`spill_async` of ``old``
    reads what it was asked to."""
    olds = {id(x): x for _, x in leaves_with_path(old)
            if isinstance(x, torch.Tensor)}
    ptrs = {x.untyped_storage().data_ptr(): p
            for p, x in leaves_with_path(old) if isinstance(x, torch.Tensor)}
    for path, x in leaves_with_path(new):
        if not isinstance(x, torch.Tensor) or id(x) in olds:
            continue
        hit = ptrs.get(x.untyped_storage().data_ptr())
        if hit is not None:
            raise RuntimeError(
                f"{what}: new leaf {path} writes into the storage of "
                f"{hit}, which a checkpoint spill may still be reading")


def spill(bundle: Bundle) -> Any:
    """MEMORY_AND_DISK eviction: the bundle's data on the host."""
    return to_host(bundle.data)


def _readmit(host_tree: Any, device) -> Any:
    dev = torch.device(device)

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(dev, copy=True)

    return tree_map(put, host_tree)


def restore(bundle: Bundle, host_data: Any) -> Bundle:
    """Re-admit spilled data onto the bundle's device."""
    return bundle.with_data(_readmit(host_data, bundle.device))


def spill_bundle(bundle: Bundle) -> Dict[str, Any]:
    """The full state as ``{"data", "replicated"}`` — the checkpoint
    payload of ``solve`` (the replicated side is part of the iterate for
    learners whose broadcast state rides the carry, as SCDL's does).
    The leaves stay device tensors: the checkpoint writer spills them
    (:func:`spill_async`)."""
    return {"data": bundle.data, "replicated": bundle.replicated}


def bundle_shard(bundle: Bundle) -> Dict[str, Any]:
    """The checkpoint layout of :func:`spill_bundle`'s payload: this
    rank's shard index among the bundle's partitions, whether it writes
    (the first replica of its partition does), and for every data leaf
    its record axis and the rank's records ``[lo, hi)`` of all of them.
    Without a mesh: one shard of all the records."""
    lo, hi = bundle.record_range
    total = bundle.n_total if bundle.n_total is not None else hi
    return {"index": bundle.axes.rank, "count": bundle.n_partitions,
            "write": bundle.axes.lead,
            "records": {label(("data", k)): [bundle.record_axis(k), lo, hi,
                                             total]
                        for k in bundle.data}}


def readmit_replicated(bundle: Bundle, host_tree: Any) -> Any:
    """A replicated host tree back on the bundle's device."""
    return _readmit(host_tree, bundle.device)


def readmit_state(bundle: Bundle, host_state: Any) -> Any:
    """Inverse of :func:`spill_bundle` for a host copy."""
    return _readmit(host_state, bundle.device)


# --------------------------------------------------------------------
# Batched (solve_many) helpers.  A bucket's state tree {"d", "r"[,
# "last"]} carries the instance axis on every leaf, at the axis given by
# a matching tree of ints (``axes``; 0 where none is given): a leaf
# stored scale-major, (J, n, ...) per instance, is (J, B, n, ...) in the
# bucket.
# --------------------------------------------------------------------

def _axis(axes, path) -> int:
    a = axes
    for k in path:
        if not isinstance(a, dict):
            break
        a = a.get(k, 0)
    return a if isinstance(a, int) else 0


def map_with_axes(fn, tree, axes, path=()):
    """``fn(leaf, instance_axis)`` over the leaves of a batched tree."""
    if isinstance(tree, dict):
        return {k: map_with_axes(fn, v, axes, path + (k,))
                for k, v in tree.items()}
    return fn(tree, _axis(axes, path))


def readmit_batched(device, host_state: Any) -> Any:
    """A batched host state tree back on ``device``."""
    return _readmit(host_state, device)


def scatter_batched(host_state: Any, slots: Sequence[int], total: int,
                    axes: Optional[Any] = None) -> Any:
    """A compacted batched host state expanded to the full bucket: row
    ``slots[s]`` of the output takes compacted slice ``s``; rows not
    covered stay zero (the caller fills them from retired spills).
    Checkpoints always use the full layout, so restoring does not depend
    on when re-compaction happened."""
    idx = torch.as_tensor(np.asarray(slots), dtype=torch.int64)

    def scatter(x, a):
        shape = list(x.shape)
        shape[a] = total
        out = torch.zeros(shape, dtype=x.dtype)
        out.index_copy_(a, idx, x)
        return out

    return map_with_axes(scatter, host_state, axes or {})


def slice_instance(host_state: Any, row: int,
                   axes: Optional[Any] = None) -> Any:
    """One instance's slice of a batched host state (a copy)."""
    return map_with_axes(lambda x, a: x.select(a, row).clone(), host_state,
                          axes or {})


def set_instance(host_state: Any, row: int, inst: Any,
                 axes: Optional[Any] = None) -> None:
    """Write one instance's slices into a batched host state in place."""
    for (path, dst), (_, src) in zip(leaves_with_path(host_state),
                                     leaves_with_path(inst)):
        dst.select(_axis(axes or {}, path), row).copy_(src)
