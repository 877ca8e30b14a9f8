"""Pad-and-bucket planning for batched multi-instance solves.

Port of ``repro.core.batching``.  ``solve_many`` (``core.problem``)
stacks compatible instances along an instance axis and runs one batched
step per iteration across all of them.  This module owns the planning
half of that path:

- group instances whose *static* signature matches (same per-input
  dtypes and non-record shape dims);
- within a group, pad each instance's record axis up to a shared bucket
  capacity, within a padding budget (``waste_budget`` bounds the share
  of padded rows per bucket, so a 5-record instance never rides in a
  4096-capacity bucket);
- emit deterministic bucket keys (a hash of the problem's config salt,
  the static signature, the capacity and the membership), so each
  bucket's checkpoint directory is stable across runs and resumable.
  The keys are the port's own: they need not equal the JAX package's.

Planning is numpy and hashlib only; :func:`pad_tree_records` and
:func:`stack_trees` take tensors.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch


@dataclass(frozen=True)
class BatchAxes:
    """A Problem's declaration of how its instances batch.

    - ``record_axes``: which axis of each raw input is the record axis.
      A single int broadcasts over all inputs; a tuple gives one entry
      per input, with ``None`` for inputs that carry no records (such as
      the optional trailing dict of an instance's own random draws).
    - ``pad_records=False`` opts a workload out of record padding:
      instances then bucket only with exact record-count matches.
    - ``shared_in_batch``: top-level keys of the bundle's replicated
      dict that are instance-independent, stored once per bucket.
    - ``instance_invariant``: constructor attributes read by
      ``init_bundle`` that are declared identical across instances.
    """
    record_axes: Union[int, Tuple[Optional[int], ...]] = 0
    pad_records: bool = True
    shared_in_batch: Tuple[str, ...] = ()
    instance_invariant: Tuple[str, ...] = ()

    def axis_for(self, i: int) -> Optional[int]:
        if isinstance(self.record_axes, tuple):
            if i >= len(self.record_axes):
                raise ValueError(
                    f"BatchAxes.record_axes declares {len(self.record_axes)} "
                    f"inputs but instance has more (input #{i})")
            return self.record_axes[i]
        return self.record_axes


@dataclass(frozen=True)
class Bucket:
    """One planned bucket: a set of instances run by one batched step.

    ``indices`` are positions into the original instance list (the
    planner's output preserves a total assignment: every instance lands
    in exactly one bucket).  ``records[j]`` is the true record count of
    ``indices[j]``; all are padded to ``capacity`` at stacking time.
    ``key`` is deterministic across runs for identical inputs — the
    per-bucket checkpoint directory name hangs off it.
    """
    key: str
    capacity: int
    indices: Tuple[int, ...]
    records: Tuple[int, ...]
    signature: Tuple = field(repr=False, default=())

    @property
    def waste(self) -> float:
        """Fraction of padded (dead) rows in the stacked bucket."""
        total = self.capacity * len(self.indices)
        return (total - sum(self.records)) / total if total else 0.0


def _leaf_sig(x: Any, axis: Optional[int]) -> Tuple:
    arr = np.asarray(x) if not hasattr(x, "shape") else x
    shape = tuple(arr.shape)
    dtype = str(arr.dtype)
    if axis is None:
        return (dtype, shape)
    ax = axis % len(shape) if shape else 0
    if not shape:
        raise ValueError(
            f"record axis {axis} declared for a scalar input")
    masked = shape[:ax] + ("N",) + shape[ax + 1:]
    return (dtype, masked)


def instance_records(instance: Sequence, axes: BatchAxes) -> int:
    """Record count of one instance; every input carrying a record axis
    must agree."""
    counts = []
    for i, x in enumerate(instance):
        ax = axes.axis_for(i)
        if ax is None:
            continue
        arr = np.asarray(x) if not hasattr(x, "shape") else x
        if not arr.shape:
            raise ValueError(
                f"input #{i}: record axis {ax} declared for a scalar")
        counts.append(int(arr.shape[ax % len(arr.shape)]))
    if not counts:
        raise ValueError(
            "instance declares no record axes — nothing to batch over")
    if len(set(counts)) > 1:
        raise ValueError(
            f"instance inputs disagree on record count: {counts}")
    return counts[0]


def static_signature(instance: Sequence, axes: BatchAxes) -> Tuple:
    """Hashable per-instance signature of everything that must be equal
    for two instances to share one batched step: per-input dtypes and
    every shape dim except the (padded) record axis."""
    return tuple(_leaf_sig(x, axes.axis_for(i))
                 for i, x in enumerate(instance))


def bucket_key(salt: str, signature: Tuple, capacity: int,
               members: Sequence[Tuple[int, int]]) -> str:
    """Deterministic 12-hex-digit bucket id.  ``members`` is the
    ``(index, records)`` list; the key pins the exact membership so a
    resumed run refuses a checkpoint written under a different plan."""
    desc = f"{salt}|{signature!r}|cap={capacity}|{sorted(members)!r}"
    return hashlib.sha1(desc.encode()).hexdigest()[:12]


def plan_buckets(instances: Sequence[Sequence], axes: BatchAxes, *,
                 waste_budget: float = 0.25,
                 salt: str = "") -> List[Bucket]:
    """Partition ``instances`` into buckets.

    Greedy first-fit-decreasing within each static-signature group:
    instances are placed largest-first, each into the first open bucket
    whose capacity fits and whose post-placement padding fraction stays
    within ``waste_budget``; otherwise a new bucket opens at the
    instance's own record count.  ``waste_budget=0`` degenerates to
    exact-size buckets.  With ``axes.pad_records`` False the record
    count joins the signature, so only exact matches share a bucket.

    The returned list is deterministically ordered (largest stacked
    workload first) and covers every instance exactly once.
    """
    if not 0.0 <= waste_budget < 1.0:
        raise ValueError(
            f"waste_budget must be in [0, 1), got {waste_budget}")
    groups = {}
    for idx, inst in enumerate(instances):
        n = instance_records(inst, axes)
        sig = static_signature(inst, axes)
        if not axes.pad_records:
            sig = sig + (("records", n),)
        groups.setdefault(sig, []).append((idx, n))

    out: List[Bucket] = []
    for sig in sorted(groups, key=repr):
        members = sorted(groups[sig], key=lambda t: (-t[1], t[0]))
        open_: List[dict] = []
        for idx, n in members:
            placed = False
            for b in open_:
                pad = sum(b["cap"] - m_n for _, m_n in b["items"])
                pad += b["cap"] - n
                if pad <= waste_budget * b["cap"] * (len(b["items"]) + 1):
                    b["items"].append((idx, n))
                    placed = True
                    break
            if not placed:
                # descending order guarantees cap >= every later n
                open_.append({"cap": n, "items": [(idx, n)]})
        for b in open_:
            items = sorted(b["items"])
            out.append(Bucket(
                key=bucket_key(salt, sig, b["cap"], items),
                capacity=b["cap"],
                indices=tuple(i for i, _ in items),
                records=tuple(n for _, n in items),
                signature=sig))
    out.sort(key=lambda b: (-b.capacity * len(b.indices), b.key))
    return out


# --------------------------------------------------------------------
# Incremental (open-bucket) planning — the serving admission question
# --------------------------------------------------------------------

class OpenBucket:
    """One still-admitting bucket of an :class:`OpenBucketPlanner`.

    Unlike :func:`plan_buckets` (which sees the whole population and
    packs largest-first, so a bucket's capacity is fixed at its first
    member), an open bucket admits members in *arrival* order: its
    capacity grows to the largest member seen so far, and every
    admission re-checks the waste rule under the candidate capacity —
    the same ``pad <= waste_budget * capacity * n_members`` boundary
    the offline planner uses (exactly-at-budget admits; one-over opens
    a new bucket).
    """

    __slots__ = ("signature", "capacity", "members", "waste_budget",
                 "max_members", "deadlines")

    def __init__(self, signature: Tuple, waste_budget: float,
                 max_members: Optional[int] = None):
        self.signature = signature
        self.capacity = 0
        self.members: List[Tuple[Any, int]] = []   # (token, records)
        self.waste_budget = float(waste_budget)
        self.max_members = max_members
        # token -> absolute deadline (per-request deadline_s): the
        # scheduler arms its coalescing timer against the earliest one
        # so a tight-deadline member never waits out the whole window
        self.deadlines: Dict[Any, float] = {}

    def try_admit(self, token, records: int) -> bool:
        """Admit ``token`` if the post-admission padding fraction stays
        within the waste budget (capacity may grow to ``records``)."""
        if self.max_members is not None \
                and len(self.members) >= self.max_members:
            return False
        cap = max(self.capacity, int(records))
        pad = sum(cap - n for _, n in self.members) + (cap - records)
        if pad > self.waste_budget * cap * (len(self.members) + 1):
            return False
        self.capacity = cap
        self.members.append((token, int(records)))
        return True

    def remove(self, token) -> bool:
        """Withdraw a member (request cancellation); the capacity
        shrinks back to the largest remaining member."""
        for j, (t, _) in enumerate(self.members):
            if t == token:
                del self.members[j]
                self.deadlines.pop(token, None)
                self.capacity = max((n for _, n in self.members),
                                    default=0)
                return True
        return False

    @property
    def earliest_deadline(self) -> Optional[float]:
        """The soonest member deadline, or ``None`` when no member has
        one — the bound a deadline-aware scheduler dispatches by."""
        return min(self.deadlines.values()) if self.deadlines else None

    def __len__(self) -> int:
        return len(self.members)


class OpenBucketPlanner:
    """Streaming counterpart of :func:`plan_buckets`.

    A serving frontend cannot plan over the whole population — requests
    arrive one at a time and the scheduler's question is incremental:
    *can this request ride an already-open bucket within the waste
    budget, or does it open a new one?*  ``offer`` answers it with the
    same signature-grouping and padding rule as the offline planner;
    ``close`` seals an open bucket into a :class:`Bucket` whose key is
    computed by the same :func:`bucket_key` (membership is sorted, so
    the key is independent of arrival order).

    Tokens are caller-chosen hashable ids (the service uses monotonic
    ints, so ``Bucket.indices`` ordering matches admission order after
    the sort).  The planner is not thread-safe; the asyncio service
    drives it from its event loop only.
    """

    def __init__(self, axes: BatchAxes, *, waste_budget: float = 0.25,
                 salt: str = "", max_members: Optional[int] = None):
        if not 0.0 <= waste_budget < 1.0:
            raise ValueError(
                f"waste_budget must be in [0, 1), got {waste_budget}")
        self.axes = axes
        self.waste_budget = float(waste_budget)
        self.salt = salt
        self.max_members = max_members
        self._open: List[OpenBucket] = []

    def offer(self, token, instance: Sequence, *,
              deadline: Optional[float] = None) -> OpenBucket:
        """Place one instance: first open bucket of matching signature
        with budget headroom, else a fresh bucket.  Returns the (still
        open) bucket the instance joined.  ``deadline`` (absolute time)
        is recorded on the bucket for deadline-aware dispatch."""
        n = instance_records(instance, self.axes)
        sig = static_signature(instance, self.axes)
        if not self.axes.pad_records:
            sig = sig + (("records", n),)
        for b in self._open:
            if b.signature == sig and b.try_admit(token, n):
                if deadline is not None:
                    b.deadlines[token] = float(deadline)
                return b
        b = OpenBucket(sig, self.waste_budget, self.max_members)
        b.try_admit(token, n)       # sole member: pad 0, always admits
        if deadline is not None:
            b.deadlines[token] = float(deadline)
        self._open.append(b)
        return b

    def discard(self, bucket: OpenBucket, token) -> None:
        """Withdraw a member; an emptied bucket closes unreported."""
        bucket.remove(token)
        if not bucket.members and bucket in self._open:
            self._open.remove(bucket)

    def close(self, bucket: OpenBucket) -> Bucket:
        """Seal an open bucket for dispatch.  The resulting key matches
        what :func:`plan_buckets` would emit for the same membership."""
        self._open.remove(bucket)
        items = sorted(bucket.members)
        return Bucket(
            key=bucket_key(self.salt, bucket.signature, bucket.capacity,
                           items),
            capacity=bucket.capacity,
            indices=tuple(t for t, _ in items),
            records=tuple(n for _, n in items),
            signature=bucket.signature)

    def drain(self) -> List[Bucket]:
        """Close every open bucket (service shutdown / deadline flush)."""
        return [self.close(b) for b in list(self._open)]

    @property
    def open_buckets(self) -> Tuple[OpenBucket, ...]:
        return tuple(self._open)


# --------------------------------------------------------------------
# Stacking (on built per-instance bundles)
# --------------------------------------------------------------------

def pad_tree_records(tree: Mapping[str, torch.Tensor], capacity: int,
                     axes: Optional[Mapping[str, int]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Zero-pad the record axis of every leaf to ``capacity``.

    ``axes`` names the leaves whose record axis is not 0 (a bundle's
    ``record_axes``).  Padding goes onto the built bundle, never the raw
    inputs: derived state (operator norms, step sizes) must be the
    unpadded single solve's, and zero records are inert through every
    built-in step."""
    out = {}
    for k, x in tree.items():
        a = (axes or {}).get(k, 0)
        n = x.shape[a]
        if n > capacity:
            raise ValueError(f"leaf {k!r} has {n} records, exceeds bucket "
                             f"capacity {capacity}")
        if n < capacity:
            shape = list(x.shape)
            shape[a] = capacity - n
            x = torch.cat([x, x.new_zeros(shape)], dim=a)
        out[k] = x
    return out


def stack_trees(trees: Sequence[Mapping[str, Any]],
                axes: Optional[Mapping[str, int]] = None) -> Dict[str, Any]:
    """Stack per-instance trees along a new instance axis, inserted at
    each leaf's record axis (``axes``; 0 by default): (n, ...) leaves
    become (B, n, ...), a scale-major (J, n, ...) one (J, B, n, ...).
    Nested dicts stack leaf by leaf."""
    out = {}
    for k, v in trees[0].items():
        if isinstance(v, Mapping):
            out[k] = stack_trees([t[k] for t in trees])
        else:
            out[k] = torch.stack([t[k] for t in trees],
                                 dim=(axes or {}).get(k, 0))
    return out
