"""Atomic, checksummed, asynchronous checkpoints.  Port of
``repro.checkpoint.checkpointer``.

Layout (one directory per step)::

    <dir>/step_000123.tmp/...   -> atomic rename -> <dir>/step_000123/
        manifest.json            tree structure, shapes, dtypes, crc32s, meta
        leaf_000000.npy ...      one .npy per leaf

- atomic: a reader never sees a partial checkpoint (write ``.tmp``,
  then rename);
- checked: the manifest carries a crc32 per leaf; :func:`validate_checkpoint`
  re-checks the files without loading them, and :func:`latest_valid_step`
  scans newest to oldest, so a torn newest checkpoint falls back to the
  one before it;
- asynchronous: :meth:`Checkpointer.save_async` starts the copy off the
  card (``core.persistence.spill_async``: pinned memory and one CUDA
  event) and writes on a background thread, which waits on the event;
  the calling thread does not wait for the device;
- self-describing: the manifest's ``meta`` (workload and config
  fingerprint) is checked on restore;
- sharded under a mesh: with ``shard=`` (``core.persistence.bundle_shard``)
  each rank writes its own block of records into
  ``<dir>/step_000123/shard_00002/`` (the same ``.tmp`` then rename),
  the manifest giving each record leaf's axis and the block's range
  among all records.  No collective and no barrier: the ranks write
  independently, and a step is complete only when all of its shards
  exist with good checksums, so :func:`latest_valid_step` passes over a
  step some rank has not finished.  :func:`restore` with ``records=``
  assembles any range of records from whichever shards hold it: a
  checkpoint written by 4 ranks restores under 1 or 2 (the port's
  counterpart of restoring onto other shardings in the JAX package).
  A checkpoint written without a mesh is one shard of all the records.

Trees are nested dicts of tensors (or numpy arrays), flattened in sorted
key order; ``treedef`` records the structure as a string.  bf16 leaves,
which numpy cannot hold, are stored as their int16 bits with dtype
``"bfloat16"`` in the manifest.  A checkpoint written by the JAX package
need not load here, nor the reverse.

Fault injection (``resilience.chaos``): ``ckpt_write`` raises at the top
of :func:`save`, ``ckpt_corrupt`` truncates a leaf file after the
manifest's checksums are written and before the rename — a torn write
that validation must catch.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import persistence
from repro_torch.core.checks import label, leaves_with_path, structure
from repro_torch.resilience import chaos as _chaos


class CheckpointError(RuntimeError):
    """Base class for checkpoint persistence failures."""


class CheckpointWriteError(CheckpointError):
    """A checkpoint write failed (surfaced from the writer thread too)."""


class CheckpointCorruptError(CheckpointError):
    """An on-disk checkpoint failed integrity validation."""


def _crc32_file(path: Path) -> int:
    crc = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(block, crc)
    return crc


def _as_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array written to disk, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _piece_dir(directory: Path, step: int, shard: Optional[dict]) -> Path:
    root = directory / f"step_{step:08d}"
    if shard is not None and shard["count"] > 1:
        return root / f"shard_{shard['index']:05d}"
    return root


def save(directory, step: int, tree, *, meta: Optional[dict] = None,
         shard: Optional[dict] = None) -> Optional[Path]:
    """Synchronous atomic write of a host tree (a crc32 per leaf in the
    manifest; chaos fault points ``ckpt_write`` and ``ckpt_corrupt``).

    ``shard`` (``core.persistence.bundle_shard``): ``{"index", "count",
    "write", "records": {leaf label: [axis, lo, hi, total]}}`` — this
    rank's shard of the step; a rank with ``write`` false (a replica of
    another rank's records) writes nothing and returns ``None``."""
    if shard is not None and not shard.get("write", True):
        return None
    _chaos.maybe_raise("ckpt_write", step=step)
    directory = Path(directory)
    final = _piece_dir(directory, step, shard)
    tmp = final.with_name(final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = list(leaves_with_path(tree))
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": structure(tree), "meta": meta or {},
                "time": time.time(), "leaves": []}
    records = {}
    if shard is not None:
        manifest["shard"] = {"index": int(shard["index"]),
                             "count": int(shard["count"])}
        records = shard.get("records", {})
    for i, (path, leaf) in enumerate(leaves):
        arr, dtype = _as_numpy(leaf)
        fpath = tmp / f"leaf_{i:06d}.npy"
        np.save(fpath, arr)
        entry = {"path": label(path), "shape": list(arr.shape),
                 "dtype": dtype, "crc32": _crc32_file(fpath)}
        if label(path) in records:
            entry["records"] = [int(v) for v in records[label(path)]]
        manifest["leaves"].append(entry)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    # a writer killed mid-flight: the damaged files are still renamed
    # into place, the hazard validation guards against
    _chaos.corrupt_checkpoint_files("ckpt_corrupt", tmp, step=step)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _saved_steps(directory: Path) -> List[int]:
    if not directory.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and not p.name.endswith(".tmp"))


def latest_step(directory) -> Optional[int]:
    steps = _saved_steps(Path(directory))
    return max(steps) if steps else None


def _pieces(root: Path) -> List[Path]:
    """The directories a step's leaves live in: the step itself, or its
    finished shards in index order."""
    if (root / "manifest.json").exists() or not root.is_dir():
        return [root]
    shards = sorted(p for p in root.iterdir()
                    if p.is_dir() and p.name.startswith("shard_")
                    and not p.name.endswith(".tmp"))
    return shards or [root]


def validate_checkpoint(directory, step: int) -> Optional[str]:
    """``None`` when the saved step is intact, else the reason: a missing
    or unreadable manifest, a missing leaf file, a crc32 mismatch, or a
    shard of a sharded step not (yet) written."""
    root = Path(directory) / f"step_{step:08d}"
    pieces = _pieces(root)
    count = 1
    for piece in pieces:
        reason = _validate_piece(piece)
        if reason is not None:
            return f"{piece.name}: {reason}" if piece != root else reason
        shard = json.loads((piece / "manifest.json").read_text()).get(
            "shard")
        count = shard["count"] if shard else 1
    if pieces != [root]:
        names = [p.name for p in pieces]
        want = [f"shard_{i:05d}" for i in range(count)]
        if names != want:
            return (f"{len(names)} of {count} shards written "
                    f"({sorted(set(want) - set(names))} missing)")
    return None


def _validate_piece(root: Path) -> Optional[str]:
    mpath = root / "manifest.json"
    if not mpath.exists():
        return "manifest.json missing"
    try:
        manifest = json.loads(mpath.read_text())
    except (json.JSONDecodeError, OSError) as e:
        return f"manifest unreadable: {e}"
    entries = manifest.get("leaves", [])
    if manifest.get("n_leaves") != len(entries):
        return (f"manifest lists {len(entries)} leaves, "
                f"declares n_leaves={manifest.get('n_leaves')}")
    for i, entry in enumerate(entries):
        path = root / f"leaf_{i:06d}.npy"
        if not path.exists():
            return f"leaf {i} missing"
        want = entry.get("crc32")
        if want is not None and _crc32_file(path) != want:
            return f"leaf {i} crc32 mismatch"
    return None


def latest_valid_step(directory, at_most: Optional[int] = None
                      ) -> Tuple[Optional[int], List[int]]:
    """The newest step (no later than ``at_most``, when given) that
    passes :func:`validate_checkpoint`, and the newer steps skipped as
    corrupt."""
    skipped: List[int] = []
    for step in reversed(_saved_steps(Path(directory))):
        if at_most is not None and step > at_most:
            continue
        if validate_checkpoint(directory, step) is None:
            return step, skipped
        skipped.append(step)
    return None, skipped


def _rebuild(like, leaves: Iterator):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _load_leaf(pieces, manifests, i: int, records) -> np.ndarray:
    """Leaf ``i``: from the first piece, or, for a record leaf, records
    ``[lo, hi)`` (default: all) gathered from the shards holding them."""
    rec = manifests[0]["leaves"][i].get("records")
    if rec is None:
        return np.load(pieces[0] / f"leaf_{i:06d}.npy")
    axis, total = rec[0], rec[3]
    lo, hi = records if records is not None else (0, total)
    parts = []
    for piece, m in zip(pieces, manifests):
        _, plo, phi, _ = m["leaves"][i]["records"]
        a, b = max(lo, plo), min(hi, phi)
        if a < b:
            arr = np.load(piece / f"leaf_{i:06d}.npy", mmap_mode="r")
            index = [slice(None)] * arr.ndim
            index[axis] = slice(a - plo, b - plo)
            parts.append((a, np.array(arr[tuple(index)])))
    parts.sort(key=lambda p: p[0])
    got = sum(p[1].shape[axis] for p in parts)
    if got != hi - lo:
        raise ValueError(f"leaf {manifests[0]['leaves'][i]['path']}: the "
                         f"shards hold {got} of records [{lo}, {hi})")
    return np.concatenate([p[1] for p in parts], axis=axis)


def restore(directory, step: int, like, *, device=None,
            expect_meta: Optional[Callable[[dict], bool]] = None,
            records: Optional[Tuple[int, int]] = None):
    """Load a saved step into the structure of ``like``.

    Tensor leaves of ``like`` give the shape, dtype and device of the
    restored tensors (``device`` overrides the device, as for ``meta``
    templates); numpy leaves come back as numpy arrays.  The record
    leaves of a checkpoint written with ``shard=`` come back whole, or
    as records ``[lo, hi)`` of them with ``records=(lo, hi)`` (this
    rank's block under a mesh), from whichever shards hold them.
    Returns ``(tree, manifest)``."""
    reason = validate_checkpoint(directory, step)
    if reason is not None:
        raise CheckpointCorruptError(
            f"checkpoint step {step} under {str(directory)!r} failed "
            f"integrity validation ({reason}); run latest_valid_step() to "
            f"locate an intact fallback")
    pieces = _pieces(Path(directory) / f"step_{step:08d}")
    manifests = [json.loads((p / "manifest.json").read_text())
                 for p in pieces]
    manifest = manifests[0]
    if expect_meta is not None and not expect_meta(manifest["meta"]):
        raise ValueError(f"manifest meta check failed: {manifest['meta']}")
    refs = list(leaves_with_path(like))
    if len(refs) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves; current tree "
            f"has {len(refs)} — config mismatch")
    out = []
    for i, ((path, ref), entry) in enumerate(zip(refs,
                                                 manifest["leaves"])):
        arr = _load_leaf(pieces, manifests, i, records)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {label(path)}: saved {arr.shape} != "
                             f"{tuple(ref.shape)}")
        if isinstance(ref, torch.Tensor):
            t = torch.from_numpy(arr)
            if entry.get("dtype") == "bfloat16":
                t = t.view(torch.bfloat16)
            dev = device if device is not None else ref.device
            out.append(t.to(device=dev, dtype=ref.dtype))
        else:
            out.append(arr)
    return _rebuild(like, iter(out)), manifest


class Checkpointer:
    """Asynchronous checkpoints with retention (the newest ``keep``).

    A failure on the writer thread is kept and raised as
    :class:`CheckpointWriteError` at the next synchronisation point —
    :meth:`wait`, the next :meth:`save` or :meth:`save_async`, or
    :meth:`close`.  ``spill_seconds`` and ``write_seconds`` record, per
    checkpoint, the calling thread's time to queue the copy off the card
    and the writer thread's time to wait for it and write the files."""

    def __init__(self, directory, *, keep: int = 3,
                 meta: Optional[dict] = None, shard: Optional[dict] = None):
        self.directory = Path(directory)
        self.keep = keep
        self.meta = meta or {}
        self.shard = shard
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps: list = []
        self.spill_seconds: List[float] = []
        self.write_seconds: List[float] = []

    def _record_failure(self, exc: BaseException) -> None:
        """The writer thread's exception router: keep the failure for
        :meth:`_raise_pending` at the next synchronisation point (the
        ``CheckpointWriteError`` raised there chains it)."""
        self._error = exc

    def _raise_pending(self):
        if self._error is not None:
            exc, self._error = self._error, None
            raise CheckpointWriteError(
                f"async checkpoint write failed: "
                f"{type(exc).__name__}: {exc}") from exc

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def save_async(self, step: int, tree):
        """Queue the copy off the card and write on a background thread;
        the calling thread does not wait for the device.  A rank that
        holds a replica of another rank's shard writes nothing."""
        self.wait()
        if self.shard is not None and not self.shard.get("write", True):
            return
        t0 = time.perf_counter()
        host, event = persistence.spill_async(tree)
        self.spill_seconds.append(time.perf_counter() - t0)

        def _write():
            try:
                t1 = time.perf_counter()
                # poll rather than synchronize: the copies finish behind
                # the device work queued before them, and this thread
                # holds no lock any other thread needs meanwhile
                while event is not None and not event.query():
                    time.sleep(1e-3)
                save(self.directory, step, host, meta=self.meta,
                     shard=self.shard)
                self.saved_steps.append(step)
                self._gc()
                self.write_seconds.append(time.perf_counter() - t1)
            except BaseException as e:  # surfaces via _raise_pending
                self._record_failure(e)

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def save(self, step: int, tree):
        self.wait()
        save(self.directory, step, persistence.to_host(tree),
             meta=self.meta, shard=self.shard)
        self.saved_steps.append(step)
        self._gc()

    def close(self):
        """Drain the writer thread and raise any pending failure."""
        self.wait()

    def _gc(self):
        for s in _saved_steps(self.directory)[:-self.keep] \
                if self.keep else []:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)
