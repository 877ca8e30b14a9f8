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
  fingerprint) is checked on restore.

Trees are nested dicts of tensors (or numpy arrays), flattened in sorted
key order; ``treedef`` records the structure as a string.  bf16 leaves,
which numpy cannot hold, are stored as their int16 bits with dtype
``"bfloat16"`` in the manifest.  A checkpoint written by the JAX package
need not load here, nor the reverse.

The JAX package's fault-injection points (``ckpt_write``,
``ckpt_corrupt``) belong to the resilience layer, which the port has not
taken over yet.
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


def save(directory, step: int, tree, *, meta: Optional[dict] = None
         ) -> Path:
    """Synchronous atomic write of a host tree (a crc32 per leaf in the
    manifest)."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = list(leaves_with_path(tree))
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": structure(tree), "meta": meta or {},
                "time": time.time(), "leaves": []}
    for i, (path, leaf) in enumerate(leaves):
        arr, dtype = _as_numpy(leaf)
        fpath = tmp / f"leaf_{i:06d}.npy"
        np.save(fpath, arr)
        manifest["leaves"].append(
            {"path": label(path), "shape": list(arr.shape), "dtype": dtype,
             "crc32": _crc32_file(fpath)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
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


def validate_checkpoint(directory, step: int) -> Optional[str]:
    """``None`` when the saved step is intact, else the reason: a missing
    or unreadable manifest, a missing leaf file, or a crc32 mismatch."""
    root = Path(directory) / f"step_{step:08d}"
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


def latest_valid_step(directory) -> Tuple[Optional[int], List[int]]:
    """The newest step that passes :func:`validate_checkpoint`, and the
    newer steps skipped as corrupt."""
    skipped: List[int] = []
    for step in reversed(_saved_steps(Path(directory))):
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


def restore(directory, step: int, like, *, device=None,
            expect_meta: Optional[Callable[[dict], bool]] = None):
    """Load a saved step into the structure of ``like``.

    Tensor leaves of ``like`` give the shape, dtype and device of the
    restored tensors (``device`` overrides the device, as for ``meta``
    templates); numpy leaves come back as numpy arrays.  Returns
    ``(tree, manifest)``."""
    reason = validate_checkpoint(directory, step)
    if reason is not None:
        raise CheckpointCorruptError(
            f"checkpoint step {step} under {str(directory)!r} failed "
            f"integrity validation ({reason}); run latest_valid_step() to "
            f"locate an intact fallback")
    root = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((root / "manifest.json").read_text())
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
        arr = np.load(root / f"leaf_{i:06d}.npy")
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
                 meta: Optional[dict] = None):
        self.directory = Path(directory)
        self.keep = keep
        self.meta = meta or {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps: list = []
        self.spill_seconds: List[float] = []
        self.write_seconds: List[float] = []

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
        the calling thread does not wait for the device."""
        self.wait()
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
                save(self.directory, step, host, meta=self.meta)
                self.saved_steps.append(step)
                self._gc()
                self.write_seconds.append(time.perf_counter() - t1)
            except BaseException as e:  # raised at the next sync point
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def save(self, step: int, tree):
        self.wait()
        save(self.directory, step, persistence.to_host(tree),
             meta=self.meta)
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
