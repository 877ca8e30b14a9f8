"""Input pipeline with prefetch and sharded placement.

Port of ``repro.data.pipeline``.  A background thread makes the next
batches while the device computes and puts each on the loader's device;
under a mesh each rank keeps its block of the batch axis (the port is
SPMD: every rank makes the whole batch, as the JAX version's single host
does, and keeps its rows).

The worker thread works on the card's default stream, the stream the
consumer's work is on too, so a batch's memory is never reused under the
consumer and no event is needed.  Its copies from the host may wait for
the card: that blocks the worker, not the consumer.  Importing this
module starts no thread and touches no device.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable, Dict, Iterator

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import lm_batch
from repro_torch.kernels.common import resolve_device, to_device
from repro_torch.parallel.sharding import MeshRules


class _Failed:
    """What the worker queues when ``make_batch`` raised."""

    def __init__(self, error: BaseException):
        self.error = error


class PrefetchLoader:
    """Wrap a ``make_batch(step) -> dict`` fn with N-deep prefetch;
    iterating yields ``(step, batch)`` from ``start_step`` on.

    ``device`` (``None`` = ``"cuda"``) is resolved here, in the caller's
    thread, so the worker makes batches for the caller's card.  An error
    in ``make_batch`` is raised by ``next``.  :meth:`close` stops the
    worker and returns when it has ended."""

    def __init__(self, make_batch: Callable[[int], Dict], rules: MeshRules,
                 *, depth: int = 2, start_step: int = 0, device=None):
        self.make_batch = make_batch
        self.rules = rules
        self.depth = depth
        self.device = resolve_device(device)
        # the placements are built here: their first use of an axis is
        # collective (the axis's process group), which the worker must
        # not enter
        self._placements = None
        if rules.mesh is not None:
            self._placements = (rules.sharding(rules.batch_spec(1)),
                                rules.sharding(rules.batch_spec(2)))
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="prefetch-loader")
        self._thread.start()

    def _place(self, batch):
        batch = {k: to_device(v, self.device) for k, v in batch.items()}
        if self._placements is None:
            return batch
        shd, shd3 = self._placements
        return {k: (shd3 if v.ndim == 3 else shd)(v)
                for k, v in batch.items()}

    def _worker(self):
        card = torch.cuda.device(self.device) \
            if self.device.type == "cuda" else contextlib.nullcontext()
        try:
            with card:
                while not self._stop.is_set():
                    batch = self._place(self.make_batch(self._step))
                    self._q.put((self._step, batch))
                    self._step += 1
        except BaseException as e:      # handed to the consumer
            self._q.put(_Failed(e))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _Failed):
            raise item.error
        return item

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self):
        """Stop the worker: a put blocked on the full queue is freed by
        the drain, after which the worker sees the stop and ends."""
        self._stop.set()
        self._drain()
        self._thread.join()
        # what the worker queued between the drain and its end
        self._drain()


def lm_loader(cfg: ModelConfig, rules: MeshRules, *, batch: int, seq: int,
              seed: int = 0, start_step: int = 0, depth: int = 2,
              device=None) -> PrefetchLoader:
    """Deterministic LM token loader; resume = pass ``start_step``."""
    dev = resolve_device(device)
    return PrefetchLoader(
        lambda step: lm_batch(cfg, batch, seq, seed, step, device=dev),
        rules, depth=depth, start_step=start_step, device=dev)
