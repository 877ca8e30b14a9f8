"""How a Problem's instances batch — the declaration only.

Port of ``repro.core.batching.BatchAxes``.  The port has no
``solve_many`` yet (ROADMAP A10); ``Problem.batch_axes()`` still
returns this declaration so a workload names the constructor state its
``init_bundle`` reads (the contract lint rule RPL801 checks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union


@dataclass(frozen=True)
class BatchAxes:
    """A Problem's declaration of how its instances batch.

    - ``record_axes``: which axis of each raw input is the record axis.
      A single int broadcasts over all inputs; a tuple gives one entry
      per input, with ``None`` for non-array inputs.
    - ``pad_records=False`` opts a workload out of record padding.
    - ``shared_in_batch``: top-level keys of the bundle's replicated
      dict that are instance-independent.
    - ``instance_invariant``: constructor attributes read by
      ``init_bundle`` that are declared identical across instances.
    """
    record_axes: Union[int, Tuple[Optional[int], ...]] = 0
    pad_records: bool = True
    shared_in_batch: Tuple[str, ...] = ()
    instance_invariant: Tuple[str, ...] = ()
