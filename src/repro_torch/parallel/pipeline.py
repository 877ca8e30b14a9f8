"""GPipe-style pipeline parallelism over a ``stage`` mesh axis.  Port of
``repro.parallel.pipeline``.

The layer stack is split into S stages of L/S layers; microbatches flow
through a ring.  At step t of M + S - 1, stage 0 takes microbatch t,
every other stage the activations its predecessor sent at step t - 1;
each applies its block, the last stage records its output (from step
S - 1 on), and the activations move one stage along the ring
(``dist.batch_isend_irecv`` on the stage group, the JAX package's
``ppermute``).  The outputs are then summed over ``stage``, where only
the last stage's are non-zero, so every stage returns them (the JAX
function's ``psum`` at its end).

One process per device: every rank runs :func:`pipeline_apply` on its
own stage's parameters, as each shard does under ``shard_map`` in the
JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.core import compat


def pipeline_apply(layer_fn: Callable, stage_params, x_micro: torch.Tensor,
                   mesh, *, stage_axis: str = "stage") -> torch.Tensor:
    """Run the (M, mb, ...) microbatches ``x_micro`` (held by every
    stage; stage 0 consumes them in order) through the ring.
    ``layer_fn(params_block, x) -> x`` applies one stage's block;
    ``stage_params`` is this stage's.  Returns the (M, mb, ...) outputs
    of the last stage, in order, on every stage."""
    stage = compat.axes_of(mesh, (stage_axis,))
    n_stage = compat.axis_size(stage)
    stage_id = stage.rank
    M = x_micro.shape[0]
    ring = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype,
                       device=x_micro.device)
    outputs = torch.zeros_like(x_micro)
    for t in range(M + n_stage - 1):
        x_in = x_micro[min(t, M - 1)] if stage_id == 0 else ring
        y = layer_fn(stage_params, x_in)
        if t >= n_stage - 1 and stage_id == n_stage - 1:
            outputs[t - (n_stage - 1)] = y
        ring = compat.send_recv(y, stage, to=(stage_id + 1) % n_stage,
                                frm=(stage_id - 1) % n_stage)
    if stage_id != n_stage - 1:
        outputs = torch.zeros_like(outputs)
    return compat.psum(outputs, stage)


def make_pipelined_forward(layer_fn: Callable, mesh, *, n_micro: int,
                           stage_axis: str = "stage",
                           data_axes: Sequence[str] = ("data",)):
    """``forward(params_staged, x)`` with pipeline and data parallelism.

    ``params_staged``: a tensor or dict of tensors, each (S, L/S, ...),
    of which every rank uses its own stage's slice.  ``x``: the whole
    (B, ...) batch on every rank; each rank runs its block along
    ``data_axes`` as ``n_micro`` microbatches (the block divides by
    ``n_micro``).  Returns the whole (B, ...) output on every rank."""
    data = compat.axes_of(mesh, tuple(data_axes))
    stage = compat.axes_of(mesh, (stage_axis,))

    def own_stage(p):
        if isinstance(p, dict):
            return {k: own_stage(v) for k, v in p.items()}
        return p[stage.rank]

    def fwd(params_staged: Any, x: torch.Tensor) -> torch.Tensor:
        lo, hi = compat.block_range(x.shape[0], data)
        xloc = x[lo:hi]
        xm = xloc.reshape((n_micro, xloc.shape[0] // n_micro)
                          + tuple(xloc.shape[1:]))
        ym = pipeline_apply(layer_fn, own_stage(params_staged), xm, mesh,
                            stage_axis=stage_axis)
        return compat.all_gather(ym.reshape(xloc.shape), data)

    return fwd
