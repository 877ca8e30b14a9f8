"""AdamW with optional ZeRO-1 optimizer-state partitioning.

Port of ``repro.optim.adamw``, over dict trees of tensors.  Model
params live in bf16 (compute dtype); the optimizer holds an fp32 master
copy and fp32 moments.  ZeRO-1 is expressed through partition specs
(:func:`opt_pspecs`): each data-parallel rank owns a slice of the
optimizer state, which ``parallel.sharding`` turns into placements.

The update is out of place, as the JAX version is: it returns new
tensors and writes into none of its inputs.  It makes no host sync: the
clip, the bias corrections and the learning rate stay 0-d fp32 tensors
on the step's device, so ``lr_scale`` may be the tensor that
``optim.schedule.warmup_cosine`` returns for the device step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.compat import P
from repro_torch.core.persistence import tree_map
from repro_torch.kernels.common import resolve_device


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _leaves(tree) -> list:
    """The leaves of a dict tree in ``jax.tree.leaves`` order (keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def adamw_init(params) -> Dict[str, Any]:
    """fp32 master + moments, matching the param tree; the step on the
    params' device (``"cuda"`` for an empty tree)."""
    # copy=True: with fp32 params, .to would return the same tensor, and
    # the master must not alias the params
    f32 = lambda p: p.to(torch.float32, copy=True)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    leaves = _leaves(params)
    dev = leaves[0].device if leaves else resolve_device(None)
    return {
        "master": tree_map(f32, params),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_update(grads, opt_state, params, cfg: AdamWConfig,
                 lr_scale=1.0) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step. Returns (new bf16 params, new opt state, metrics).

    With fp32 params each new param is its new master tensor, as in the
    JAX version (nothing is written in place, so sharing is safe)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale

    def upd(g, m, v, master):
        g = g.to(torch.float32) * clip
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        update = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        master2 = master - lr * (update + cfg.weight_decay * master)
        return m2, v2, master2

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"],
                   opt_state["master"])
    new_m = tree_map(lambda o: o[0], out)
    new_v = tree_map(lambda o: o[1], out)
    new_master = tree_map(lambda o: o[2], out)
    new_params = tree_map(lambda ma, p: ma.to(p.dtype), new_master, params)
    new_state = {"master": new_master, "m": new_m, "v": new_v, "step": step}
    if isinstance(lr, torch.Tensor):
        lr = lr.to(torch.float32)
    else:
        # a fill on the device, not a copy from the host (which syncs)
        lr = torch.full((), lr, dtype=torch.float32, device=step.device)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def zero_assign(parts, dims, dp_axes: Tuple[str, ...], mesh_shape=None):
    """Shard the largest free dim over the largest dividing dp-axis
    subset (full tuple first, then single axes — odd dims like hymba's
    1600 can't divide 256 but do divide 16).  Mutates and returns parts;
    no-op when nothing divides.  An axis missing from ``mesh_shape``
    counts as 16, as in the JAX version."""
    sizes = dict(mesh_shape or {})
    candidates = [dp_axes] + [(a,) for a in dp_axes if len(dp_axes) > 1]
    for axes in candidates:
        k = 1
        for a in axes:
            k *= sizes.get(a, 16)
        best, best_sz = None, 0
        for i, (ax, n) in enumerate(zip(parts, dims)):
            if ax is None and n % max(k, 1) == 0 and n > best_sz:
                best, best_sz = i, n
        if best is not None:
            parts[best] = axes if len(axes) > 1 else axes[0]
            return parts
    return parts


def _map_specs(fn, specs, other):
    """``fn(spec, leaf)`` over a tree of specs (dicts and NamedTuples
    whose leaves are :class:`P` or ``None``) and the tree ``other`` of
    the same structure, whose leaves may themselves be tuples (shapes),
    as ``jax.tree.map`` with specs as leaves."""
    if specs is None or isinstance(specs, P):
        return fn(specs, other)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, other[k]) for k, v in specs.items()}
    if hasattr(specs, "_fields"):
        return type(specs)(*(_map_specs(fn, getattr(specs, f),
                                        getattr(other, f))
                             for f in specs._fields))
    raise TypeError(f"not a spec tree: {specs!r}")


def opt_pspecs(param_specs, param_shapes, dp_axes: Tuple[str, ...] = (),
               dp_size: int = 1, mesh_shape=None):
    """Optimizer-state specs: param spec + optional ZeRO-1 data-sharding.

    With ``dp_axes`` set, each fp32 state leaf additionally shards its
    largest still-unsharded, dp-divisible dimension over the data axes
    (small norm vectors that don't divide stay replicated — they are
    irrelevant to the footprint).  ``param_shapes`` holds shapes, or
    anything with a ``.shape`` (tensors, ``meta`` tensors).
    """
    def leafspec(spec, shape):
        if shape is None:
            return None
        dims = shape.shape if hasattr(shape, "shape") else shape
        parts = list(spec) if spec is not None else []
        parts += [None] * (len(dims) - len(parts))
        used = {a for p in parts if p is not None
                for a in (p if isinstance(p, tuple) else (p,))}
        free_axes = tuple(a for a in dp_axes if a not in used)
        if free_axes and dp_size > 1:
            zero_assign(parts, dims, free_axes, mesh_shape)
        return P(*parts)

    state_spec = _map_specs(leafspec, param_specs, param_shapes)
    return {"master": state_spec, "m": state_spec, "v": state_spec,
            "step": P()}
