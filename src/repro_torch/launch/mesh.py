"""Device meshes over the process group that is already initialized.

Port of ``repro.launch.mesh``.  The JAX package builds a ``Mesh`` over
the devices one process sees; the port runs one process per device
(``torchrun``, or any spawner that calls
``torch.distributed.init_process_group``), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of those ranks with named
dimensions.  These functions never initialize a process group, and
importing this module touches no device and no group: only a call does.

``device=None`` means ``"cuda"`` (the group is then NCCL's, one card
per rank: the rank's card is chosen here from ``LOCAL_RANK``); it raises
on a host without a card.  ``device="cpu"`` is for gloo groups, as the
tests use.  A gloo group over CUDA tensors (``device="cuda"`` under
``init_process_group("gloo")``) also works, and is how several ranks
share one card.

Each mesh also gets its control plane on the host
(``core.compat.control_of``): a gloo group over the same ranks (the
default group itself when that is gloo's), on which the supervisor's
votes and the service's dispatches travel without waiting for a card.
``make_mesh`` builds it with the mesh, so every rank enters its groups
in the same order.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _device_type(device) -> str:
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' (with "
                           "a gloo process group) to build a mesh on the "
                           "CPU")
    return kind


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None):
    """A mesh of ``shape`` with dimensions named ``axes`` over every rank
    of the initialized process group, ranks laid out row-major (as
    ``jax.make_mesh`` lays out devices)."""
    kind = _device_type(device)
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "call torch.distributed.init_process_group() "
                           "first (torchrun provides its address, world "
                           "size and rank)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.compat import control_of
    mesh = DeviceMesh(kind, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)
    control_of(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The JAX package's production shapes: (data=16, model=16), or
    (pod=2, data=16, model=16) with ``multi_pod``; raises unless the
    process group has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def smallest_mesh(device=None) -> Optional[object]:
    """A (data=N, model=1) mesh over every rank; ``None`` without a
    process group or with a single rank."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    if n == 1:
        return None
    return make_mesh((n, 1), ("data", "model"), device)
