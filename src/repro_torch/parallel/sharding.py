"""Sharding rules: how every parameter / activation / cache maps onto the
production mesh (pod, data, model).

Port of ``repro.parallel.sharding``.  The rules are *functions of the
config*, not hand-written per arch:
  - attention projections are head-sharded over `model` iff the head count
    divides the model-axis size (hymba's 25 heads and granite-moe's 24
    don't — those attentions run with replicated weights and the model
    axis is carried by the mamba/MoE branch instead; see DESIGN.md §6);
  - KV projections shard iff n_kv_heads divides (MQA/GQA-2 replicate);
  - MoE experts shard over `model` (expert parallelism), padded up;
  - mamba inner channels shard over `model`;
  - batch shards over (pod, data); for batch-1 long-context decode the KV
    cache sequence axis shards over (pod, data) instead (sequence
    parallelism for the decode read).

The specs are :class:`repro_torch.core.compat.P`.  Computing them reads
only the mesh's axis names and sizes (``compat.mesh_shape``), so they
can be computed for a production mesh from any object with
``mesh_dim_names`` and ``mesh.shape`` (as JAX's ``AbstractMesh``), and
no spec function touches a process group.  A spec becomes a
:class:`Placement` on a real ``DeviceMesh`` (:meth:`MeshRules.sharding`):
the port is SPMD, so where JAX lays a global array out over devices,
each rank keeps its own block of a full tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import NO_AXES, P, axes_of, block_range, \
    mesh_shape
from repro_torch.optim.adamw import zero_assign


class Placement:
    """This rank's block of a full tensor under a spec: each dimension
    that the spec splits keeps the block of this rank's index along the
    dimension's axes (over their product for a tuple of axes, the first
    axis major, as JAX lays them out); axes the spec leaves out
    replicate.  ``axes`` holds one ``compat.Axes`` per entry of the spec
    (``NO_AXES`` for ``None``): their ``size`` and ``rank`` are all a
    placement reads."""

    def __init__(self, spec: P, axes):
        self.spec = spec
        self.axes = tuple(axes)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The block of ``x``, a tensor of its own when any dimension is
        split (the full tensor can then be freed), else ``x`` itself;
        ``ValueError`` when a split dimension does not divide."""
        if len(self.axes) > x.dim():
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"the {x.dim()} dimensions of the tensor")
        block = x
        for dim, axes in enumerate(self.axes):
            lo, hi = block_range(x.shape[dim], axes)
            if hi - lo != x.shape[dim]:
                block = block.narrow(dim, lo, hi - lo)
        return x if block is x else block.clone()

    def __repr__(self) -> str:
        return f"Placement({self.spec!r}, {self.axes!r})"


@dataclass(frozen=True)
class MeshRules:
    mesh: Optional[Any]               # a DeviceMesh, or names and sizes
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("pod", "data")
    shard_cache_seq: bool = False     # long_500k: shard KV seq over dp
    seq_shard_activations: bool = False  # SP stash: shard residual d over tp
    fsdp: bool = False                # ZeRO-3: shard params over dp too
    dp_only: bool = False             # small-model remap: batch over ALL
    #   mesh axes, params replicated (no TP) — §Perf/D.  FSDP composes.

    @property
    def tp(self) -> int:
        if self.mesh is None or self.dp_only:
            return 1
        return mesh_shape(self.mesh)[self.tp_axis]

    @property
    def t_ax(self) -> Optional[str]:
        """tp axis name for activation specs (None under dp_only)."""
        return None if self.dp_only else self.tp_axis

    @property
    def dp(self) -> Tuple[str, ...]:
        """dp axes actually present in the mesh (single-pod has no 'pod')."""
        if self.mesh is None:
            return ()
        sizes = mesh_shape(self.mesh)
        axes = self.dp_axes + ((self.tp_axis,) if self.dp_only else ())
        return tuple(a for a in axes if a in sizes)

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        sizes = mesh_shape(self.mesh)
        n = 1
        for a in self.dp:
            n *= sizes[a]
        return n

    def sharding(self, spec: P) -> Optional[Placement]:
        """The :class:`Placement` of ``spec`` on the mesh, or ``None``
        without one.  Collective on first use of an entry's axes
        (``compat.axes_of`` builds their process group): every rank
        calls this with the same specs in the same order."""
        if self.mesh is None:
            return None
        dims = list(self.mesh.mesh_dim_names or ())
        axes = []
        for entry in spec:
            names = () if entry is None else \
                entry if isinstance(entry, tuple) else (entry,)
            order = [dims.index(a) for a in names if a in dims]
            if order != sorted(order):
                raise ValueError(f"spec entry {entry!r}: a placement takes "
                                 f"the axes in the mesh's order {dims}")
            axes.append(axes_of(self.mesh, names) if names else NO_AXES)
        return Placement(spec, axes)

    def cs(self, x, spec: P):
        """``x`` itself: the JAX version constrains a traced array's
        sharding for XLA's partitioner; here each rank already holds its
        block, and there is no partitioner to instruct."""
        return x

    # ---------------- canonical activation specs ----------------------
    def batch_spec(self, extra_dims: int = 1) -> P:
        dp = self.dp
        return P(dp if dp else None, *([None] * extra_dims))

    def act_spec(self, cfg: ModelConfig) -> P:
        """Residual stream (B, S, d)."""
        dp = self.dp
        d_ax = (self.tp_axis if self.seq_shard_activations
                and not self.dp_only and
                cfg.d_model % max(self.tp, 1) == 0 else None)
        return P(dp if dp else None, None, d_ax)


def head_shardable(n_heads: int, tp: int) -> bool:
    return n_heads > 0 and n_heads % tp == 0


def for_mesh(mesh, **kw) -> MeshRules:
    return MeshRules(mesh=mesh, **kw)


# ---------------------------------------------------------------------
# Parameter partition specs, by path
# ---------------------------------------------------------------------

def param_pspecs(cfg: ModelConfig, rules: MeshRules, params_tree):
    """Spec tree matching ``params_tree`` (anything with ``.shape``:
    tensors, ``meta`` tensors).

    Leaf dispatch is by dict path; every leaf under "layers" carries a
    leading stacked-layer axis (never sharded).
    """
    tp = rules.tp
    t = rules.tp_axis if not rules.dp_only else None
    heads_ok = head_shardable(cfg.n_heads, tp) and t is not None
    kv_ok = head_shardable(cfg.n_kv_heads, tp) and t is not None

    def spec_for(path: Tuple[str, ...], ndim: int) -> P:
        name = path[-1]
        in_layers = "layers" in path
        L = (None,) if in_layers else ()

        if name == "embed":
            # vocab-sharded in both tied and untied cases (the JAX
            # version's choice, which avoids an XLA partitioner bug with
            # sequence-sharded activations)
            return P(t, None)
        if name == "head":
            return P(None, t)               # logits vocab-sharded
        if "norm" in name or name in ("ln1", "ln2"):
            return P(*L, *([None] * (ndim - len(L))))
        if name in ("conv_b", "dt_bias", "D"):   # (L, dI): shard channels
            return P(*L, t)
        # attention
        if name == "wq":
            return P(*L, None, t if heads_ok else None)
        if name in ("wk", "wv"):
            return P(*L, None, t if kv_ok else None)
        if name == "wo":
            return P(*L, t if heads_ok else None, None)
        # mamba (dI always divides tp: dI = 2*d_model, d_model % tp == 0)
        if name == "in_proj":
            return P(*L, None, t)
        if name == "conv_w":
            return P(*L, None, t)
        if name == "x_proj":
            return P(*L, t, None)
        if name == "dt_proj":
            return P(*L, None, t)
        if name == "A_log":
            return P(*L, t, None)
        if name == "out_proj":
            return P(*L, t, None)
        # moe
        if name == "router":
            return P(*L, None, None)
        if name in ("we1", "we3", "we2"):
            return P(*L, t, None, None)     # expert-parallel
        if name in ("ws1", "ws3"):
            return P(*L, None, t)
        if name == "ws2":
            return P(*L, t, None)
        # dense ffn
        if name in ("w1", "w3"):
            return P(*L, None, t)
        if name == "w2":
            return P(*L, t, None)
        raise ValueError(f"no sharding rule for param {'/'.join(path)}")

    def fsdp_refine(spec: P, shape) -> P:
        """ZeRO-3/FSDP: additionally shard the largest still-free,
        dp-divisible dim of every big leaf over the data axes (falling
        back to a single dp axis for odd dims — see optim.zero_assign)."""
        dims = shape.shape if hasattr(shape, "shape") else shape
        n_elems = 1
        for d in dims:
            n_elems *= d
        if n_elems < (1 << 20) or not rules.dp:  # small leaves replicate
            return spec
        parts = list(spec) + [None] * (len(dims) - len(spec))
        zero_assign(parts, dims, rules.dp,
                    mesh_shape(rules.mesh) if rules.mesh is not None
                    else None)
        return P(*parts)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if node is None:
            return None
        if hasattr(node, "_fields"):        # NamedTuple
            return type(node)(*(walk(getattr(node, f), path + (f,))
                                for f in node._fields))
        spec = spec_for(path, len(node.shape))
        if rules.fsdp and "layers" in path:
            spec = fsdp_refine(spec, node)
        return spec

    return walk(params_tree, ())


def cache_pspecs(cfg: ModelConfig, rules: MeshRules, cache_tree,
                 batch_size: int):
    """Specs for the decode cache {k, v, conv, ssm} (leading layer axis)."""
    t = rules.tp_axis if not rules.dp_only else None
    dp = rules.dp
    kv_ok = head_shardable(cfg.n_kv_heads, rules.tp) and t is not None
    batch_ok = dp and batch_size % max(rules.dp_size, 1) == 0
    b_ax = dp if batch_ok else None
    seq_ax = dp if (rules.shard_cache_seq and not batch_ok) else None

    specs = {}
    for name, leaf in cache_tree.items():
        if leaf is None:
            specs[name] = None
        elif name in ("k", "v"):            # (L, B, T, K, hd)
            if kv_ok:
                kv_ax, t_seq = t, None
            else:
                # kv heads don't divide the model axis (MQA/GQA-2/8):
                # shard the SEQUENCE axis over `model` instead — split-KV
                # flash-decode semantics.  Otherwise a 32k cache
                # replicates 16x and blows HBM.
                kv_ax, t_seq = None, t
            specs[name] = P(None, b_ax, seq_ax or t_seq, kv_ax, None)
        elif name in ("k_scale", "v_scale"):  # (L, B, T, K)
            kv_ax2, t_seq2 = (t, None) if kv_ok else (None, t)
            specs[name] = P(None, b_ax, seq_ax or t_seq2, kv_ax2)
        elif name == "conv":                # (L, B, dc-1, dI)
            specs[name] = P(None, b_ax, None, t)
        elif name == "ssm":                 # (L, B, dI, dS)
            specs[name] = P(None, b_ax, t, None)
        else:
            raise ValueError(name)
    return specs
