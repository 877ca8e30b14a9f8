"""Model-shape dataclasses of the sharding and data substrate.

Port of ``repro.configs.base``, a copy of every name in it (``LAYER_*``,
``MoEConfig``, ``SSMConfig``, ``ModelConfig``, ``ShapeConfig`` and
``_param_count``), unchanged: that module imports no JAX, but the port
imports nothing of the JAX package.  ``parallel/sharding`` and
``data/`` type against ``ModelConfig``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# --------------------------------------------------------------------------
# Model configuration
# --------------------------------------------------------------------------

LAYER_GLOBAL = "global"      # full causal attention
LAYER_LOCAL = "local"        # sliding-window causal attention
LAYER_MAMBA = "mamba"        # attention-free mamba-1 mixer
LAYER_HYBRID = "hybrid"      # parallel attention + mamba heads (hymba)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0               # routed experts
    top_k: int = 0
    n_shared_experts: int = 0        # always-on experts (deepseek)
    capacity_factor: float = 1.25    # per-expert buffer = T*k*cf/E
    router_jitter: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    expand: int = 2
    d_conv: int = 4
    dt_rank: int = 0                 # 0 -> ceil(d_model / 16)
    chunk: int = 256                 # selective-scan chunk length
    fused: bool = False              # in-body discretisation (see §Perf)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or max(1, math.ceil(d_model / 16))


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free archs)
    n_kv_heads: int
    d_ff: int                        # dense FFN dim, or per-expert dim for MoE
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0    # separate theta for local layers (gemma3); 0 -> rope_theta
    sliding_window: int = 0          # window for LAYER_LOCAL layers
    local_global_ratio: int = 0      # k -> pattern of k local layers then 1 global; 0 -> all global
    global_layers: Tuple[int, ...] = ()   # explicit global-attn layer ids (hymba style)
    logit_softcap: float = 0.0
    # ssm / hybrid
    ssm: Optional[SSMConfig] = None
    attn_free: bool = False          # falcon-mamba: every layer LAYER_MAMBA
    hybrid: bool = False             # hymba: every layer LAYER_HYBRID
    # moe
    moe: MoEConfig = field(default_factory=MoEConfig)
    # modality frontend:  token | embed (precomputed patch/frame embeddings stub)
    frontend: str = "token"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    source: str = ""                 # provenance note
    notes: str = ""

    # ---------------- derived -------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def layer_kind(self, i: int) -> str:
        """Mixer kind of layer ``i`` (static python)."""
        if self.attn_free:
            return LAYER_MAMBA
        if self.hybrid:
            return LAYER_HYBRID
        if self.global_layers:
            return LAYER_GLOBAL if i in self.global_layers else LAYER_LOCAL
        if self.local_global_ratio > 0:
            # pattern: r local layers then 1 global, repeating (gemma3: 5:1)
            return (
                LAYER_GLOBAL
                if (i % (self.local_global_ratio + 1)) == self.local_global_ratio
                else LAYER_LOCAL
            )
        return LAYER_GLOBAL

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.n_layers))

    @property
    def uses_attention(self) -> bool:
        return not self.attn_free

    @property
    def uses_ssm(self) -> bool:
        return self.attn_free or self.hybrid

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the 500k-context decode shape.

        True when no layer keeps an unbounded full-attention KV cache
        (SSM/hybrid archs) or when full-attention layers are a bounded
        minority mixed with windowed layers (gemma3's 5:1 local:global —
        the global-layer KV is sequence-sharded; see DESIGN.md).
        """
        if self.attn_free or self.hybrid:
            return True
        return self.local_global_ratio > 0 and self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (total, including embeddings)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts)."""
        return _param_count(self, active_only=True)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    total = cfg.vocab_size * d                       # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d                  # lm head
    total += d                                       # final norm
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        total += 2 * d                               # two pre-norms
        if kind in (LAYER_GLOBAL, LAYER_LOCAL, LAYER_HYBRID):
            q = d * cfg.n_heads * hd
            kv = 2 * d * cfg.n_kv_heads * hd
            o = cfg.n_heads * hd * d
            total += q + kv + o
            if cfg.qk_norm:
                total += 2 * hd
        if kind in (LAYER_MAMBA, LAYER_HYBRID) and cfg.ssm is not None:
            di = cfg.ssm.expand * d
            dtr = cfg.ssm.resolved_dt_rank(d)
            total += d * 2 * di                      # in_proj (x, z)
            total += di * cfg.ssm.d_conv             # depthwise conv
            total += di * (dtr + 2 * cfg.ssm.d_state)  # x_proj
            total += dtr * di + di                   # dt_proj (+bias)
            total += di * cfg.ssm.d_state + di       # A_log, D
            total += di * d                          # out_proj
        if kind != LAYER_MAMBA:                      # FFN present
            if cfg.moe.enabled:
                n_routed = cfg.moe.top_k if active_only else cfg.moe.n_experts
                total += n_routed * 3 * d * cfg.d_ff
                total += cfg.moe.n_shared_experts * 3 * d * cfg.d_ff
                total += d * cfg.moe.n_experts       # router
            else:
                total += 3 * d * cfg.d_ff            # SwiGLU w1,w3,w2
    return total


# --------------------------------------------------------------------------
# Input shapes (assigned to the LM family; every arch pairs with all four,
# modulo the documented skips)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch
