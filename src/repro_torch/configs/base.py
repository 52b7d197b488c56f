"""Config system: architecture + shape + mesh + run configs.

Every assigned architecture gets one file in this package defining
``config()`` (the exact assigned full-scale config) and ``smoke_config()``
(a reduced same-family config for CPU smoke tests). Selection is by
``--arch <id>`` through :func:`repro.configs.registry.get_config`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts sub-config (Gimbal's EP-side technique applies here)."""

    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # expert FFN hidden dim
    n_shared_experts: int = 0    # always-on shared experts (Llama-4 style)
    d_shared: int = 0            # shared-expert FFN hidden dim
    moe_every: int = 1           # every n-th layer is MoE (1 = all layers)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent sub-config (xLSTM, Hymba's mamba heads)."""

    state_dim: int = 0           # per-channel SSM state (mamba) size
    conv_width: int = 4
    expand: int = 2              # d_inner = expand * d_model
    slstm_every: int = 0         # xLSTM: every n-th block is sLSTM (0 = none)
    chunk_size: int = 128        # chunkwise-parallel scan chunk


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. All dims are the *assigned* full-scale values."""

    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> derived d_model // n_heads

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # attention variants
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    sliding_window: int = 0      # window size for local layers (0 = none)
    local_global_ratio: int = 0  # n local layers per 1 global (0 = all global)

    # encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0

    # modality frontend: "tokens" feeds token ids through the embedding table;
    # "embeddings" (vlm/audio stubs) feeds precomputed frame/patch embeddings.
    input_mode: str = "tokens"

    norm_eps: float = 1e-6
    post_norms: bool = False     # gemma2/3: post-attention/post-ffn norms
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # whether this arch can hold a 500k-token KV (sub-quadratic / windowed);
    # pure full-attention archs skip the long_500k cell (see DESIGN.md).
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived ----
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_moe_layer(self, layer_idx: int) -> bool:
        if not self.moe.enabled:
            return False
        return (layer_idx % self.moe.moe_every) == (self.moe.moe_every - 1)

    @property
    def n_moe_layers(self) -> int:
        return sum(1 for i in range(self.n_layers) if self.is_moe_layer(i))

    def is_local_layer(self, layer_idx: int) -> bool:
        """Local(sliding-window) vs global attention pattern (gemma2/3, hymba)."""
        if self.local_global_ratio <= 0 or self.sliding_window <= 0:
            return False
        # ratio r means r local layers then 1 global, repeating.
        return (layer_idx % (self.local_global_ratio + 1)) != self.local_global_ratio

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and memory math)."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d

        if self.family == "encdec":
            enc = self.enc_layers * (attn + 3 * d * self.d_ff + 2 * d)
            dec = self.dec_layers * (2 * attn + 3 * d * self.d_ff + 3 * d)
            return embed + head + enc + dec

        if self.family == "ssm":  # xLSTM: blocks own their projections
            per = 0
            for i in range(self.n_layers):
                if self.ssm.slstm_every and (i % self.ssm.slstm_every
                                             == self.ssm.slstm_every - 1):
                    # sLSTM: 4-gate input proj + block-diag recurrence + ffn
                    per += 4 * d * d + 4 * d * hd + 3 * d * (-(-4 * d // 3))
                else:
                    # mLSTM: up/gate (2x d->2d) + q,k (2d->2d) + out (2d->d)
                    per += 14 * d * d + 2 * d * self.n_heads
            return embed + head + per

        ffn_dense = 3 * d * self.d_ff
        per_layer = []
        for i in range(self.n_layers):
            p = attn
            if self.family == "hybrid" and self.ssm.state_dim:
                d_in = self.ssm.expand * d
                p += d * (2 * d_in) + d_in * d + d_in * (
                    self.ssm.conv_width + 2 * self.ssm.state_dim + 2)
            if self.is_moe_layer(i):
                m = self.moe
                p += d * m.n_experts  # router
                p += m.n_experts * 3 * d * m.d_expert
                p += m.n_shared_experts * 3 * d * m.d_shared
            else:
                p += ffn_dense
            per_layer.append(p)
        return embed + head + sum(per_layer)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.moe.enabled:
            return self.param_count()
        full = self.param_count()
        m = self.moe
        inactive = self.n_moe_layers * (m.n_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; choose from {[s.name for s in SHAPES]}")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build a smoke-test variant of a config (same family, tiny dims)."""
    return dataclasses.replace(cfg, **overrides)
