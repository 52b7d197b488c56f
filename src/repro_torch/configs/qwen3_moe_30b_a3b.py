"""qwen3-moe-30b-a3b [moe] — 48L d=2048 32H (kv=4) d_ff=768 vocab=151936, 128e top-8.

[hf:Qwen/Qwen3-30B-A3B; hf]. This is the model the Gimbal paper itself serves
(Qwen3-30B-A3B on 4xH100): the reference architecture for all paper-claim
benchmarks. d_ff=768 is the per-expert FFN dim; every layer is MoE. qk_norm is
a Qwen3-family trait and is kept.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=768,                      # also the expert dim (all layers MoE)
        vocab_size=151936,
        head_dim=128,                  # Qwen3 uses explicit head_dim=128
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=768, moe_every=1),
        qk_norm=True,
        rope_theta=1000000.0,
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return reduced(
        config(),
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=48, vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=48, moe_every=1),
    )
