"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (kv=8) vocab=202048, MoE 128e top-1.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. Assigned d_ff=8192 is the
routed-expert FFN dim. To hit the 400B-total / 17B-active budget the family
interleaves MoE every other layer (moe_every=2) with a 16384-dim dense FFN on
non-MoE layers and one always-on shared expert (8192) on MoE layers; these two
choices are recorded here because the assignment line does not pin them.
Early-fusion multimodality is treated as token-input LM (text backbone).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=16384,                    # dense-layer FFN (interleaved)
        vocab_size=202048,
        head_dim=128,
        moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192,
                      n_shared_experts=1, d_shared=8192, moe_every=2),
        rope_theta=500000.0,
        supports_long_context=False,   # full-attention stack -> long_500k skipped
    )


def smoke_config() -> ModelConfig:
    return reduced(
        config(),
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=1, d_expert=96,
                      n_shared_experts=1, d_shared=96, moe_every=2),
    )
