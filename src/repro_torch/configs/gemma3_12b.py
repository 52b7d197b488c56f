"""gemma3-12b [dense] — 48L d=3840 16H (kv=8) d_ff=15360 vocab=262144.

[hf:google/gemma-3-1b-pt; unverified]. 5:1 local:global layer pattern
(window 1024), 128k context family; qk_norm per gemma3. The 5:1 windowed
pattern keeps most KV bounded, so long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        d_ff=15360,
        vocab_size=262144,
        head_dim=256,
        qk_norm=True,
        sliding_window=1024,
        local_global_ratio=5,          # 5 local : 1 global
        rope_theta=1000000.0,
        post_norms=True,
        tie_embeddings=True,
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return reduced(
        config(),
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=16,
    )
