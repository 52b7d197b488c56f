"""gemma2-2b [dense] — 26L d=2304 8H (kv=4) d_ff=9216 vocab=256000.

[arXiv:2408.00118; hf]. Local+global alternating attention (1:1, window 4096)
and logit softcapping (attn 50.0, final 30.0). The windowed layers keep only a
4096-token KV, so the long_500k decode cell runs for this arch.
"""
from repro_torch.configs.base import ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        d_ff=9216,
        vocab_size=256000,
        head_dim=256,                 # gemma2-2b uses head_dim 256
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        sliding_window=4096,
        local_global_ratio=1,         # alternate local/global
        post_norms=True,
        tie_embeddings=True,
        supports_long_context=True,   # windowed layers -> long_500k runs
    )


def smoke_config() -> ModelConfig:
    return reduced(
        config(),
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=16,
    )
