"""qwen3-8b [dense] — 36L d=4096 32H (kv=8) d_ff=12288 vocab=151936.

[hf:Qwen/Qwen3-8B; hf]. qk_norm + GQA.
"""
from repro_torch.configs.base import ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12288,
        vocab_size=151936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1000000.0,
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return reduced(
        config(),
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
    )
