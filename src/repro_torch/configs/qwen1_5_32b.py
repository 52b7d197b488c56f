"""qwen1.5-32b [dense] — 64L d=5120 40H (kv=40, MHA) d_ff=27392 vocab=152064.

[hf:Qwen/Qwen1.5-0.5B; hf]. QKV bias, full multi-head attention (kv=40).
"""
from repro_torch.configs.base import ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        head_dim=128,
        qkv_bias=True,
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return reduced(
        config(),
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=160, vocab_size=256,
    )
