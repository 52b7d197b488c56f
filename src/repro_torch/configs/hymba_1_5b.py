"""hymba-1.5b [hybrid] — 32L d=1600 25H (kv=5) d_ff=5504 vocab=32001, ssm_state=16.

[arXiv:2411.13676; hf]. Parallel attention + mamba heads inside each layer:
both branches read the same layer input; outputs are branch-normalized and
averaged. Attention is sliding-window (1024) on most layers with 3 global
layers (first/middle/last — hymba's pattern), mamba branch expand=2 with
state 16. Meta-tokens are omitted (serving-orthogonal; noted in DESIGN.md).
SSM state + windowed KV keep memory bounded -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        head_dim=64,
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, chunk_size=128),
        sliding_window=1024,
        local_global_ratio=15,         # ~3 global layers out of 32
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return reduced(
        config(),
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=16, local_global_ratio=2,
        ssm=SSMConfig(state_dim=4, conv_width=4, expand=2, chunk_size=8),
    )
