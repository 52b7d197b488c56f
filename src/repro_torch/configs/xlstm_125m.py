"""xlstm-125m [ssm] — 12L d=768 4H vocab=50304, sLSTM + mLSTM blocks.

[arXiv:2405.04517; unverified]. d_ff=0: xLSTM blocks carry their own up/down
projections (pre-up-projection mLSTM with pf=2, post-FFN sLSTM with pf=4/3).
Block ratio follows the paper's 7:1 family: one sLSTM block every 6 (layers 5
and 11 are sLSTM, rest mLSTM) — the exact positions are a documented choice
since the assignment line pins only counts. Recurrent state is O(1) per token,
so long_500k runs (this is the arch where sub-quadratic decode matters most).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        head_dim=192,
        ssm=SSMConfig(slstm_every=6, chunk_size=128),
        tie_embeddings=True,
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return reduced(
        config(),
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        vocab_size=256, ssm=SSMConfig(slstm_every=2, chunk_size=16),
    )
