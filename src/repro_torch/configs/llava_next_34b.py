"""llava-next-34b [vlm] — 60L d=7168 56H (kv=8) d_ff=20480 vocab=64000.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. The assignment specifies
the transformer BACKBONE only (Yi-34B-class decoder); the anyres-tiled vision
frontend is a STUB: input_specs() provides precomputed patch embeddings
(input_mode="embeddings"), concatenated ahead of text embeddings by the
serving layer. Pure full-attention stack -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        head_dim=128,
        rope_theta=5000000.0,
        input_mode="embeddings",
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return reduced(
        config(),
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
    )
