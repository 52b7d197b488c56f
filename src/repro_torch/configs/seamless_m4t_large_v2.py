"""seamless-m4t-large-v2 [audio] — enc-dec 24L d=1024 16H (kv=16) d_ff=8192 vocab=256206.

[arXiv:2308.11596; hf]. Encoder-decoder, multimodal. The assignment specifies
the transformer backbone only: the speech frontend is a STUB — input_specs()
provides precomputed frame embeddings for the encoder (input_mode=
"embeddings"); the text decoder consumes tokens. 24L is applied to each stack
(the v2-large family uses 24 encoder + 24 decoder layers). Enc-dec decode uses
the decoder KV cache + cached encoder output. Pure full attention ->
long_500k skipped (a 500k-frame audio context is also out of scope for the
backbone stub).
"""
from repro_torch.configs.base import ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="encdec",
        n_layers=48,                   # 24 enc + 24 dec
        enc_layers=24,
        dec_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        head_dim=64,
        input_mode="embeddings",
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return reduced(
        config(),
        n_layers=4, enc_layers=2, dec_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
    )
