"""Encoder-decoder transformer (the seamless-m4t backbone).

The encoder takes precomputed frame embeddings (the speech frontend is a
stand-in) through ``enc_in`` and runs non-causal self-attention; the
decoder takes text tokens with causal self-attention and cross-attention
over the encoder's output, whose K/V ``prefill`` computes once into the
cache (``xk``, ``xv``). Layers are stacked ``(n_layers, ...)`` per leaf as
the reference's ``vmap``-ed init gives them, and a Python loop walks them.
All attention here is the plain ``models/attention.py::flash_attention``,
as in the reference (no kernel): decode too, over the whole ring. The cache
is written in place and also returned. ``loss_fn`` trains the decoder over
the encoded frames (decoder mode "train": no cache).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import require_one_rank
from repro_torch.models.attention import flash_attention, ring_positions
from repro_torch.models.layers import (cross_entropy, dense_init,
                                       embed_tokens, init_embed, init_mlp,
                                       lm_logits, mlp, rms_norm, torch_dtype)
from repro_torch.models.transformer import (_qkv, init_attention,
                                            layer_views, stacked_layers)


def _init_enc_layer(cfg, kw):
    return {
        "ln_attn": torch.zeros(cfg.d_model, device=kw["device"]),
        "attn": init_attention(cfg, **kw),
        "ln_ffn": torch.zeros(cfg.d_model, device=kw["device"]),
        "mlp": init_mlp(cfg.d_model, cfg.d_ff, torch_dtype(cfg.dtype), **kw),
    }


def _init_dec_layer(cfg, kw):
    return {
        "ln_attn": torch.zeros(cfg.d_model, device=kw["device"]),
        "attn": init_attention(cfg, **kw),
        "ln_cross": torch.zeros(cfg.d_model, device=kw["device"]),
        "cross": init_attention(cfg, **kw),
        "ln_ffn": torch.zeros(cfg.d_model, device=kw["device"]),
        "mlp": init_mlp(cfg.d_model, cfg.d_ff, torch_dtype(cfg.dtype), **kw),
    }


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda"):
    kw = dict(generator=generator, device=device)
    return {
        "embed": init_embed(cfg, **kw),
        "enc_in": dense_init((cfg.d_model, cfg.d_model), 0,
                             torch_dtype(cfg.dtype), **kw),
        "enc": stacked_layers(lambda: _init_enc_layer(cfg, kw),
                              cfg.enc_layers),
        "dec": stacked_layers(lambda: _init_dec_layer(cfg, kw),
                              cfg.dec_layers),
        "enc_norm": torch.zeros(cfg.d_model, device=device),
        "final_norm": torch.zeros(cfg.d_model, device=device),
    }


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None] \
        .expand(B, S)


def encode(params, cfg: ModelConfig, embeddings):
    """embeddings: (B, S_src, D) stand-in frame features -> the encoder's
    states (B, S_src, D)."""
    x = embeddings.to(torch_dtype(cfg.dtype)) @ params["enc_in"]
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    layer = layer_views(params["enc"])
    for i in range(cfg.enc_layers):
        lp = layer(i)
        xn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q, k, v = _qkv(lp["attn"], cfg, xn, positions)
        out = flash_attention(q, k, v, q_pos=positions, k_pos=positions,
                              causal=False)
        x = x + out.reshape(B, S, cfg.q_dim) @ lp["attn"]["wo"]
        x = x + mlp(lp["mlp"], rms_norm(x, lp["ln_ffn"], cfg.norm_eps))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_dtype: str = "bfloat16", device="cuda"):
    """Decoder self-attention K/V (``k``, ``v``) and the cross K/V of the
    encoder's output (``xk``, ``xv``), each (dec_layers, batch, max_len,
    Hkv, hd) in the model dtype, whatever ``kv_dtype`` (the reference keeps
    the encoder-decoder's caches in the model dtype)."""
    del kv_dtype
    shape = (cfg.dec_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg.dtype)
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name in ("k", "v", "xk", "xv")}


def _dec_layer(lp, c, cfg, x, positions, enc_out, enc_positions, mode):
    """One decoder layer; ``c`` is its cache slice (None in "train")."""
    B, S, _ = x.shape
    # self attention
    xn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = _qkv(lp["attn"], cfg, xn, positions)
    if mode in ("train", "prefill"):
        out = flash_attention(q, k, v, q_pos=positions, k_pos=positions,
                              causal=True)
        if mode == "prefill":
            c["k"][:, :S] = k
            c["v"][:, :S] = v
    else:
        L = c["k"].shape[1]
        pos = positions[:, 0]
        bidx = torch.arange(B, device=x.device)
        slot = (pos % L).long()
        c["k"][bidx, slot] = k[:, 0]
        c["v"][bidx, slot] = v[:, 0]
        out = flash_attention(q, c["k"], c["v"], q_pos=positions,
                              k_pos=ring_positions(pos, L), causal=True)
    x = x + out.reshape(B, S, cfg.q_dim) @ lp["attn"]["wo"]

    # cross attention
    xn = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
    qx = (xn @ lp["cross"]["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if mode == "decode":
        xk, xv = c["xk"], c["xv"]
    else:
        xk = (enc_out @ lp["cross"]["wk"]).reshape(
            B, -1, cfg.n_kv_heads, cfg.head_dim)
        xv = (enc_out @ lp["cross"]["wv"]).reshape(
            B, -1, cfg.n_kv_heads, cfg.head_dim)
        if mode == "prefill":
            c["xk"][:, :xk.shape[1]] = xk
            c["xv"][:, :xv.shape[1]] = xv
    outx = flash_attention(qx, xk, xv, q_pos=positions, k_pos=enc_positions,
                           causal=False)
    x = x + outx.reshape(B, S, cfg.q_dim) @ lp["cross"]["wo"]
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln_ffn"], cfg.norm_eps))


def _dec_stack(params, cfg, x, positions, cache, enc_out, enc_positions,
               mode):
    """The decoder's layers in ``mode`` "train" (S tokens at positions
    0..S-1, no cache; each layer recomputed in the backward, as the
    reference's ``jax.checkpoint``), "prefill" (the same, the cross K/V of
    ``enc_out`` written at slots [0, S_src)) or "decode" (one token at
    ``positions``, written at slot pos % L; the cross K/V read from the
    cache, slots masked by ``enc_positions`` < 0). The cache is written in
    place."""
    layer = layer_views(params["dec"])
    for i in range(cfg.dec_layers):
        args = (layer(i), None if cache is None else
                {name: t[i] for name, t in cache.items()}, cfg, x, positions,
                enc_out, enc_positions, mode)
        x = checkpoint(_dec_layer, *args, use_reentrant=False) \
            if mode == "train" else _dec_layer(*args)
    return x, cache


def loss_fn(params, cfg: ModelConfig, batch, *, placement=None,
            policy=None, aux_weight: float = 0.0, ragged: bool = True):
    """batch: {embeddings (B, S_src, D), tokens (B, S), labels (B, S), mask
    optional} -> (loss, {"ce", "aux"}): the token cross-entropy of the
    decoder over the encoded frames; no aux loss. The routing keywords are
    accepted and unused."""
    require_one_rank(policy, f"{cfg.name}: loss_fn")
    enc_out = encode(params, cfg, batch["embeddings"])
    B, S_src = enc_out.shape[:2]
    x = embed_tokens(params["embed"], cfg, batch["tokens"])
    S = x.shape[1]
    x, _ = _dec_stack(params, cfg, x, _positions(B, S, x.device), None,
                      enc_out, _positions(B, S_src, x.device), "train")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params["embed"], cfg, x)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=x.device)}


def prefill(params, cfg: ModelConfig, batch, cache, *, placement=None,
            source_ids=None, n_sources: int = 0, policy=None,
            collect_stats: bool = True, ragged: bool = True):
    """batch: {embeddings (B, S_src, D), tokens (B, S), lengths (B,)
    optional} -> (logits at each row's last real token (B, V), cache,
    None). The routing keywords are accepted and unused."""
    require_one_rank(policy, f"{cfg.name}: prefill")
    enc_out = encode(params, cfg, batch["embeddings"])
    B, S_src = enc_out.shape[:2]
    x = embed_tokens(params["embed"], cfg, batch["tokens"])
    S = x.shape[1]
    x, cache = _dec_stack(params, cfg, x, _positions(B, S, x.device), cache,
                          enc_out, _positions(B, S_src, x.device), "prefill")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    lengths = batch.get("lengths")
    if lengths is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(B, device=x.device),
                 torch.clamp(lengths.long() - 1, 0, S - 1)]
    return lm_logits(params["embed"], cfg, last), cache, None


def decode_step(params, cfg: ModelConfig, tokens, cache, lengths, *,
                placement=None, source_ids=None, n_sources: int = 0,
                policy=None, collect_stats: bool = True, ragged: bool = True,
                enc_lengths=None):
    """tokens (B,) at positions ``lengths`` (B,) -> (logits (B, V), cache,
    None). ``enc_lengths`` (B,) masks the cross-KV slots at or past each
    row's encoder length (never written); without it every slot of the
    cross cache is attended, as in the reference."""
    require_one_rank(policy, f"{cfg.name}: decode_step")
    x = embed_tokens(params["embed"], cfg, tokens[:, None])
    B = x.shape[0]
    positions = lengths.to(torch.int32)[:, None]
    enc_positions = _positions(B, cache["xk"].shape[2], x.device)
    if enc_lengths is not None:
        enc_positions = torch.where(
            enc_positions < enc_lengths.to(x.device)[:, None], enc_positions,
            torch.full_like(enc_positions, -1))
    x, cache = _dec_stack(params, cfg, x, positions, cache, None,
                          enc_positions, "decode")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params["embed"], cfg, x[:, 0]), cache, None
