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

Under a policy over several ranks (the reference's ``shard_resid``,
``mlp(policy)`` and ``shard_kv_cache`` on the self and cross K/V) each
rank holds its rows of the batch, its spec's share of the params and its
block of the cache (``cache_specs_tree`` cuts ``xk``/``xv`` like ``k``/``v``:
rows over the batch axes, slots over ``kv_split_axes``). Attention and the
MLPs are tensor-parallel over ``model`` as in ``models/transformer.py``
(each rank its query heads, K/V gathered to every head, the output
projection's parts summed); each rank writes the slots of the rings it
holds, and a decode step gathers the ring's slots over ``kv_split_axes``
before the plain attention over the whole ring. In training the FSDP
dimensions of each layer are gathered just before it (inside the
decoder layer's recompute region).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (drop_leading, fsdp_plan,
                                               gather_leaves, grad_entry,
                                               param_specs)
from repro_torch.models.attention import flash_attention, ring_positions
from repro_torch.models.layers import (dense_init, embed_tokens,
                                       init_embed, init_mlp,
                                       lm_cross_entropy, lm_logits, mlp,
                                       rms_norm, torch_dtype)
from repro_torch.models.transformer import (LayerDesc, _kv_for_heads,
                                            _qkv_heads, _write_ring,
                                            init_attention, kv_layout,
                                            layer_views, out_projection,
                                            stacked_layers)


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


def policy_view(params, cfg: ModelConfig, policy):
    """Under a policy over several ranks: (the params as the entry points
    read them, the gather plans of one layer of ``enc`` and of ``dec``).
    ``enc_in`` and the embedding have their FSDP dimensions gathered here;
    every leaf's gradient is summed over the batch axes its spec leaves
    whole (``sharding.grad_entry``). (params, None) otherwise."""
    if policy is None or policy.world_size == 1:
        return params, None
    specs = param_specs(cfg, policy)
    params = grad_entry(params, specs, policy)
    plan = fsdp_plan(specs, policy)
    params = dict(params, **{k: gather_leaves(params[k], plan[k], policy)
                             for k in ("embed", "enc_in")})
    return params, {k: drop_leading(plan[k]) for k in ("enc", "dec")}


def _attend(q, k, v, h0, cfg, **kw):
    """``flash_attention`` for the query heads q holds (from h0)."""
    kq, vq = _kv_for_heads(cfg, k, v, h0, q.shape[2])
    return flash_attention(q, kq, vq, **kw)


def encode(params, cfg: ModelConfig, embeddings, policy=None, plan=None):
    """embeddings: (B, S_src, D) stand-in frame features -> the encoder's
    states (B, S_src, D). Under a policy ``enc_in``'s column blocks are
    gathered over ``model``, and each layer is tensor-parallel."""
    x = embeddings.to(torch_dtype(cfg.dtype))
    M = policy.model_axis if policy is not None else None
    if policy is not None and policy.splits(cfg.d_model, M):
        x = policy.all_gather(policy.enter(x, M) @ params["enc_in"], M, -1)
    else:
        x = x @ params["enc_in"]
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    layer = layer_views(params["enc"])
    for i in range(cfg.enc_layers):
        lp = layer(i)
        if plan is not None:
            lp = gather_leaves(lp, plan, policy)
        xn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q, k, v, h0 = _qkv_heads(lp["attn"], cfg, xn, positions, policy)
        out = _attend(q, k, v, h0, cfg, q_pos=positions, k_pos=positions,
                      causal=False)
        x = x + out_projection(lp["attn"], cfg, out.reshape(B, S, -1),
                               x.dtype, policy)
        x = x + mlp(lp["mlp"], rms_norm(x, lp["ln_ffn"], cfg.norm_eps),
                    policy, cfg.d_ff)
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


def _ring(c, name, policy):
    """The whole ring of a cache leaf (B, L, Hkv, hd): this rank's slots,
    gathered over ``kv_split_axes`` where the spec cuts them."""
    t = c[name]
    if policy is None:
        return t
    L, _, _ = kv_layout(None, LayerDesc(), t.shape[1], policy)
    return t if L == t.shape[1] else \
        policy.all_gather(t, policy.kv_split_axes, 1)


def _write(c, names, k, v, wpos, policy):
    """Rows k, v (B, n, Hkv, hd) at positions wpos (B, n) into the ring
    leaves ``names`` at slot p % L, on this rank's slots only."""
    L, l0, _ = kv_layout(None, LayerDesc(), c[names[0]].shape[1], policy)
    _write_ring({"k": c[names[0]], "v": c[names[1]]}, k, v, wpos, L, l0)


def _cross_qkv(cp, cfg, xn, enc_out, policy):
    """Cross-attention q (B, S, H, hd) from the decoder and, where
    ``enc_out`` is given, xk, xv (B, S_src, Hkv, hd) from the encoder,
    tensor-parallel over ``model`` under a policy as ``_qkv_heads`` (no
    norm, no RoPE). Returns (q, xk, xv, h0)."""
    B, S, _ = xn.shape
    M = policy.model_axis if policy is not None else None
    cut_q = policy is not None and policy.splits(cfg.q_dim, M)
    cut_kv = policy is not None and policy.splits(cfg.kv_dim, M)
    own = cut_q and not cfg.n_heads % policy.model_size
    q = (policy.enter(xn, M) if cut_q else xn) @ cp["wq"]
    h0 = 0
    if own:
        h0 = policy.index(M) * (cfg.n_heads // policy.model_size)
    elif cut_q:
        q = policy.all_gather(q, M, dim=-1)
    q = q.reshape(B, S, -1, cfg.head_dim)
    xk = xv = None
    if enc_out is not None:
        e = policy.enter(enc_out, M) if cut_kv else enc_out
        xk, xv = e @ cp["wk"], e @ cp["wv"]
        if cut_kv:
            xk = policy.all_gather(xk, M, dim=-1)
            xv = policy.all_gather(xv, M, dim=-1)
        xk = xk.reshape(B, -1, cfg.n_kv_heads, cfg.head_dim)
        xv = xv.reshape(B, -1, cfg.n_kv_heads, cfg.head_dim)
        if own:
            xk, xv = policy.enter(xk, M), policy.enter(xv, M)
    return q, xk, xv, h0


def _dec_layer(lp, c, cfg, x, positions, enc_out, enc_positions, mode,
               policy=None, plan=None):
    """One decoder layer; ``c`` is its cache slice (None in "train")."""
    if plan is not None:
        lp = gather_leaves(lp, plan, policy)
    B, S, _ = x.shape
    # self attention
    xn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v, h0 = _qkv_heads(lp["attn"], cfg, xn, positions, policy)
    if mode in ("train", "prefill"):
        out = _attend(q, k, v, h0, cfg, q_pos=positions, k_pos=positions,
                      causal=True)
        if mode == "prefill":
            _write(c, ("k", "v"), k, v, positions, policy)
    else:
        pos = positions[:, 0]
        _write(c, ("k", "v"), k, v, positions, policy)
        ck, cv = _ring(c, "k", policy), _ring(c, "v", policy)
        out = _attend(q, ck, cv, h0, cfg, q_pos=positions,
                      k_pos=ring_positions(pos, ck.shape[1]), causal=True)
    x = x + out_projection(lp["attn"], cfg, out.reshape(B, S, -1), x.dtype,
                           policy)

    # cross attention
    xn = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
    qx, xk, xv, h0 = _cross_qkv(lp["cross"], cfg, xn,
                                None if mode == "decode" else enc_out,
                                policy)
    if mode == "decode":
        xk, xv = _ring(c, "xk", policy), _ring(c, "xv", policy)
    elif mode == "prefill":
        _write(c, ("xk", "xv"), xk, xv, enc_positions, policy)
    outx = _attend(qx, xk, xv, h0, cfg, q_pos=positions,
                   k_pos=enc_positions, causal=False)
    x = x + out_projection(lp["cross"], cfg, outx.reshape(B, S, -1),
                           x.dtype, policy)
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln_ffn"], cfg.norm_eps),
                   policy, cfg.d_ff)


def _dec_stack(params, cfg, x, positions, cache, enc_out, enc_positions,
               mode, policy=None, plan=None):
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
                enc_out, enc_positions, mode, policy, plan)
        x = checkpoint(_dec_layer, *args, use_reentrant=False) \
            if mode == "train" else _dec_layer(*args)
    return x, cache


def loss_fn(params, cfg: ModelConfig, batch, *, placement=None,
            policy=None, aux_weight: float = 0.0, ragged: bool = True):
    """batch: {embeddings (B, S_src, D), tokens (B, S), labels (B, S), mask
    optional} -> (loss, {"ce", "aux"}): the token cross-entropy of the
    decoder over the encoded frames; no aux loss. The routing keywords are
    accepted and unused. Under a train policy each rank passes its rows
    and its shards and gets the global batch's loss and its shards'
    gradients."""
    params, plan = policy_view(params, cfg, policy)
    plan = plan or {"enc": None, "dec": None}
    enc_out = encode(params, cfg, batch["embeddings"], policy, plan["enc"])
    B, S_src = enc_out.shape[:2]
    x = embed_tokens(params["embed"], cfg, batch["tokens"], policy)
    S = x.shape[1]
    x, _ = _dec_stack(params, cfg, x, _positions(B, S, x.device), None,
                      enc_out, _positions(B, S_src, x.device), "train",
                      policy, plan["dec"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    ce = lm_cross_entropy(params["embed"], cfg, x, batch["labels"],
                          batch.get("mask"), policy)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=x.device)}


def prefill(params, cfg: ModelConfig, batch, cache, *, placement=None,
            source_ids=None, n_sources: int = 0, policy=None,
            collect_stats: bool = True, ragged: bool = True):
    """batch: {embeddings (B, S_src, D), tokens (B, S), lengths (B,)
    optional} -> (logits at each row's last real token (B, V), cache,
    None). The routing keywords are accepted and unused."""
    params, _ = policy_view(params, cfg, policy)
    enc_out = encode(params, cfg, batch["embeddings"], policy)
    B, S_src = enc_out.shape[:2]
    x = embed_tokens(params["embed"], cfg, batch["tokens"], policy)
    S = x.shape[1]
    x, cache = _dec_stack(params, cfg, x, _positions(B, S, x.device), cache,
                          enc_out, _positions(B, S_src, x.device), "prefill",
                          policy)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    lengths = batch.get("lengths")
    if lengths is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(B, device=x.device),
                 torch.clamp(lengths.long() - 1, 0, S - 1)]
    return lm_logits(params["embed"], cfg, last, policy), cache, None


def decode_step(params, cfg: ModelConfig, tokens, cache, lengths, *,
                placement=None, source_ids=None, n_sources: int = 0,
                policy=None, collect_stats: bool = True, ragged: bool = True,
                enc_lengths=None):
    """tokens (B,) at positions ``lengths`` (B,) -> (logits (B, V), cache,
    None). ``enc_lengths`` (B,) masks the cross-KV slots at or past each
    row's encoder length (never written); without it every slot of the
    cross cache is attended, as in the reference. Under a policy every
    argument holds this rank's rows."""
    params, _ = policy_view(params, cfg, policy)
    x = embed_tokens(params["embed"], cfg, tokens[:, None], policy)
    B = x.shape[0]
    positions = lengths.to(torch.int32)[:, None]
    L, _, _ = kv_layout(None, LayerDesc(), cache["xk"].shape[2], policy)
    enc_positions = _positions(B, L, x.device)
    if enc_lengths is not None:
        enc_positions = torch.where(
            enc_positions < enc_lengths.to(x.device)[:, None], enc_positions,
            torch.full_like(enc_positions, -1))
    x, cache = _dec_stack(params, cfg, x, positions, cache, None,
                          enc_positions, "decode", policy)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params["embed"], cfg, x[:, 0], policy), cache, None
