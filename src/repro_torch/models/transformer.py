"""Decoder-only MoE transformer over a paged KV pool (the serving data plane).

Layers are grouped into *super-blocks* (period P = lcm(moe_every,
local_ratio + 1)); params and page pools are stacked ``(n_super, ...)`` per
within-period position ``blocks/pos{j}``, the reference's pytree layout, and
a Python loop walks the super-blocks. MoE layers take the Gimbal expert
``placement`` (n_moe_layers, E) as a runtime input and emit per-layer
A[s, e] / B[e] statistics.

Three paged entry points: ``prefill_chunk_paged`` (chunked prefill of B
lanes), ``decode_step_paged`` (one token per lane through the paged decode
kernel) and ``mixed_step_paged`` (both in one dispatch). They update the
page pool **in place** and also return it, so a caller may keep
reassigning its pool from the return value as with the reference.

The dense-cache entry points, training and the other model families are
later slices (ROADMAP.md Queue A).
"""
from __future__ import annotations

import dataclasses
from math import gcd
from typing import Any, Dict, List

import torch

from repro_torch.bridge import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.kv_pack import pack_kv, unpack_kv
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import flash_attention
from repro_torch.models.layers import (apply_rope, dense_init, embed_tokens,
                                       init_embed, init_mlp, lm_logits, mlp,
                                       rms_norm, torch_dtype)

@dataclasses.dataclass(frozen=True)
class LayerDesc:
    local: bool = False    # sliding-window attention
    moe: bool = False      # MoE FFN instead of dense
    hybrid: bool = False   # parallel attn + mamba branches (hymba)


def _lcm(a: int, b: int) -> int:
    return a * b // gcd(a, b)


def period_descriptors(cfg: ModelConfig) -> List[LayerDesc]:
    moe_p = cfg.moe.moe_every if cfg.moe.enabled else 1
    loc_p = (cfg.local_global_ratio + 1) if cfg.local_global_ratio > 0 else 1
    P = _lcm(moe_p, loc_p)
    if cfg.n_layers % P:
        raise ValueError(
            f"{cfg.name}: n_layers={cfg.n_layers} not divisible by period {P}")
    return [LayerDesc(local=cfg.is_local_layer(j), moe=cfg.is_moe_layer(j),
                      hybrid=(cfg.family == "hybrid")) for j in range(P)]


def n_super_blocks(cfg: ModelConfig) -> int:
    return cfg.n_layers // len(period_descriptors(cfg))


# ------------------------------------------------------------------ init
def init_attention(cfg: ModelConfig, *, generator, device):
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    p = {
        "wq": dense_init((d, cfg.q_dim), 0, dt, **kw),
        "wk": dense_init((d, cfg.kv_dim), 0, dt, **kw),
        "wv": dense_init((d, cfg.kv_dim), 0, dt, **kw),
        "wo": dense_init((cfg.q_dim, d), 0, dt, **kw),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            p[name] = torch.zeros(n, dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(cfg.head_dim, device=device)
        p["k_norm"] = torch.zeros(cfg.head_dim, device=device)
    return p


def init_layer(cfg: ModelConfig, desc: LayerDesc, *, generator, device):
    if desc.hybrid or desc.local or cfg.post_norms:
        raise NotImplementedError(f"{cfg.name}: only the plain decoder layer "
                                  "is ported (ROADMAP.md Queue A: other "
                                  "model families)")
    kw = dict(generator=generator, device=device)
    p: Dict[str, Any] = {
        "ln_attn": torch.zeros(cfg.d_model, device=device),
        "attn": init_attention(cfg, **kw),
        "ln_ffn": torch.zeros(cfg.d_model, device=device),
    }
    if desc.moe:
        p["moe"] = moe_mod.init_moe(cfg, **kw)
    else:
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, torch_dtype(cfg.dtype),
                            **kw)
    return p


def _stack_into(dst, src, i):
    if isinstance(src, dict):
        for k in src:
            _stack_into(dst[k], src[k], i)
    else:
        dst[i].copy_(src)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda"):
    """Random params in the reference's layout. Each super-block's layer is
    drawn on its own and copied into the stacked leaves, so peak memory is
    the model plus one layer."""
    descs = period_descriptors(cfg)
    ns = n_super_blocks(cfg)
    kw = dict(generator=generator, device=device)
    embed = init_embed(cfg, **kw)
    blocks = {}
    for j, desc in enumerate(descs):
        first = init_layer(cfg, desc, **kw)
        stacked = tree_map(
            lambda a: torch.empty((ns,) + tuple(a.shape), dtype=a.dtype,
                                  device=a.device), first)
        _stack_into(stacked, first, 0)
        del first
        for i in range(1, ns):
            _stack_into(stacked, init_layer(cfg, desc, **kw), i)
        blocks[f"pos{j}"] = stacked
    return {"embed": embed, "blocks": blocks,
            "final_norm": torch.zeros(cfg.d_model, device=device)}


# ------------------------------------------------------------------ cache
def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     kv_dtype: str = "auto", device="cuda"):
    """Physical KV page pool: per super-block position k/v tensors of shape
    (n_super, n_pages, page_size, Hkv, hd). Page 0 is the reserved garbage
    page (see serving/paged.py): allocators hand out ids >= 1, and masked
    writes land in page 0. ``kv_dtype="auto"`` keeps the model dtype.

    ``kv_dtype="int8"`` stores quantized pages plus per-(token, head) f32
    ``k_scale``/``v_scale`` leaves (n_super, n_pages, page_size, Hkv)
    (kernels/kv_pack.py): the same pool bytes hold ``2*hd/(hd+4)`` times the
    tokens of a 2-byte layout; attention reads dequantize on the fly."""
    if cfg.family == "hybrid":
        raise NotImplementedError("paged KV: mamba state is not paged")
    if cfg.local_global_ratio > 0 or cfg.sliding_window > 0:
        raise NotImplementedError("paged KV: sliding-window layers "
                                  "use the dense ring cache")
    if cfg.attn_logit_softcap:
        raise NotImplementedError("paged KV: attn_logit_softcap "
                                  "unsupported in paged_decode")
    if kv_dtype not in ("auto", "int8"):
        raise ValueError(f"kv_dtype {kv_dtype!r}: expected 'auto' or 'int8'")
    ns = n_super_blocks(cfg)
    quant = kv_dtype == "int8"
    dt = torch.int8 if quant else torch_dtype(cfg.dtype)
    shape = (ns, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    out = {}
    for j in range(len(period_descriptors(cfg))):
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
        if quant:
            sshape = shape[:-1]
            c["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
            c["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
        out[f"pos{j}"] = c
    return out


def paged_cache_page_nbytes(pages) -> int:
    """Device bytes per page across every super-block slice and leaf
    (values and, on int8 pools, scales): the transfer size one swapped page
    costs the host tier."""
    return sum(t.numel() * t.element_size() // t.shape[1]
               for t in tree_leaves(pages))


def _ids(page_ids, pages):
    dev = tree_leaves(pages)[0].device
    return torch.as_tensor(list(page_ids), dtype=torch.long, device=dev)


def gather_pages(pages, page_ids):
    """Gather whole page rows across the pool -> a payload tree of shape
    (ns, len(page_ids), ...) per leaf (device side of a KV tier swap-out)."""
    ids = _ids(page_ids, pages)
    return tree_map(lambda a: a[:, ids], pages)


def scatter_pages(pages, payload, page_ids):
    """Scatter a :func:`gather_pages` payload back into (possibly
    different) page rows, in place (device side of a KV tier swap-in)."""
    ids = _ids(page_ids, pages)

    def put(a, p):
        a[:, ids] = p.to(device=a.device, dtype=a.dtype)

    for name, c in pages.items():
        for leaf in c:
            put(c[leaf], payload[name][leaf])
    return pages


def copy_pages(pages, copies):
    """Copy-on-write page copies, in place: row ``dst`` := row ``src`` for
    every (src, dst) pair across every super-block position and leaf. The
    sources are gathered before any write, so a src page recycled as a later
    dst within the same batch still contributes its pre-batch contents."""
    if not copies:
        return pages
    src = _ids([s for s, _ in copies], pages)
    dst = _ids([d for _, d in copies], pages)
    for c in pages.values():
        for leaf in c:
            c[leaf][:, dst] = c[leaf][:, src]     # advanced index: a copy
    return pages


# ------------------------------------------------------------------ attention
def _qkv(lp, cfg, xn, positions):
    B, S, _ = xn.shape
    q = xn @ lp["wq"]
    k = xn @ lp["wk"]
    v = xn @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _paged_attention(cfg, q, k, v, positions, cache, mode, paged):
    """Paged-KV attention: scatter the new k/v into physical pages through
    the block table (in place), then attend through the block table.

    cache: {"k": (P, ps, Hkv, hd), "v": ...}, one super-block slice of the
    pool. paged: {"block_tables" (B, NB), "valid" (B, S) rows to write,
    "ctx_lens" (B,) live tokens incl. this chunk, "decode_mask" (B,) or
    None}. Invalid rows write to garbage page 0 and attend to nothing.

    int8 pools (``"k_scale" in cache``) quantize each written row through
    ``pack_kv`` and scatter the per-(token, head) scales alongside; reads
    dequantize on the fly (in the kernel for decode, through ``unpack_kv``
    after the gather for chunked prefill).
    """
    B, S = positions.shape
    pk, pv = cache["k"], cache["v"]
    ps = pk.shape[1]
    bt = paged["block_tables"].to(torch.int32).contiguous()    # (B, NB)
    NB = bt.shape[1]
    valid = paged["valid"]                                      # (B, S)
    ctx = paged["ctx_lens"].to(torch.int32).contiguous()        # (B,)
    bidx = torch.arange(B, device=q.device)[:, None]
    blk = torch.clamp(torch.div(positions, ps, rounding_mode="floor"),
                      0, NB - 1).long()
    zero = torch.zeros((), dtype=torch.long, device=q.device)
    page = torch.where(valid, bt.long()[bidx, blk], zero).reshape(-1)
    off = torch.where(valid, (positions % ps).long(), zero).reshape(-1)
    Hkv, hd = pk.shape[2], pk.shape[3]
    quant = "k_scale" in cache
    cks = cvs = None
    if quant:
        kw, ksc = pack_kv(k)
        vw, vsc = pack_kv(v)
        cks, cvs = cache["k_scale"], cache["v_scale"]
        cks[page, off] = ksc.reshape(B * S, Hkv)
        cvs[page, off] = vsc.reshape(B * S, Hkv)
    else:
        kw, vw = k, v
    pk[page, off] = kw.reshape(B * S, Hkv, hd).to(pk.dtype)
    pv[page, off] = vw.reshape(B * S, Hkv, hd).to(pv.dtype)

    if mode == "paged_decode":                         # S == 1, kernel path
        out = paged_decode(q[:, 0].contiguous(), pk, pv, bt, ctx,
                           k_scales=cks, v_scales=cvs)
        return out[:, None], cache
    # chunked prefill: dense gather of the request's pages (prior context +
    # the chunk just written), causal mask via absolute positions
    L = NB * ps
    btl = bt.long()
    kd = pk[btl].reshape(B, L, Hkv, hd)
    vd = pv[btl].reshape(B, L, Hkv, hd)
    if quant:                                          # dequant the gather
        kd = unpack_kv(kd, cks[btl].reshape(B, L, Hkv), q.dtype)
        vd = unpack_kv(vd, cvs[btl].reshape(B, L, Hkv), q.dtype)
    kpos = torch.arange(L, dtype=torch.int32, device=q.device)[None]
    kpos = torch.where(kpos < ctx[:, None], kpos, torch.full_like(kpos, -1))
    out = flash_attention(q, kd, vd, q_pos=positions, k_pos=kpos,
                          causal=True, window=0,
                          softcap_val=cfg.attn_logit_softcap)
    dm = paged.get("decode_mask")
    if dm is not None:
        # mixed fused step: decode rows are 1-token lanes whose attention
        # must match decode_step_paged. The prefill path casts softmax
        # weights to the KV dtype before the value product while the decode
        # kernel keeps them f32, so recompute those rows' position-0 output
        # through the decode kernel and select per row.
        dec = paged_decode(q[:, 0].contiguous(), pk, pv, bt, ctx,
                           k_scales=cks, v_scales=cvs)
        out[:, 0] = torch.where(dm[:, None, None], dec, out[:, 0])
    return out, cache


def attention_block(lp, cfg, desc, x, positions, cache, mode, paged):
    """x: (B, S, D); positions (B, S). Returns (attn_out, cache)."""
    if mode not in ("paged_prefill", "paged_decode"):
        raise NotImplementedError(f"attention mode {mode!r}: the dense-cache "
                                  "path is not ported yet (ROADMAP.md "
                                  "Queue A)")
    B, S, _ = x.shape
    xn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = _qkv(lp["attn"], cfg, xn, positions)
    out, cache = _paged_attention(cfg, q, k, v, positions, cache, mode, paged)
    out = out.reshape(B, S, cfg.q_dim) @ lp["attn"]["wo"]
    return out, cache


# ------------------------------------------------------------------ layer
def decoder_layer(lp, cfg, desc, x, positions, cache, mode, placement_row,
                  source_ids, n_sources, collect_stats=True, paged=None):
    """Returns (x, cache, stats_or_None)."""
    attn_out, cache = attention_block(lp, cfg, desc, x, positions, cache,
                                      mode, paged)
    x = x + attn_out
    xn = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    stats = None
    if desc.moe:
        # padding rows / inactive lanes stay out of the routing statistics
        mask = paged["valid"] if paged is not None else None
        y, stats = moe_mod.moe_layer(
            lp["moe"], cfg, xn, placement_row, source_ids=source_ids,
            n_sources=n_sources, collect_stats=collect_stats,
            token_mask=mask)
    else:
        y = mlp(lp["mlp"], xn)
    return x + y, cache, stats


# ------------------------------------------------------------------ model
def _moe_positions(descs) -> List[int]:
    return [j for j, d in enumerate(descs) if d.moe]


def identity_placement(cfg: ModelConfig, device="cpu"):
    n_moe = cfg.n_moe_layers
    if n_moe == 0:
        return torch.zeros((0, 0), dtype=torch.int32, device=device)
    return torch.arange(cfg.moe.n_experts, dtype=torch.int32,
                        device=device).repeat(n_moe, 1)


def migrate_params_for_placement(params, cfg, old_placement, new_placement):
    """Reorder the stacked physical expert weights after a placement update
    (functional: returns a new tree, ``params`` is untouched).

    ``placement`` rows are (n_moe_layers, E) = (ns * mp, E); layer l lives at
    super-block l // mp, moe-position index l % mp.
    """
    descs = period_descriptors(cfg)
    moe_pos = _moe_positions(descs)
    mp = len(moe_pos)
    if mp == 0:
        return params
    ns = n_super_blocks(cfg)
    old_r = torch.as_tensor(old_placement, dtype=torch.int32).reshape(ns, mp, -1)
    new_r = torch.as_tensor(new_placement, dtype=torch.int32).reshape(ns, mp, -1)
    blocks = dict(params["blocks"])
    for mi, j in enumerate(moe_pos):
        blk = dict(blocks[f"pos{j}"])
        per = [moe_mod.migrate_expert_weights(
            {k: v[i] for k, v in blk["moe"].items()}, old_r[i, mi],
            new_r[i, mi]) for i in range(ns)]
        blk["moe"] = {k: torch.stack([p[k] for p in per])
                      for k in blk["moe"]}
        blocks[f"pos{j}"] = blk
    return dict(params, blocks=blocks)


def expert_weight_bytes(cfg) -> int:
    """Bytes of ONE expert's FFN weights (w_gate + w_up + w_down): what an
    asynchronous prefetch moves per (layer, expert) relocation."""
    m = cfg.moe
    if not m.enabled:
        return 0
    itemsize = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    return 3 * cfg.d_model * m.d_expert * itemsize


def stage_expert_prefetch(params, cfg, cur_placement, target_placement):
    """Double-buffered expert-weight prefetch: the params tree the model
    will need under ``target_placement``, built without touching the live
    ``params``; adopting it is a pointer swap."""
    return migrate_params_for_placement(params, cfg, cur_placement,
                                        target_placement)


def superblock_forward(blk_params, cfg, descs, x, positions, blk_cache,
                       mode, blk_placement, source_ids, n_sources,
                       collect_stats, paged=None):
    """One super-block (period of layers). Returns (x, stats (mp, ...))."""
    stats_list = []
    mi = 0
    for j, desc in enumerate(descs):
        lp = blk_params[f"pos{j}"]
        c = blk_cache[f"pos{j}"] if blk_cache is not None else None
        prow = None
        if desc.moe:
            prow = (blk_placement[mi] if blk_placement is not None
                    else torch.arange(cfg.moe.n_experts, dtype=torch.int32,
                                      device=x.device))
            mi += 1
        x, _, st = decoder_layer(lp, cfg, desc, x, positions, c, mode, prow,
                                 source_ids, n_sources, collect_stats, paged)
        if st is not None:
            stats_list.append(st)
    stats = None
    if stats_list and collect_stats:
        stats = {k: torch.stack([s[k] for s in stats_list])
                 for k in stats_list[0]}
    return x, stats


def _stack_forward(params, cfg, x, positions, cache, mode, placement,
                   source_ids, n_sources, collect_stats, paged=None):
    """Loop over super-blocks. x: (B, S, D). The page pool is written in
    place. Returns (x, cache, stats (ns * mp, ...))."""
    descs = period_descriptors(cfg)
    ns = n_super_blocks(cfg)
    mp = len(_moe_positions(descs))
    placement_r = None
    if mp and placement is not None and placement.numel():
        placement_r = placement.reshape(ns, mp, -1)
    per_block = []
    for i in range(ns):
        blk_params = tree_map(lambda a: a[i], params["blocks"])
        blk_cache = tree_map(lambda a: a[i], cache) \
            if cache is not None else None
        x, stats = superblock_forward(
            blk_params, cfg, descs, x, positions, blk_cache, mode,
            placement_r[i] if placement_r is not None else None,
            source_ids, n_sources, collect_stats, paged)
        per_block.append(stats)
    stats = None
    if per_block and per_block[0] is not None:
        stats = {k: torch.stack([s[k] for s in per_block])
                 .reshape((ns * mp,) + tuple(per_block[0][k].shape[1:]))
                 for k in per_block[0]}
    return x, cache, stats


def prefill_chunk_paged(params, cfg: ModelConfig, batch, pages, *,
                        block_tables, placement=None, source_ids=None,
                        n_sources: int = 0, collect_stats: bool = True):
    """Chunked prefill into the paged KV pool.

    batch: {tokens (B, S), chunk_starts (B,), chunk_lens (B,)} — row b
    prefills prompt positions [chunk_starts[b], chunk_starts[b] +
    chunk_lens[b]) (rows past chunk_lens are padding and write to the
    garbage page). Earlier chunks' KV is read back through the block table,
    so attention is exact across chunk boundaries. Returns
    (logits_at_chunk_end (B, V), pages, stats); logits are only meaningful
    when the chunk completes the prompt.
    """
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], cfg, tokens)
    B, S = x.shape[:2]
    dev = x.device
    starts = batch["chunk_starts"].to(torch.int32)
    lens = batch["chunk_lens"].to(torch.int32)
    ar = torch.arange(S, dtype=torch.int32, device=dev)[None]
    positions = starts[:, None] + ar
    paged = {"block_tables": block_tables,
             "valid": ar < lens[:, None],
             "ctx_lens": starts + lens,
             "decode_mask": batch.get("decode_mask")}
    if placement is None:
        placement = identity_placement(cfg, dev)
    x, pages, stats = _stack_forward(
        params, cfg, x, positions, pages, "paged_prefill", placement,
        source_ids, n_sources, collect_stats, paged=paged)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[torch.arange(B, device=dev),
             torch.clamp(lens - 1, 0, S - 1).long()]
    return lm_logits(params["embed"], cfg, last), pages, stats


def mixed_step_paged(params, cfg: ModelConfig, batch, pages, *,
                     block_tables, placement=None, source_ids=None,
                     n_sources: int = 0, collect_stats: bool = True):
    """One fused mixed dispatch: prefill chunk lanes AND 1-token decode
    lanes in the same ragged (B, S) batch.

    batch extends the :func:`prefill_chunk_paged` contract with
    ``decode_mask (B,) bool``: a decode row has ``chunk_lens == 1``,
    ``chunk_starts`` at the request's written KV length, and its last
    sampled token at ``tokens[b, 0]``. Decode rows' attention goes through
    the paged decode kernel, as in :func:`decode_step_paged`.
    """
    if "decode_mask" not in batch:
        raise ValueError("mixed step needs batch['decode_mask']")
    return prefill_chunk_paged(
        params, cfg, batch, pages, block_tables=block_tables,
        placement=placement, source_ids=source_ids, n_sources=n_sources,
        collect_stats=collect_stats)


def decode_step_paged(params, cfg: ModelConfig, tokens, pages, lengths, *,
                      block_tables, active=None, placement=None,
                      source_ids=None, n_sources: int = 0,
                      collect_stats: bool = True):
    """One batched decode token against the paged KV pool.

    tokens (B,) int32; lengths (B,) current context per lane (the new token
    is written at position lengths[b]); block_tables (B, NB); active (B,)
    bool marks live lanes; inactive lanes write to the garbage page and
    emit zero attention.
    """
    x = embed_tokens(params["embed"], cfg, tokens[:, None])   # (B, 1, D)
    dev = x.device
    lengths = lengths.to(torch.int32)
    positions = lengths[:, None]
    if active is None:
        active = torch.ones(tokens.shape[0], dtype=torch.bool, device=dev)
    paged = {"block_tables": block_tables,
             "valid": active[:, None],
             "ctx_lens": torch.where(active, lengths + 1,
                                     torch.zeros_like(lengths))}
    if placement is None:
        placement = identity_placement(cfg, dev)
    x, pages, stats = _stack_forward(
        params, cfg, x, positions, pages, "paged_decode", placement,
        source_ids, n_sources, collect_stats, paged=paged)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params["embed"], cfg, x[:, 0]), pages, stats
