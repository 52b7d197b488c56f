"""Decoder-only transformer (dense, MoE, VLM and hybrid families): the
serving data planes' model entry points.

Layers are grouped into *super-blocks* (period P = lcm(moe_every,
local_ratio + 1)); params and page pools are stacked ``(n_super, ...)`` per
within-period position ``blocks/pos{j}``, the reference's pytree layout, and
a Python loop walks the super-blocks. MoE layers take the Gimbal expert
``placement`` (n_moe_layers, E) as a runtime input and emit per-layer
A[s, e] / B[e] statistics.

Three paged entry points: ``prefill_chunk_paged`` (chunked prefill of B
lanes), ``decode_step_paged`` (one token per lane through the paged decode
kernel) and ``mixed_step_paged`` (both in one dispatch). Two dense-cache
entry points, for the slot-indexed plane (``serving/real_engine.py``):
``prefill`` (S tokens, or S rows of ``batch["embeddings"]`` for a VLM
config, into a fresh ``(B, L)`` cache, a ring when L < S) and
``decode_step`` (one token per row through the flash-decode kernel). A
hybrid layer (hymba) runs a mamba branch beside attention on the same
normed input (``models/ssm.py``); its state lives in the dense cache
(``mamba_h``, ``mamba_conv``), which prefill writes from a zero state and
decode carries.
All of them update the KV cache **in place** and also return it, so a
caller may keep reassigning its cache from the return value as with the
reference. ``ragged`` picks the MoE dispatch of every layer: the ragged
path (default) or the capacity-padded one.

The dense-cache entry points and ``loss_fn`` take the reference's
``policy`` (``distributed/sharding.py``). Over several ranks ``prefill`` and
``decode_step`` run SPMD with explicit collectives: TP heads and FFN
columns over ``model`` (k and v gathered to every KV head, the output
projection's partial sums reduced), a vocabulary-parallel embedding and
head, experts over ``model`` (``moe.py``), and the ring cache cut over the
policy's ``kv_split_axes`` with split-K decode (:func:`split_decode`, the
reference's ``_split_decode``); a policy over one rank changes no bit, and
a ``kv_split`` forced above one there runs the shards one after another.
A hybrid layer's mamba branch runs each rank's channels (``models/ssm.py``).
``loss_fn`` takes a train policy: FSDP over the data axes, TP and EP over
``model``, the batch over the batch axes (:func:`train_view`). The paged
entry points take none, as in the reference.

``loss_fn`` is the training entry point: causal attention over the whole
sequence (mode ``"train"``, no cache), each super-block recomputed in the
backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``),
the token cross-entropy plus 0.01 times the mean router aux loss. Both
MoE dispatch paths are differentiable (``kernels/moe_dispatch.ragged_gmm``,
``kernels/moe_gmm.moe_gmm``).
"""
from __future__ import annotations

import dataclasses
from math import gcd
from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (drop_leading, fsdp_plan,
                                               gather_leaves, grad_entry,
                                               param_specs)
from repro_torch.kernels.kv_pack import (pack_kv_into_pages,
                                         pack_kv_into_ring, page_slots)
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.kernels.paged_prefill import paged_prefill_attention
from repro_torch.models import moe as moe_mod
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.attention import (decode_attention,
                                          flash_attention, ring_positions)
from repro_torch.models.layers import (apply_rope, dense_init, embed_tokens,
                                       init_embed, init_mlp,
                                       lm_cross_entropy, lm_logits, mlp,
                                       rms_norm, torch_dtype)
from repro_torch.models.ssm import init_mamba, mamba_block


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
    """A local (sliding-window) layer has the same leaves as a global one;
    a hybrid layer adds the mamba branch and the two branch norms;
    ``post_norms`` (gemma2/3) adds the post-attention and post-FFN norms."""
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
    if desc.hybrid:
        p["mamba"] = init_mamba(cfg.d_model, cfg.ssm.state_dim,
                                cfg.ssm.conv_width, cfg.ssm.expand,
                                torch_dtype(cfg.dtype), **kw)
        p["attn_out_norm"] = torch.zeros(cfg.d_model, device=device)
        p["mamba_out_norm"] = torch.zeros(cfg.d_model, device=device)
    if cfg.post_norms:
        p["post_attn_norm"] = torch.zeros(cfg.d_model, device=device)
        p["post_ffn_norm"] = torch.zeros(cfg.d_model, device=device)
    return p


def _stack_into(dst, src, i):
    if isinstance(src, dict):
        for k in src:
            _stack_into(dst[k], src[k], i)
    else:
        dst[i].copy_(src)


def stacked_layers(make, n: int):
    """``n`` layers from ``make()`` stacked into ``(n, ...)`` leaves, the
    layout of the reference's ``vmap``-ed init. Each layer is drawn on its
    own and copied into the stacked leaves, so peak memory is the stack
    plus one layer; with one layer the stacking dimension is a view of the
    layer's leaves, and peak memory is the layer plus one draw
    (``layers.DRAW_BYTES``)."""
    first = make()
    if n == 1:
        return tree_map(lambda a: a[None], first)
    stacked = tree_map(
        lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype,
                              device=a.device), first)
    _stack_into(stacked, first, 0)
    del first
    for i in range(1, n):
        _stack_into(stacked, make(), i)
    return stacked


def layer_views(stacked):
    """``i -> `` the i-th layer of a tree of ``(n, ...)``-stacked leaves.
    With grads on, each leaf is unbound once, so its backward stacks the
    layers' grads once; ``a[i]`` per layer would give every layer a
    leaf-sized zero grad to add into."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tree_leaves(stacked)):
        parts = tree_map(lambda a: a.unbind(0), stacked)
        return lambda i: tree_map(lambda p: p[i], parts)
    return lambda i: tree_map(lambda a: a[i], stacked)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda"):
    """Random params in the reference's layout, each within-period
    position's layers stacked ``(n_super, ...)`` (:func:`stacked_layers`)."""
    descs = period_descriptors(cfg)
    ns = n_super_blocks(cfg)
    kw = dict(generator=generator, device=device)
    embed = init_embed(cfg, **kw)
    blocks = {f"pos{j}": stacked_layers(
        lambda desc=desc: init_layer(cfg, desc, **kw), ns)
        for j, desc in enumerate(descs)}
    return {"embed": embed, "blocks": blocks,
            "final_norm": torch.zeros(cfg.d_model, device=device)}


# ------------------------------------------------------------------ cache
def kv_len_for(cfg: ModelConfig, desc: LayerDesc, max_len: int) -> int:
    if desc.local and cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_dtype: str = "bfloat16", device="cuda"):
    """Dense slot-indexed KV cache: per super-block position k/v tensors of
    shape (n_super, batch, L, Hkv, hd) in the model's dtype, L =
    ``kv_len_for(max_len)``. Any ``kv_dtype`` but "int8" keeps the model
    dtype, as in the reference.

    ``kv_dtype="int8"`` stores int8 k/v and per-(slot, head) f32
    ``k_scale``/``v_scale`` leaves (n_super, batch, L, Hkv)
    (kernels/kv_pack.py); decode dequantizes on read.

    A hybrid layer's position also holds its mamba state, f32 whatever
    ``kv_dtype``: ``mamba_h`` (n_super, batch, d_in, N) and ``mamba_conv``
    (n_super, batch, conv_width - 1, d_in)."""
    ns = n_super_blocks(cfg)
    quant = kv_dtype == "int8"
    dt = torch.int8 if quant else torch_dtype(cfg.dtype)
    cache = {}
    for j, desc in enumerate(period_descriptors(cfg)):
        shape = (ns, batch, kv_len_for(cfg, desc, max_len), cfg.n_kv_heads,
                 cfg.head_dim)
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
        if quant:
            for leaf in ("k_scale", "v_scale"):
                c[leaf] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
        if desc.hybrid:
            d_in = cfg.ssm.expand * cfg.d_model
            c["mamba_h"] = torch.zeros((ns, batch, d_in, cfg.ssm.state_dim),
                                       device=device)
            c["mamba_conv"] = torch.zeros(
                (ns, batch, cfg.ssm.conv_width - 1, d_in), device=device)
        cache[f"pos{j}"] = c
    return cache


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
    """q, k, v (B, S, H, hd) after the norms and RoPE."""
    return _qkv_heads(lp, cfg, xn, positions)[:3]


def _qkv_heads(lp, cfg, xn, positions, policy=None, full_q=False):
    """q, k, v (B, S, H, hd) after the norms and RoPE, and the first query
    head of q. Under a policy whose ``model`` axis cuts the projections'
    columns, each rank projects its own columns; k and v are gathered to
    all KV heads (the cache holds them all), and q too where the cut does
    not fall between heads, or ``full_q`` asks for every head (split-K
    decode attends with all of them).

    Gradients: ``xn``'s is summed over ``model`` where a projection is cut
    (each rank's columns give a part of it); where each rank attends with
    its own heads, so are k's and v's (after the norm and RoPE) and
    ``q_norm``'s."""
    B, S, _ = xn.shape
    M = policy.model_axis if policy is not None else None
    cut_q = policy is not None and policy.splits(cfg.q_dim, M)
    cut_kv = policy is not None and policy.splits(cfg.kv_dim, M)
    own_heads = cut_q and not (full_q or cfg.n_heads % policy.model_size)
    xe = policy.enter(xn, M) if cut_q or cut_kv else xn
    q = (xe if cut_q else xn) @ lp["wq"]
    k = (xe if cut_kv else xn) @ lp["wk"]
    v = (xe if cut_kv else xn) @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    h0 = 0
    if cut_kv:
        k = policy.all_gather(k, M, dim=-1)
        v = policy.all_gather(v, M, dim=-1)
    if own_heads:
        h0 = policy.index(M) * (cfg.n_heads // policy.model_size)
    elif cut_q:
        q = policy.all_gather(q, M, dim=-1)
    q = q.reshape(B, S, -1, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        qn = policy.enter(lp["q_norm"], M) if own_heads else lp["q_norm"]
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if own_heads:
        k, v = policy.enter(k, M), policy.enter(v, M)
    return q, k, v, h0


def _kv_for_heads(cfg, k, v, h0: int, n_q: int):
    """The KV heads that query heads [h0, h0 + n_q) read, laid out so that
    ``flash_attention``'s grouping (G = n_q / KV heads) pairs them right."""
    G = cfg.n_heads // cfg.n_kv_heads
    if n_q == cfg.n_heads:
        return k, v
    if n_q % G == 0:                   # whole groups
        return k[:, :, h0 // G:(h0 + n_q) // G], \
            v[:, :, h0 // G:(h0 + n_q) // G]
    idx = torch.arange(h0, h0 + n_q, device=k.device) // G
    if G % n_q == 0:                   # part of one group
        return k[:, :, idx[:1]], v[:, :, idx[:1]]
    return k[:, :, idx], v[:, :, idx]  # one KV head per query head


def _paged_attention(cfg, q, k, v, positions, cache, mode, paged):
    """Paged-KV attention: scatter the new k/v into physical pages through
    the block table (in place), then attend through the block table.

    cache: {"k": (P, ps, Hkv, hd), "v": ...}, one super-block slice of the
    pool. paged: {"block_tables" (B, NB), "valid" (B, S) rows to write,
    "ctx_lens" (B,) live tokens incl. this chunk, "decode_mask" (B,) or
    None}. Invalid rows write to garbage page 0 and attend to nothing.

    int8 pools (``"k_scale" in cache``) quantize each written row and store
    its codes and per-(token, head) scale through ``pack_kv_into_pages``,
    one launch on the card; reads dequantize on the fly, in the decode and
    the chunked-prefill kernels.
    Chunked prefill needs ``paged["chunk_starts"]`` (B,): row i of lane b
    sits at position chunk_starts[b] + i.
    """
    B, S = positions.shape
    pk, pv = cache["k"], cache["v"]
    ps = pk.shape[1]
    bt = paged["block_tables"].to(torch.int32).contiguous()    # (B, NB)
    valid = paged["valid"]                                      # (B, S)
    ctx = paged["ctx_lens"].to(torch.int32).contiguous()        # (B,)
    Hkv, hd = pk.shape[2], pk.shape[3]
    quant = "k_scale" in cache
    cks = cvs = None
    if quant:
        cks, cvs = cache["k_scale"], cache["v_scale"]
        pack_kv_into_pages(k, v, pk, pv, cks, cvs, bt, positions, valid)
    else:
        page, off = page_slots(bt, positions, valid, ps)
        pk[page, off] = k.reshape(B * S, Hkv, hd).to(pk.dtype)
        pv[page, off] = v.reshape(B * S, Hkv, hd).to(pv.dtype)

    if mode == "paged_decode":                         # S == 1, kernel path
        out = paged_decode(q[:, 0].contiguous(), pk, pv, bt, ctx,
                           k_scales=cks, v_scales=cvs)
        return out[:, None], cache
    # chunked prefill: each lane's chunk (the rows of positions start + i)
    # against its pages, the chunk just written included, through the
    # paged prefill kernel, which reads live pages only
    starts = paged["chunk_starts"].to(torch.int32).contiguous()
    out = paged_prefill_attention(q.contiguous(), pk, pv, bt, starts, ctx,
                                  k_scales=cks, v_scales=cvs,
                                  softcap=cfg.attn_logit_softcap)
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


def kv_layout(cfg, desc, L_loc: int, policy=None):
    """(L, l0, n_local) of one layer's ring cache on this rank: the rank
    holds slots [l0, l0 + L_loc) of a ring of L, and decode runs
    ``n_local`` split-K shards over them one after another (0: no split,
    one decode over the whole ring). The spec (``cache_specs_tree``) cuts
    the ring over ``kv_split_axes`` when ``kv_split > 1`` divides L; the
    shards beyond the axes' ranks (``kv_split`` forced above them, as the
    reference's ``policy_overrides`` do) run on the same rank."""
    if policy is None:
        return L_loc, 0, 0
    axes = policy.kv_split_axes
    n_ax = policy.size(axes)
    if n_ax == 1:
        L = L_loc
    elif policy.cache_len > 0:
        L = kv_len_for(cfg, desc, policy.cache_len)
    else:
        raise ValueError("a policy that cuts the cache over ranks needs "
                         "cache_len (make_policy sets it from a decode or "
                         "prefill shape)")
    if not (policy.kv_split > 1 and L % policy.kv_split == 0):
        if L_loc != L:
            raise ValueError(f"cache of {L_loc} slots under a policy that "
                             f"keeps a ring of {L} whole")
        return L, 0, 0
    if policy.kv_split % n_ax or L_loc * n_ax != L:
        raise ValueError(f"kv_split {policy.kv_split} over {axes} "
                         f"({n_ax} ranks) does not fit {L_loc} of {L} slots")
    return L, policy.index(axes) * L_loc, policy.kv_split // n_ax


def combine_partials(outs, lses):
    """Merge split-K shards as the reference's ``_split_decode`` does:
    outs (n, B, Hq, hd) f32 and lses (n, B, Hq) (-inf: a shard with no
    valid slot) -> (B, Hq, hd) f32. With m* the largest lse and
    w = exp(lse - m*) (0 for an empty shard), out = sum w out / max(sum w,
    1e-30): the reference's sum w acc / max(sum w l, 1e-30) with acc = l
    out and l = exp(lse - m)."""
    m = lses.amax(dim=0)
    w = torch.where(torch.isneginf(lses), torch.zeros_like(lses),
                    torch.exp(lses - m))
    acc = (outs * w[..., None]).sum(dim=0)
    return acc / torch.clamp(w.sum(dim=0), min=1e-30)[..., None]


def _shard_partials(q1, ck, cv, k_pos, q_pos, window, cap, k_scale, v_scale,
                    n: int):
    """The ``n`` split-K shards of a cache (B, L, Hkv, hd), one
    ``flash_decode`` launch each on its slice of the slots (read in place),
    -> (outputs (n, B, Hq, hd) f32, log-sum-exps (n, B, Hq))."""
    Ls = ck.shape[1] // n
    outs, lses = [], []
    for i in range(n):
        sl = slice(i * Ls, (i + 1) * Ls)
        o, lse = flash_decode(
            q1, ck[:, sl], cv[:, sl], k_pos[:, sl].contiguous(), q_pos,
            window=window, softcap=cap,
            k_scale=None if k_scale is None else k_scale[:, sl],
            v_scale=None if v_scale is None else v_scale[:, sl],
            return_lse=True)
        outs.append(o)
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


def split_decode(q, ck, cv, positions, k_pos, window, cap, n_split,
                 k_scale=None, v_scale=None, policy=None):
    """Flash decode with the KV split across ``n_split`` shards (split-K),
    the reference's ``_split_decode``. q (B, 1, Hq, hd); ck, cv (B, L, Hkv,
    hd) this rank's slots; k_pos (B, L) their positions. Without a split
    (``n_split`` <= 1 or not dividing L) one ``decode_attention``.
    Otherwise each shard's partial output (f32) and log-sum-exp come from
    ``flash_decode``; under a policy whose ``kv_split_axes`` span several
    ranks, ``n_split`` is the shards of this rank's slots and the partials
    of all ranks are gathered over those axes; all are combined in f32
    (:func:`combine_partials`)."""
    L = ck.shape[1]
    across = policy is not None and policy.size(policy.kv_split_axes) > 1
    if not across and (n_split <= 1 or L % n_split):
        return decode_attention(q, ck, cv, q_pos=positions, k_pos=k_pos,
                                window=window, softcap_val=cap,
                                k_scale=k_scale, v_scale=v_scale)
    outs, lses = _shard_partials(
        q[:, 0].contiguous(), ck, cv, k_pos.to(torch.int32),
        positions[:, 0].to(torch.int32).contiguous(), window, cap, k_scale,
        v_scale, n_split)
    if policy is not None:
        outs = policy.all_gather(outs, policy.kv_split_axes, dim=0)
        lses = policy.all_gather(lses, policy.kv_split_axes, dim=0)
    return combine_partials(outs, lses).to(q.dtype)[:, None]


def _write_ring(cache, k, v, wpos, L: int, l0: int):
    """Write rows k, v (B, n, Hkv, hd) at positions wpos (B, n) into this
    rank's slots [l0, l0 + L_loc) of a ring of L (slot p % L), in place;
    rows whose slot another rank holds are skipped. An int8 cache
    quantizes through ``pack_kv_into_ring``, one launch on the card."""
    ck, cv = cache["k"], cache["v"]
    L_loc = ck.shape[1]
    if "k_scale" in cache:
        pack_kv_into_ring(k, v, ck, cv, cache["k_scale"], cache["v_scale"],
                          wpos, ring_len=L, slot0=l0)
        return
    if L_loc == L:
        bidx = torch.arange(k.shape[0], device=k.device)[:, None]
        slots = (wpos % L).long()
        ck[bidx, slots] = k
        cv[bidx, slots] = v
        return
    slots = (wpos % L).long() - l0
    b, t = torch.nonzero((slots >= 0) & (slots < L_loc), as_tuple=True)
    ck[b, slots[b, t]] = k[b, t]
    cv[b, slots[b, t]] = v[b, t]


def _dense_attention(cfg, desc, q, k, v, positions, cache, mode, h0=0,
                     policy=None):
    """Dense slot-indexed KV: write the new k/v into the cache rows (in
    place), then attend. cache: {"k": (B, L, Hkv, hd), "v": ...}, one
    super-block slice; int8 caches also hold "k_scale", "v_scale" (B, L,
    Hkv).

    prefill: causal flash attention over the S new tokens (unquantized, as
    in the reference) for the query heads q holds (from h0); the cache
    keeps them at slots [0, S), or the last L at slots pos % L when L < S
    (ring). decode (S == 1): the token at position p goes to slot p % L,
    and the slots' positions come from ``ring_positions``; the attention
    is :func:`split_decode` with the policy's ``kv_split`` (one decode
    without a policy). An int8 cache's write quantizes each row through
    ``pack_kv_into_ring``, one launch for K and V on the card. Under a
    policy the cache holds this rank's slots of the ring (:func:`kv_layout`)
    and only those are written."""
    B, S = positions.shape
    window = cfg.sliding_window if desc.local else 0
    ck, cv = cache["k"], cache["v"]
    cks, cvs = cache.get("k_scale"), cache.get("v_scale")
    L, l0, n_local = kv_layout(cfg, desc, ck.shape[1], policy)
    wpos = positions                                   # the rows written
    if mode == "prefill":
        kq, vq = _kv_for_heads(cfg, k, v, h0, q.shape[2])
        out = flash_attention(q, kq, vq, q_pos=positions, k_pos=positions,
                              causal=True, window=window,
                              softcap_val=cfg.attn_logit_softcap)
        if L < S:          # ring: keep the last L tokens at slots pos % L
            k, v, wpos = k[:, S - L:], v[:, S - L:], positions[:, S - L:]
    _write_ring(cache, k, v, wpos, L, l0)
    if mode == "prefill":
        return out, cache
    pos = positions[:, 0]                              # (B,) current position
    k_pos = ring_positions(pos, L)[:, l0:l0 + ck.shape[1]]
    out = split_decode(q, ck, cv, positions, k_pos, window,
                       cfg.attn_logit_softcap, n_local, cks, cvs,
                       policy if n_local else None)
    return out, cache


def attention_block(lp, cfg, desc, x, positions, cache, mode, paged=None,
                    policy=None):
    """x: (B, S, D); positions (B, S). Returns (attn_out, cache). Mode
    ``"train"``: causal attention over the S tokens with the layer's window
    and softcap, no cache. Under a policy: TP heads (each rank projects its
    columns of wq, wk, wv; k and v gathered to all KV heads; in prefill and
    train each rank attends with its own query heads), the ring cut over
    the policy's ``kv_split_axes`` with split-K decode, and the output
    projection's row blocks summed over ``model``."""
    if mode not in ("train", "prefill", "decode", "paged_prefill",
                    "paged_decode"):
        raise ValueError(f"unknown attention mode {mode!r}")
    B, S, _ = x.shape
    xn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v, h0 = _qkv_heads(lp["attn"], cfg, xn, positions, policy,
                             full_q=mode == "decode")
    if mode == "train":              # this rank's query heads, no cache
        kq, vq = _kv_for_heads(cfg, k, v, h0, q.shape[2])
        out = flash_attention(q, kq, vq, q_pos=positions, k_pos=positions,
                              causal=True,
                              window=cfg.sliding_window if desc.local else 0,
                              softcap_val=cfg.attn_logit_softcap)
    elif mode in ("prefill", "decode"):
        out, cache = _dense_attention(cfg, desc, q, k, v, positions, cache,
                                      mode, h0, policy)
    else:
        out, cache = _paged_attention(cfg, q, k, v, positions, cache, mode,
                                      paged)
    out = out_projection(lp["attn"], cfg, out.reshape(B, S, -1), x.dtype,
                         policy)
    if cfg.post_norms:
        out = rms_norm(out, lp["post_attn_norm"], cfg.norm_eps)
    return out, cache


def out_projection(ap, cfg, out, dtype, policy=None):
    """The attention output (B, S, heads * hd) through ``wo``. Under a
    policy whose ``model`` axis cuts the heads' columns, each rank
    multiplies its block of them (taken from ``out`` where ``out`` holds
    every head) by its rows of ``wo``, and the parts are summed over
    ``model`` in f32."""
    M = policy.model_axis if policy is not None else None
    if policy is None or not policy.splits(cfg.q_dim, M):
        return out @ ap["wo"]
    if out.shape[-1] == cfg.q_dim:     # every head: keep this rank's
        out = policy.split(out, M, -1)
    return policy.all_reduce((out @ ap["wo"]).float(), M).to(dtype)


# ------------------------------------------------------------------ layer
def decoder_layer(lp, cfg, desc, x, positions, cache, mode, placement_row,
                  source_ids, n_sources, collect_stats=True, paged=None,
                  ragged=True, policy=None):
    """Returns (x, cache, stats_or_None). A hybrid layer's mamba branch
    starts from zeros in prefill and train and from the cache's state in
    decode, and in prefill and decode writes its final state into the cache
    in place."""
    attn_out, cache = attention_block(lp, cfg, desc, x, positions, cache,
                                      mode, paged, policy)
    if desc.hybrid:
        xn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        state = None
        if mode == "decode":
            state = {"h": cache["mamba_h"], "conv": cache["mamba_conv"]}
        m_out, m_state = mamba_block(
            lp["mamba"], xn, cfg.ssm.state_dim, cfg.ssm.conv_width,
            state=state, chunk=cfg.ssm.chunk_size, return_state=True,
            policy=policy, d_in=cfg.ssm.expand * cfg.d_model)
        if mode in ("prefill", "decode"):
            cache["mamba_h"].copy_(m_state["h"])
            cache["mamba_conv"].copy_(m_state["conv"])
        # hymba: branch-normalized mean fusion
        x = x + 0.5 * (rms_norm(attn_out, lp["attn_out_norm"], cfg.norm_eps)
                       + rms_norm(m_out, lp["mamba_out_norm"], cfg.norm_eps))
    else:
        x = x + attn_out
    xn = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    stats = None
    if desc.moe:
        # padding rows / inactive lanes stay out of the routing statistics
        mask = paged["valid"] if paged is not None else None
        y, stats = moe_mod.moe_layer(
            lp["moe"], cfg, xn, placement_row, source_ids=source_ids,
            n_sources=n_sources, collect_stats=collect_stats,
            ragged=ragged, token_mask=mask, policy=policy)
    else:
        y = mlp(lp["mlp"], xn, policy, cfg.d_ff)
    if cfg.post_norms:
        y = rms_norm(y, lp["post_ffn_norm"], cfg.norm_eps)
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


def _moe_layers(cfg: ModelConfig):
    """(n_super, [(moe-position index, block position j)]): placement row
    l = i * mp + mi lives at super-block i, position ``blocks/pos{j}``."""
    moe_pos = _moe_positions(period_descriptors(cfg))
    return n_super_blocks(cfg), list(enumerate(moe_pos))


def expert_stacks(params, cfg: ModelConfig) -> List[torch.Tensor]:
    """The stacked expert weight tensors of ``params``, the leaves a
    migration moves (``"shared"`` and the router stay where they are)."""
    _, layers = _moe_layers(cfg)
    return [params["blocks"][f"pos{j}"]["moe"][name] for _, j in layers
            for name in moe_mod.EXPERT_LEAVES]


def _placement_rows(cfg, placement):
    ns, layers = _moe_layers(cfg)
    return torch.as_tensor(placement).to("cpu", torch.long) \
        .reshape(ns, len(layers), -1)


def move_experts(params, cfg: ModelConfig, old_placement, new_placement):
    """Move the stacked expert weights from ``old_placement`` to
    ``new_placement`` in place, layer by layer
    (``moe.migrate_expert_weights``: one expert row beside the weights at
    a time). Returns the number of (layer, slot) rows moved."""
    ns, layers = _moe_layers(cfg)
    if not layers:
        return 0
    old_r = _placement_rows(cfg, old_placement)
    new_r = _placement_rows(cfg, new_placement)
    for i in range(ns):
        for mi, j in layers:
            moe = params["blocks"][f"pos{j}"]["moe"]
            moe_mod.migrate_expert_weights(
                {name: moe[name][i] for name in moe_mod.EXPERT_LEAVES},
                old_r[i, mi], new_r[i, mi])
    # slot new[l] takes logical expert l from slot old[l]
    return int((old_r != new_r).sum())


def migrate_params_for_placement(params, cfg, old_placement, new_placement):
    """Adopt a placement update: move the stacked physical expert weights
    in place (:func:`move_experts`) and return ``params``, the same tree.
    The reference's version is functional and returns a new tree; this one
    holds no second copy of the experts, which at full width would not fit
    beside the first.

    ``placement`` rows are (n_moe_layers, E) = (ns * mp, E); layer l lives at
    super-block l // mp, moe-position index l % mp.
    """
    move_experts(params, cfg, old_placement, new_placement)
    return params


def expert_weight_bytes(cfg) -> int:
    """Bytes of ONE expert's FFN weights (w_gate + w_up + w_down): what an
    asynchronous prefetch moves per (layer, expert) relocation."""
    m = cfg.moe
    if not m.enabled:
        return 0
    itemsize = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    return 3 * cfg.d_model * m.d_expert * itemsize


def stage_expert_prefetch(params, cfg, cur_placement, target_placement):
    """Expert-weight prefetch: gather from the live ``params`` only the
    expert rows that move between ``cur_placement`` and
    ``target_placement``, with their destination slots, leaving ``params``
    as it is. :func:`commit_expert_prefetch` writes them in place when the
    placement is adopted; the stage holds (moved rows) x
    ``expert_weight_bytes`` bytes. Returns a list of (super-block, block
    position, destination slots, {tensor name: rows})."""
    ns, layers = _moe_layers(cfg)
    cur_r = _placement_rows(cfg, cur_placement)
    tgt_r = _placement_rows(cfg, target_placement)
    staged = []
    for i in range(ns):
        for mi, j in layers:
            dst, src = moe_mod.moved_slots(cur_r[i, mi], tgt_r[i, mi])
            if not dst.numel():
                continue
            moe = params["blocks"][f"pos{j}"]["moe"]
            dev = moe["w_gate"].device
            staged.append((i, j, dst.to(dev), {
                name: moe[name][i][src.to(dev)]
                for name in moe_mod.EXPERT_LEAVES}))
    return staged


def commit_expert_prefetch(params, staged) -> int:
    """Write a :func:`stage_expert_prefetch` stage into ``params`` in place
    (the tree it was gathered from, still under the stage's starting
    placement). Returns the number of (layer, slot) rows written."""
    for i, j, dst, rows in staged:
        moe = params["blocks"][f"pos{j}"]["moe"]
        for name, r in rows.items():
            moe[name][i].index_copy_(0, dst, r)
    return sum(dst.numel() for _, _, dst, _ in staged)


def superblock_forward(blk_params, cfg, descs, x, positions, blk_cache,
                       mode, blk_placement, source_ids, n_sources,
                       collect_stats, paged=None, ragged=True, policy=None,
                       plan=None):
    """One super-block (period of layers). Returns (x, stats (mp, ...)).
    ``plan``: the dimensions of each leaf to gather first
    (``sharding.fsdp_plan``: FSDP in training)."""
    if plan is not None:
        blk_params = gather_leaves(blk_params, plan, policy)
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
                                 source_ids, n_sources, collect_stats, paged,
                                 ragged, policy)
        if st is not None:
            stats_list.append(st)
    stats = None
    if stats_list and collect_stats:
        stats = {k: torch.stack([s[k] for s in stats_list])
                 for k in stats_list[0]}
    return x, stats


def _stack_forward(params, cfg, x, positions, cache, mode, placement,
                   source_ids, n_sources, collect_stats, paged=None,
                   ragged=True, remat=False, policy=None, plan=None):
    """Loop over super-blocks. x: (B, S, D). The KV cache or page pool is
    written in place. ``remat``: each super-block's activations are
    recomputed in the backward instead of kept
    (``torch.utils.checkpoint``), so the kernels of a super-block launch
    twice a training step. ``plan``: one layer's gather plan of the
    ``blocks`` leaves (FSDP), applied inside each super-block's region, so
    a gathered block is freed after it and gathered again in the
    recompute. Returns (x, cache, stats (ns * mp, ...))."""
    descs = period_descriptors(cfg)
    ns = n_super_blocks(cfg)
    mp = len(_moe_positions(descs))
    placement_r = None
    if mp and placement is not None and placement.numel():
        placement_r = placement.reshape(ns, mp, -1)
    block = layer_views(params["blocks"]) if policy is None \
        else _sharded_block_views(params["blocks"], ns, policy)
    per_block = []
    for i in range(ns):
        blk_cache = tree_map(lambda a: a[i], cache) \
            if cache is not None else None
        args = (block(i), cfg, descs, x, positions, blk_cache, mode,
                placement_r[i] if placement_r is not None else None,
                source_ids, n_sources, collect_stats, paged, ragged, policy,
                plan)
        if remat:
            x, stats = checkpoint(superblock_forward, *args,
                                  use_reentrant=False)
        else:
            x, stats = superblock_forward(*args)
        per_block.append(stats)
    stats = None
    if per_block and per_block[0] is not None:
        stats = {k: torch.stack([s[k] for s in per_block])
                 .reshape((ns * mp,) + tuple(per_block[0][k].shape[1:]))
                 for k in per_block[0]}
    return x, cache, stats


def _sharded_block_views(blocks, ns: int, policy):
    """``i -> `` super-block i's params on this rank. A stacked leaf whose
    super-block dimension the spec cuts over ``model`` (a MoE layer's shared
    expert, whose 3-d rule lands on that dimension) holds ns / m blocks: its
    block i is on one ``model`` rank, and None on the others. With grads on,
    each leaf is unbound once (:func:`layer_views`)."""
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tree_leaves(blocks))
    me = policy.index(policy.model_axis)

    def picker(a):
        src = a.unbind(0) if grad else a
        n_loc = a.shape[0]
        if n_loc == ns:
            return lambda i: src[i]
        return lambda i: src[i % n_loc] if i // n_loc == me else None

    pickers = tree_map(picker, blocks)
    return lambda i: tree_map(lambda f: f(i), pickers)


def _inputs_to_embed(params, cfg, batch, policy=None):
    """A VLM config's ``batch["embeddings"]`` (B, S, D) where given, else
    the embedded ``batch["tokens"]``."""
    if cfg.input_mode == "embeddings" and "embeddings" in batch:
        return batch["embeddings"]
    return embed_tokens(params["embed"], cfg, batch["tokens"], policy)


def train_view(params, cfg: ModelConfig, policy):
    """Under a train policy over several ranks: (the params as the loss
    reads them, one layer's gather plan of ``blocks``). Every leaf's
    gradient is summed over the batch axes its spec leaves whole
    (``sharding.grad_entry``); the embedding's FSDP dimensions are
    gathered here, each block's inside its super-block
    (:func:`superblock_forward`). (params, None) otherwise."""
    if policy is None or policy.world_size == 1:
        return params, None
    specs = param_specs(cfg, policy)
    params = grad_entry(params, specs, policy)
    plan = fsdp_plan(specs, policy)
    return dict(params, embed=gather_leaves(params["embed"], plan["embed"],
                                            policy)), \
        drop_leading(plan["blocks"])


def loss_fn(params, cfg: ModelConfig, batch, *, placement=None,
            policy=None, aux_weight: float = 0.01, ragged: bool = True):
    """batch: {tokens (B, S) or, for a VLM config, embeddings (B, S, D);
    labels (B, S); mask (B, S) optional} -> (loss, {"ce", "aux"}): the
    token cross-entropy plus ``aux_weight`` times the mean router aux loss
    of the MoE layers (0 without experts). Positions run 0..S-1; ``ragged``
    picks the MoE dispatch, as in the other entry points.

    Under a train policy (``make_policy(..., "train")``) each rank passes
    its rows of the batch and its shard of the params
    (``shard_params(params, make_param_specs(params, cfg, policy),
    policy)``) and gets the loss of the global batch; its gradients are
    the blocks of the global ones that its shards hold (FSDP over the
    data axes, TP and EP over ``model``, :func:`train_view`)."""
    params, plan = train_view(params, cfg, policy)
    x = _inputs_to_embed(params, cfg, batch, policy)
    B, S = x.shape[:2]
    dev = x.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None] \
        .expand(B, S)
    if placement is None:
        placement = identity_placement(cfg, dev)
    x, _, stats = _stack_forward(
        params, cfg, x, positions, None, "train", placement, None, 0,
        collect_stats=cfg.moe.enabled, ragged=ragged, remat=True,
        policy=policy, plan=plan)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    ce = lm_cross_entropy(params["embed"], cfg, x, batch["labels"],
                          batch.get("mask"), policy)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if stats is not None and "aux_loss" in stats:
        aux = stats["aux_loss"].mean()
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def prefill_chunk_paged(params, cfg: ModelConfig, batch, pages, *,
                        block_tables, placement=None, source_ids=None,
                        n_sources: int = 0, collect_stats: bool = True,
                        ragged: bool = True):
    """Chunked prefill into the paged KV pool.

    batch: {tokens (B, S), chunk_starts (B,), chunk_lens (B,)} — row b
    prefills prompt positions [chunk_starts[b], chunk_starts[b] +
    chunk_lens[b]) (rows past chunk_lens are padding and write to the
    garbage page). Earlier chunks' KV is read back through the block table,
    so attention is exact across chunk boundaries. Returns
    (logits_at_chunk_end (B, V), pages, stats); logits are only meaningful
    when the chunk completes the prompt.
    """
    x = _inputs_to_embed(params, cfg, batch)
    B, S = x.shape[:2]
    dev = x.device
    starts = batch["chunk_starts"].to(torch.int32)
    lens = batch["chunk_lens"].to(torch.int32)
    ar = torch.arange(S, dtype=torch.int32, device=dev)[None]
    positions = starts[:, None] + ar
    paged = {"block_tables": block_tables,
             "valid": ar < lens[:, None],
             "chunk_starts": starts,
             "ctx_lens": starts + lens,
             "decode_mask": batch.get("decode_mask")}
    if placement is None:
        placement = identity_placement(cfg, dev)
    x, pages, stats = _stack_forward(
        params, cfg, x, positions, pages, "paged_prefill", placement,
        source_ids, n_sources, collect_stats, paged=paged, ragged=ragged)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[torch.arange(B, device=dev),
             torch.clamp(lens - 1, 0, S - 1).long()]
    return lm_logits(params["embed"], cfg, last), pages, stats


def mixed_step_paged(params, cfg: ModelConfig, batch, pages, *,
                     block_tables, placement=None, source_ids=None,
                     n_sources: int = 0, collect_stats: bool = True,
                     ragged: bool = True):
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
        collect_stats=collect_stats, ragged=ragged)


def decode_step_paged(params, cfg: ModelConfig, tokens, pages, lengths, *,
                      block_tables, active=None, placement=None,
                      source_ids=None, n_sources: int = 0,
                      collect_stats: bool = True, ragged: bool = True):
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
        source_ids, n_sources, collect_stats, paged=paged, ragged=ragged)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params["embed"], cfg, x[:, 0]), pages, stats


# Under a policy (``distributed/sharding.py``) the dense-cache entry points
# run SPMD on every rank of the policy's mesh: each rank passes its rows of
# the batch (the batch cut over ``policy.batch_axes``, ``batch_specs``), its
# shard of the params (``shard_params`` of ``make_param_specs``) and of the
# cache (``cache_specs_tree``), and gets back its rows' logits over the
# whole vocabulary, its cache shard written in place, and the statistics of
# the global batch. A policy over one rank changes no bit.
def prefill(params, cfg: ModelConfig, batch, cache, *, placement=None,
            source_ids=None, n_sources: int = 0, policy=None,
            collect_stats: bool = True, ragged: bool = True):
    """batch: {tokens (B, S) or, for a VLM config, embeddings (B, S, D);
    lengths (B,) optional} -> (logits at each row's last real token (B, V),
    cache, stats). Positions run 0..S-1; the cache (from
    :func:`init_cache`) is written in place."""
    x = _inputs_to_embed(params, cfg, batch, policy)
    B, S = x.shape[:2]
    dev = x.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None] \
        .expand(B, S)
    if placement is None:
        placement = identity_placement(cfg, dev)
    x, cache, stats = _stack_forward(
        params, cfg, x, positions, cache, "prefill", placement, source_ids,
        n_sources, collect_stats, ragged=ragged, policy=policy)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    lengths = batch.get("lengths")
    if lengths is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(B, device=dev),
                 torch.clamp(lengths.long() - 1, 0, S - 1)]
    return lm_logits(params["embed"], cfg, last, policy), cache, stats


def decode_step(params, cfg: ModelConfig, tokens, cache, lengths, *,
                placement=None, source_ids=None, n_sources: int = 0,
                policy=None, collect_stats: bool = True,
                ragged: bool = True):
    """tokens (B,) int32; lengths (B,) current context length per row (the
    new token is written at position lengths[b]). Every row decodes and
    every row's routing counts in the statistics, as in the reference."""
    x = embed_tokens(params["embed"], cfg, tokens[:, None], policy)
    positions = lengths.to(torch.int32)[:, None]
    if placement is None:
        placement = identity_placement(cfg, x.device)
    x, cache, stats = _stack_forward(
        params, cfg, x, positions, cache, "decode", placement, source_ids,
        n_sources, collect_stats, ragged=ragged, policy=policy)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params["embed"], cfg, x[:, 0], policy), cache, stats
