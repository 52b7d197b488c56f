"""Attention for prefill and for dense-cache decode.

``flash_attention`` (prefill, chunked prefill): the reference's is plain JAX
(no Pallas kernel), so it stays plain here: a loop over KV blocks with a
running max and sum in f32. Like the reference, the softmax weights ``p``
are cast to the KV dtype before the PV product;
``scaled_dot_product_attention`` would not reproduce that rounding.

``decode_attention`` (one token against a dense ring cache, with the
reference's window, softcap and int8 dequantization) goes through the
flash-decode kernel (``kernels/flash_decode.py``), whose softmax weights
stay f32. The reference's ``decode_attention`` goes through its
``flash_attention`` and so rounds them to the KV dtype: the two agree in
float32 and to the bf16 tolerance in bf16 (ROADMAP.md Queue C).

Invalid KV slots are encoded as ``k_pos < 0``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.layers import softcap as _softcap

NEG_INF = -1e30


def _attend_one_kv_block(q, kb, vb, qpos, kpos, *, scale, causal, window, cap,
                         m, l, acc):
    """One running-softmax update.

    q: (B, Sq, Hkv, G, hd)  kb/vb: (B, Bk, Hkv, hd)
    qpos: (B, Sq) kpos: (B, Bk) | m,l: (B, Hkv, G, Sq) acc: (B, Hkv, G, Sq, hd)
    """
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), kb.float()) * scale
    if cap > 0.0:
        s = _softcap(s, cap)
    kp = kpos[:, None, None, None, :]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qpos[:, None, None, :, None])
    if window > 0:
        valid = valid & (kp > qpos[:, None, None, :, None] - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))

    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(valid, p, torch.zeros_like(p))
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vb.dtype).float(), vb.float())
    acc_new = acc * corr[..., None] + pv
    return m_new, l_new, acc_new


# the f32 scores of a :func:`flash_attention` call (B * Hq * Sq * Skv * 4
# bytes) past which its backward recomputes each query block's instead of
# keeping them: 4 rows of 512 tokens at 32 heads keep 134 MB, a rank's 16
# rows of 4096 tokens at 40 heads would keep a few times 43 GB a layer
REMAT_SCORES_BYTES = 2 ** 30


def flash_attention(q, k, v, *, q_pos, k_pos, causal: bool = True,
                    window: int = 0, softcap_val: float = 0.0,
                    q_block: int = 512, kv_block: int = 512,
                    scale: Optional[float] = None):
    """q: (B, Sq, Hq, hd), k/v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd).

    q_pos: (B, Sq) absolute positions; k_pos: (B, Skv) absolute positions
    with -1 marking invalid slots.
    """
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd)
    kw = dict(scale=scale, causal=causal, window=window, cap=softcap_val,
              kv_block=kv_block)
    # under autograd, where the call's f32 scores pass REMAT_SCORES_BYTES,
    # each query block's softmax is recomputed in the backward
    # (``torch.utils.checkpoint``), the same ops in the same order: kept, a
    # KV block's scores and weights are a few (B, Hkv, G, q_block,
    # kv_block) f32 tensors, 140 GB a layer at 16 rows of 4096 tokens with
    # 40 heads. Below it they are kept, and the forward runs no third time
    # under the super-block's own recompute. (Not each KV step as well: a
    # checkpoint holds its inputs, which the enclosing super-block's
    # checkpoint cannot drop, and a KV step's running state is as large as
    # a query block's output.)
    grad = torch.is_grad_enabled() \
        and any(t.requires_grad for t in (q, k, v)) \
        and B * Hq * Sq * Skv * 4 > REMAT_SCORES_BYTES
    outs = []
    for q0 in range(0, Sq, q_block):
        args = (qg[:, q0:q0 + q_block], k, v, q_pos[:, q0:q0 + q_block],
                k_pos)
        outs.append(checkpoint(_attend_q_block, *args, **kw,
                               use_reentrant=False) if grad
                    else _attend_q_block(*args, **kw))
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, hd)


def _attend_q_block(qcur, k, v, qpos, k_pos, *, scale, causal, window, cap,
                    kv_block):
    """One query block against every KV block: (B, Bq, Hkv, G, hd) in q's
    dtype."""
    B, Bq, Hkv, G, hd = qcur.shape
    m = torch.full((B, Hkv, G, Bq), NEG_INF, dtype=torch.float32,
                   device=qcur.device)
    l = torch.zeros((B, Hkv, G, Bq), dtype=torch.float32, device=qcur.device)
    acc = torch.zeros((B, Hkv, G, Bq, hd), dtype=torch.float32,
                      device=qcur.device)
    for k0 in range(0, k.shape[1], kv_block):
        m, l, acc = _attend_one_kv_block(
            qcur, k[:, k0:k0 + kv_block], v[:, k0:k0 + kv_block], qpos,
            k_pos[:, k0:k0 + kv_block], scale=scale, causal=causal,
            window=window, cap=cap, m=m, l=l, acc=acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(qcur.dtype)


def decode_attention(q, k_cache, v_cache, *, q_pos, k_pos, window: int = 0,
                     softcap_val: float = 0.0, k_scale=None, v_scale=None):
    """Single-token decode attention against a (ring-buffered) KV cache.

    q: (B, 1, Hq, hd); caches: (B, L, Hkv, hd), or int8 with ``k_scale``,
    ``v_scale`` (B, L, Hkv) f32; q_pos: (B, 1); k_pos: (B, L) with -1
    marking never-written slots -> (B, 1, Hq, hd). ``window`` > 0 masks
    slots at or before q_pos - window; ``softcap_val`` > 0 caps the scaled
    scores. The flash-decode kernel on the card, its plain version on the
    CPU.
    """
    out = flash_decode(q[:, 0].contiguous(), k_cache, v_cache,
                       k_pos.to(torch.int32).contiguous(),
                       q_pos[:, 0].to(torch.int32).contiguous(),
                       window=window, softcap=softcap_val, k_scale=k_scale,
                       v_scale=v_scale)
    return out[:, None]


def ring_positions(write_pos, cache_len: int):
    """Positions held by a ring buffer after ``write_pos + 1`` total writes.

    Slot i holds absolute position p = last p <= write_pos with p % L == i,
    or -1 if that slot was never written. write_pos: (B,) int.
    Returns (B, L) int32.
    """
    i = torch.arange(cache_len, device=write_pos.device)[None, :]
    wp = write_pos.long()[:, None]
    p = wp - torch.remainder(wp - i, cache_len)
    return torch.where(p >= 0, p, torch.full_like(p, -1)).to(torch.int32)
