"""Blocked (flash-style) attention in plain PyTorch, for chunked prefill.

The reference's ``flash_attention`` is plain JAX (no Pallas kernel), so it
stays plain here: a loop over KV blocks with a running max and sum in f32.
Like the reference, the softmax weights ``p`` are cast to the KV dtype
before the PV product; ``scaled_dot_product_attention`` would not reproduce
that rounding. Invalid KV slots are encoded as ``k_pos < 0``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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
    outs = []
    for q0 in range(0, Sq, q_block):
        qcur = qg[:, q0:q0 + q_block]
        qpos = q_pos[:, q0:q0 + q_block]
        Bq = qcur.shape[1]
        m = torch.full((B, Hkv, G, Bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, Bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, Bq, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Skv, kv_block):
            m, l, acc = _attend_one_kv_block(
                qcur, k[:, k0:k0 + kv_block], v[:, k0:k0 + kv_block], qpos,
                k_pos[:, k0:k0 + kv_block], scale=scale, causal=causal,
                window=window, cap=softcap_val, m=m, l=l, acc=acc)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B,Bq,Hkv,G,hd)
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, hd)
