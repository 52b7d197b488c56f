"""Paged flash-decode attention (block-table KV, single-token decode).

The KV cache lives in a physical page pool ``(n_pages, page_size, Hkv, hd)``
shared by every request; each request owns a *block table*, the ordered
list of page ids holding its context. Conventions shared with
``serving/paged.py``: page 0 is the reserved garbage page, unused
block-table entries are 0, and ``ctx_lens[b]`` is the number of live tokens
(a row with ``ctx_lens == 0`` gives a zero output vector).

``paged_decode`` launches the CUDA kernel ``csrc/paged_decode.cu`` on a CUDA
tensor and runs ``paged_decode_plain`` on a CPU tensor. Int8 pages are not
served yet (see ROADMAP.md, Queue B).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

NEG_INF = -1e30
# context tokens per block of the kernel's partial pass (a multiple of 32)
SPLIT_TOKENS = 128


def paged_decode_plain(q, k_pages, v_pages, block_tables, ctx_lens):
    """Gather each request's dense KV view, then masked softmax attention
    in f32 (the same function as the kernel)."""
    B, Hq, hd = q.shape
    P, ps, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    L = NB * ps
    bt = block_tables.long()
    kd = k_pages[bt].reshape(B, L, Hkv, hd).float()
    vd = v_pages[bt].reshape(B, L, Hkv, hd).float()
    kpos = torch.arange(L, device=q.device)[None]
    valid = kpos < ctx_lens.long()[:, None]                     # (B, L)
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bkgd,blkd->bkgl", qg, kd) / np.sqrt(hd)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vmask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgl,blkd->bkgd", p, vd)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, hd).to(q.dtype)


def paged_decode(q, k_pages, v_pages, block_tables, ctx_lens):
    """q (B, Hq, hd); pages (P, ps, Hkv, hd); block_tables (B, NB) int32;
    ctx_lens (B,) int32 -> (B, Hq, hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_tables, ctx_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: no kernel for device {q.device}")
    B, Hq, hd = q.shape
    P, ps, Hkv, hd_k = k_pages.shape
    if hd_k != hd or v_pages.shape != k_pages.shape or Hq % Hkv:
        raise ValueError(f"paged_decode: q {tuple(q.shape)} does not fit "
                         f"pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(ctx_lens.shape) != (B,):
        raise ValueError("paged_decode: block_tables must be (B, NB) and "
                         "ctx_lens (B,)")
    if q.dtype not in ops.DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode: q and pages must share a dtype in "
                        f"bf16/f32, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    ops.check_int32("paged_decode", {"block_tables": block_tables,
                                     "ctx_lens": ctx_lens})
    ops.check_cuda("paged_decode", {"q": q, "k_pages": k_pages,
                                    "v_pages": v_pages,
                                    "block_tables": block_tables,
                                    "ctx_lens": ctx_lens}, q.device)
    if (hd * q.element_size()) % 16 or k_pages.data_ptr() % 16 \
            or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode: the kernel reads 16-byte vectors: "
                         "hd * itemsize must be a multiple of 16 and the "
                         "pages 16-byte aligned")
    NB = block_tables.shape[1]
    n_split = max(1, -(-NB * ps // SPLIT_TOKENS))
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((B, Hq, n_split), **f32)
    l_part = torch.empty((B, Hq, n_split), **f32)
    acc_part = torch.empty((B, Hq, n_split, hd), **f32)
    ops.launch("paged_decode", q.data_ptr(), k_pages.data_ptr(),
               v_pages.data_ptr(), block_tables.data_ptr(),
               ctx_lens.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
               acc_part.data_ptr(), out.data_ptr(), B, Hq, Hkv, hd, ps, NB,
               n_split, SPLIT_TOKENS, float(1.0 / np.sqrt(hd)),
               ops.DTYPE_CODE[q.dtype], device=q.device)
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
