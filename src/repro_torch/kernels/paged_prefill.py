"""Paged chunked-prefill attention: each lane's chunk of new query tokens
against its context in the page pool, read through the block table.

Conventions shared with ``serving/paged.py`` and ``paged_decode``: the pool
is ``(n_pages, page_size, Hkv, hd)``, page 0 is the garbage page, unused
block-table entries are 0. Lane b's chunk row i sits at position
``chunk_starts[b] + i`` and is real while that is below ``ctx_lens[b]``
(the live tokens, this chunk included, whose K/V are already written); it
attends causally to positions ``0 .. chunk_starts[b] + i``. Rows past the
chunk give zeros on the card.

``paged_prefill_attention`` launches ``csrc/paged_prefill.cu`` on a CUDA
tensor, which walks each lane's pages only up to its causal horizon, and
runs ``paged_prefill_attention_plain`` on a CPU tensor. On the card a
launch takes one of two routes, chosen by :func:`tc_eligible` from the
dtype, the head width and the pointers alone: bf16 on the tensor cores, or
the CUDA cores for f32 q and bf16 widths the tiles cannot take. Int8
pages (codes plus ``k_scales``/``v_scales``, ``kernels/kv_pack.py``) take
either route, dequantized in the kernel as ``unpack_kv`` does.
``launches`` counts every launch, ``tc_launches`` those on the tensor
cores.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import counting
from repro_torch.kernels import ops
from repro_torch.kernels.kv_pack import unpack_kv

TC_CODE = 2            # the entry point's dtype code of the tensor cores
TC_HEAD_DIMS = (32, 64, 128)


def tc_eligible(dtype, hd: int, *ptrs: int) -> bool:
    """Whether a launch takes the tensor-core route: bf16, a head width the
    kernel is built for (q's A fragments and the 16 x hd accumulator in
    registers) and every pointer 16-byte aligned (16-byte cp.async). f32
    stays on the CUDA cores by rule: its float32 twins must match the CPU
    to 1e-4."""
    return (dtype == torch.bfloat16 and hd in TC_HEAD_DIMS
            and all(p % 16 == 0 for p in ptrs))


def paged_prefill_attention_plain(q, k_pages, v_pages, block_tables,
                                  chunk_starts, ctx_lens, k_scales=None,
                                  v_scales=None, softcap=0.0):
    """Gather each lane's whole block table (NB * ps slots, dequantized on
    int8 pages), then ``flash_attention`` over it with the causal mask from
    absolute positions: the f32 loop of ``models/attention.py``, p rounded
    to the KV dtype before P.V."""
    # the models layer's attention loop, imported here so that the kernels
    # layer does not depend on the models layer at import
    from repro_torch.models.attention import flash_attention
    B, S = q.shape[:2]
    P, ps, Hkv, hd = k_pages.shape
    L = block_tables.shape[1] * ps
    btl = block_tables.long()
    kd = k_pages[btl].reshape(B, L, Hkv, hd)
    vd = v_pages[btl].reshape(B, L, Hkv, hd)
    if k_scales is not None:                           # dequant the gather
        kd = unpack_kv(kd, k_scales[btl].reshape(B, L, Hkv), q.dtype)
        vd = unpack_kv(vd, v_scales[btl].reshape(B, L, Hkv), q.dtype)
    ctx = ctx_lens.to(torch.int32)
    kpos = torch.arange(L, dtype=torch.int32, device=q.device)[None]
    kpos = torch.where(kpos < ctx[:, None], kpos, torch.full_like(kpos, -1))
    q_pos = chunk_starts.to(torch.int32)[:, None] \
        + torch.arange(S, dtype=torch.int32, device=q.device)[None]
    return flash_attention(q, kd, vd, q_pos=q_pos, k_pos=kpos, causal=True,
                           window=0, softcap_val=softcap)


def paged_prefill_cost(B, S, Hq, Hkv, hd, NB, starts, lens, q_item,
                       page_item, int8=False):
    """(FLOPs, bytes) of one call: the causal products of the real rows
    (row i of a lane with ``start`` and ``len`` reads ``start + i + 1``
    slots: q.k and P.V, 2 FLOPs a multiply-add each), q read and the output
    written, K and V of each lane's live slots (``start + len``) once
    (codes and f32 scales on int8 pages), the block tables and the two
    length vectors."""
    keys = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts, lens)
               if n > 0)
    live = sum(s + n for s, n in zip(starts, lens) if n > 0)
    row_bytes = hd * page_item + (4 if int8 else 0)
    nbytes = 2 * B * S * Hq * hd * q_item + live * Hkv * 2 * row_bytes \
        + B * NB * 4 + 2 * B * 4
    return 4 * keys * Hq * hd, nbytes


def _cost_of(q, k_pages, v_pages, block_tables, chunk_starts, ctx_lens, *,
             k_scales=None, v_scales=None, softcap=0.0):
    B, S, Hq, hd = q.shape
    starts = chunk_starts.tolist()
    lens = [min(c - s, S) for s, c in zip(starts, ctx_lens.tolist())]
    return paged_prefill_cost(B, S, Hq, k_pages.shape[2], hd,
                              block_tables.shape[1], starts, lens,
                              q.element_size(), k_pages.element_size(),
                              k_scales is not None)


@counting.counted("paged_prefill", _cost_of)
def paged_prefill_attention(q, k_pages, v_pages, block_tables, chunk_starts,
                            ctx_lens, *, k_scales=None, v_scales=None,
                            softcap=0.0):
    """q (B, S, Hq, hd) bf16/f32; pages (P, ps, Hkv, hd) in q's dtype, or
    int8 with ``k_scales``/``v_scales`` (P, ps, Hkv) f32; block_tables
    (B, NB), chunk_starts and ctx_lens (B,) int32 -> (B, S, Hq, hd) in q's
    dtype. No logit softcap (no paged family has one)."""
    if softcap:
        raise ValueError("paged_prefill_attention: no logit softcap (the "
                         "paged pool refuses the families that have one)")
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pages, v_pages,
                                             block_tables, chunk_starts,
                                             ctx_lens, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for device "
                         f"{q.device}")
    B, S, Hq, hd = q.shape
    P, ps, Hkv, hd_k = k_pages.shape
    if hd_k != hd or v_pages.shape != k_pages.shape or Hq % Hkv:
        raise ValueError(f"paged_prefill_attention: q {tuple(q.shape)} does "
                         f"not fit pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(chunk_starts.shape) != (B,) \
            or tuple(ctx_lens.shape) != (B,):
        raise ValueError("paged_prefill_attention: block_tables must be "
                         "(B, NB), chunk_starts and ctx_lens (B,)")
    quant = k_scales is not None
    page_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in ops.DTYPE_CODE or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype:
        raise TypeError(f"paged_prefill_attention: q must be bf16/f32 and "
                        f"the pages {page_dtype} (int8 pages need k_scales "
                        f"and v_scales), got dtypes {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if hd > 256:
        raise ValueError(f"paged_prefill_attention: hd {hd} > 256")
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "chunk_starts": chunk_starts,
               "ctx_lens": ctx_lens}
    if quant:
        if v_scales is None or k_scales.dtype != torch.float32 \
                or v_scales.dtype != torch.float32 \
                or tuple(k_scales.shape) != (P, ps, Hkv) \
                or tuple(v_scales.shape) != (P, ps, Hkv):
            raise ValueError(f"paged_prefill_attention: int8 pages need "
                             f"k_scales and v_scales of shape "
                             f"{(P, ps, Hkv)} in f32")
        tensors.update(k_scales=k_scales, v_scales=v_scales)
    elif v_scales is not None:
        raise ValueError("paged_prefill_attention: v_scales without "
                         "k_scales")
    ops.check_int32("paged_prefill_attention",
                    {"block_tables": block_tables,
                     "chunk_starts": chunk_starts, "ctx_lens": ctx_lens})
    ops.check_cuda("paged_prefill_attention", tensors, q.device)
    out = torch.empty_like(q)
    tc = tc_eligible(q.dtype, hd, q.data_ptr(), k_pages.data_ptr(),
                     v_pages.data_ptr(), out.data_ptr())
    code = TC_CODE if tc else ops.DTYPE_CODE[q.dtype]
    ops.launch("paged_prefill", q.data_ptr(), k_pages.data_ptr(),
               v_pages.data_ptr(), k_scales.data_ptr() if quant else None,
               v_scales.data_ptr() if quant else None,
               block_tables.data_ptr(), chunk_starts.data_ptr(),
               ctx_lens.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, hd, ps,
               block_tables.shape[1], float(1.0 / np.sqrt(hd)), code,
               int(quant), device=q.device)
    paged_prefill_attention.launches += 1
    paged_prefill_attention.tc_launches += tc
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.tc_launches = 0
