"""Flash-decode attention: one new token per request against a dense KV cache.

The cache is slot-indexed: ``(B, L, Hkv, hd)`` per layer, with ``k_pos``
``(B, L)`` holding the absolute position in each slot and -1 for a slot
never written (a ring cache: ``models/attention.py::ring_positions``). Slot
l of row b is attended iff ``0 <= k_pos[b, l] <= q_pos[b]`` and, with a
sliding window (``window > 0``), ``k_pos[b, l] > q_pos[b] - window``. With
a logit softcap (``softcap > 0``) a scaled score s becomes ``softcap *
tanh(s / softcap)`` before the mask. An int8 cache comes with f32
``k_scale``/``v_scale`` (B, L, Hkv) and is dequantized on read as the
reference's dense decode does: ``bf16(code * scale)``, whatever q's type.
A row with no valid slot gives exact zeros, as the reference's Pallas
kernel does.

``flash_decode`` launches the CUDA kernel ``csrc/flash_decode.cu`` on a CUDA
tensor and runs ``flash_decode_plain`` on a CPU tensor. On the card a launch
takes the route ``decode_route.tc_eligible`` picks (bf16 on the tensor
cores, else the CUDA cores: f32, and hd = 256), as ``paged_decode`` does;
``launches`` counts every launch, ``tc_launches`` those on the tensor cores.

For split-K decode (``models/transformer.py::split_decode``, the
reference's ``_split_decode``) a call over one shard of the cache returns,
with ``return_lse=True``, its f32 output, not rounded to q's type, and each
row's log-sum-exp over its valid slots (-inf where there is none, with an
output of zeros); the shards combine as ``combine_partials`` does. A shard
may be a slice ``cache[:, l0:l1]`` of a longer cache: the kernel reads it
in place (its batch stride is passed in).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import decode_route, ops
from repro_torch import counting

NEG_INF = -1e30


def flash_decode_plain(q, k_cache, v_cache, k_pos, q_pos, *, window=0,
                       softcap=0.0, k_scale=None, v_scale=None,
                       return_lse=False):
    """Masked softmax attention in f32 (the same function as the kernel):
    masked weights are zeroed after the exponent, so a row with no valid
    slot divides 0 by max(0, 1e-30) and gives zeros. ``return_lse``: (f32
    output, (B, Hq) f32 log-sum-exp, -inf for a row with no valid slot)."""
    B, Hq, hd = q.shape
    _, L, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    kf, vf = k_cache.float(), v_cache.float()
    if k_scale is not None:       # int8: the reference's bf16 dequantization
        kf = (kf * k_scale[..., None]).to(torch.bfloat16).float()
        vf = (vf * v_scale[..., None]).to(torch.bfloat16).float()
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bkgd,blkd->bkgl", qg, kf) / np.sqrt(hd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    valid = valid_slots(k_pos, q_pos, window)[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgl,blkd->bkgd", p, vf)
    out = acc / torch.clamp(l, min=1e-30)
    if return_lse:
        lse = torch.where(l > 0, m + torch.log(l),
                          torch.full_like(l, -float("inf")))
        return out.reshape(B, Hq, hd), lse.reshape(B, Hq)
    return out.reshape(B, Hq, hd).to(q.dtype)


def flash_decode_cost(B, Hq, Hkv, hd, L, n_valid, q_item, cache_item,
                      int8=False, return_lse=False):
    """(FLOPs, bytes) of one call over ``n_valid`` valid (row, slot) pairs
    of a (B, L) cache: q read in its type, the output written (in q's type,
    or a split-K shard's f32 output and log-sum-exp), K and V of the valid
    slots (codes and f32 scales on an int8 cache), the positions."""
    row_bytes = hd * cache_item + (4 if int8 else 0)
    out_bytes = B * Hq * hd * 4 + B * Hq * 4 if return_lse \
        else B * Hq * hd * q_item
    nbytes = B * Hq * hd * q_item + out_bytes \
        + n_valid * Hkv * 2 * row_bytes + B * L * 4 + B * 4
    return 4 * n_valid * Hq * hd, nbytes


def valid_slots(k_pos, q_pos, window: int = 0):
    """(B, L) bool: the slots a row attends (the kernel's mask)."""
    kp, qp = k_pos.long(), q_pos.long()[:, None]
    valid = (kp >= 0) & (kp <= qp)
    if window > 0:
        valid = valid & (kp > qp - window)
    return valid


def _cost_of(q, k_cache, v_cache, k_pos, q_pos, *, window=0, softcap=0.0,
             k_scale=None, v_scale=None, return_lse=False):
    B, Hq, hd = q.shape
    return flash_decode_cost(
        B, Hq, k_cache.shape[2], hd, k_cache.shape[1],
        int(valid_slots(k_pos, q_pos, window).sum()), q.element_size(),
        k_cache.element_size(), k_scale is not None, return_lse)


@counting.counted("flash_decode", _cost_of)
def flash_decode(q, k_cache, v_cache, k_pos, q_pos, *, window: int = 0,
                 softcap: float = 0.0, k_scale=None, v_scale=None,
                 return_lse: bool = False):
    """q (B, Hq, hd) bf16/f32; k_cache, v_cache (B, L, Hkv, hd) in q's dtype,
    or int8 with ``k_scale``/``v_scale`` (B, L, Hkv) f32; k_pos (B, L)
    int32 (-1 = empty slot); q_pos (B,) int32 -> (B, Hq, hd) in q's dtype.
    ``window`` <= 0 and ``softcap`` <= 0 turn those terms off.
    ``return_lse``: (f32 output, (B, Hq) f32 log-sum-exp), a split-K
    shard's partial. The caches and scales may be slices along L of longer
    ones (contiguous but for their batch stride)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, k_pos, q_pos,
                                  window=window, softcap=softcap,
                                  k_scale=k_scale, v_scale=v_scale,
                                  return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    B, Hq, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[3] != hd \
            or v_cache.shape != k_cache.shape or Hq % k_cache.shape[2]:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit the "
                         f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)}")
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    if tuple(k_pos.shape) != (B, L) or tuple(q_pos.shape) != (B,):
        raise ValueError(f"flash_decode: k_pos must be {(B, L)} and q_pos "
                         f"{(B,)}, got {tuple(k_pos.shape)}, "
                         f"{tuple(q_pos.shape)}")
    quant = k_scale is not None
    cache_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in ops.DTYPE_CODE or k_cache.dtype != cache_dtype \
            or v_cache.dtype != cache_dtype:
        raise TypeError(f"flash_decode: q must be bf16/f32 and the caches "
                        f"{cache_dtype}, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    bstride = _batch_stride(k_cache, v_cache, L, Hkv, hd)
    tensors = {"q": q, "k_pos": k_pos, "q_pos": q_pos}
    if quant:
        if v_scale is None or k_scale.dtype != torch.float32 \
                or v_scale.dtype != torch.float32 \
                or tuple(k_scale.shape) != (B, L, Hkv) \
                or tuple(v_scale.shape) != (B, L, Hkv):
            raise ValueError(f"flash_decode: an int8 cache needs k_scale and "
                             f"v_scale of shape {(B, L, Hkv)} in f32")
        if _batch_stride(k_scale[..., None], v_scale[..., None], L, Hkv,
                         1) != bstride:
            raise ValueError("flash_decode: the scales must be laid out as "
                             "the caches")
    elif v_scale is not None:
        raise ValueError("flash_decode: v_scale without k_scale")
    ops.check_int32("flash_decode", {"k_pos": k_pos, "q_pos": q_pos})
    ops.check_cuda("flash_decode", tensors, q.device)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and t.device != q.device:
            raise ValueError(f"flash_decode: {name} is on {t.device}, not "
                             f"{q.device}")
    if (hd * k_cache.element_size()) % 16 or k_cache.data_ptr() % 16 \
            or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode: the kernel reads 16-byte vectors: "
                         "hd * cache itemsize must be a multiple of 16 and "
                         "the caches 16-byte aligned")
    split_tokens, n_split = decode_route.split_plan(L)
    code = decode_route.route_code(q.dtype, hd, Hq // Hkv, q.data_ptr(),
                                   k_cache.data_ptr(), v_cache.data_ptr())
    out = torch.empty(q.shape, dtype=torch.float32 if return_lse else q.dtype,
                      device=q.device)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    scratch = decode_route.scratch(B, Hq, n_split, hd, q.device)
    ops.launch("flash_decode", q.data_ptr(), k_cache.data_ptr(),
               v_cache.data_ptr(), k_scale.data_ptr() if quant else None,
               v_scale.data_ptr() if quant else None, k_pos.data_ptr(),
               q_pos.data_ptr(), scratch.data_ptr(), out.data_ptr(),
               lse.data_ptr() if return_lse else None, B, Hq, Hkv, hd, L,
               bstride, n_split, split_tokens, int(window),
               float(1.0 / np.sqrt(hd)), float(softcap), code,
               device=q.device)
    flash_decode.launches += 1
    flash_decode.tc_launches += code == decode_route.TC_CODE
    return (out, lse) if return_lse else out


def _batch_stride(k_cache, v_cache, L, Hkv, hd) -> int:
    """The caches' batch stride in slots: each row's (L, Hkv, hd) block
    must be contiguous, and both caches laid out alike."""
    inner = (Hkv * hd, hd, 1)
    if k_cache.shape[0] == 1:          # one row: its stride is never used
        if tuple(k_cache.stride()[1:]) != inner \
                or tuple(v_cache.stride()[1:]) != inner:
            raise ValueError("flash_decode: each row of the caches must be "
                             "contiguous")
        return L
    if tuple(k_cache.stride()[1:]) != inner \
            or v_cache.stride() != k_cache.stride() \
            or k_cache.stride(0) % (Hkv * hd) \
            or k_cache.stride(0) < L * Hkv * hd:
        raise ValueError("flash_decode: each row of the caches must be "
                         "contiguous (a slice along L of a contiguous cache "
                         "at most), both laid out alike")
    return k_cache.stride(0) // (Hkv * hd)


flash_decode.launches = 0
flash_decode.tc_launches = 0
