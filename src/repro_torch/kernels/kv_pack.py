"""Int8 KV rows: per-row symmetric quantization (``pack_kv``) and its
inverse (``unpack_kv``).

The paged pool's int8 mode (``PagedEngineConfig.kv_dtype="int8"``) stores
each KV row (one token, one KV head) as int8 values plus one f32 scale,
``scale = max(|row|) / 127``, so a fixed pool holds ``2*hd / (hd + 4)``
times the tokens of the 2-byte layout. Values are
``round_half_even(x / max(scale, 1e-8))``; a zero row gives scale 0 and
zeros.

``pack_kv_into_pages`` is the whole KV write of a layer into int8 pages:
it computes each written row's page slot from the block tables, quantizes
the rows of K and V and stores codes and scales in place, in one launch.
``pack_kv_into_ring`` is the same write into a dense ring cache.
``pack_kv`` is the same quantization into fresh tensors, the counterpart
of the reference's ``pack_kv_pallas``. ``unpack_kv`` is the dequantization
of gathered pages in the plain chunked prefill
(``paged_prefill_attention_plain``; the paged decode and prefill kernels
dequantize inside themselves). Each launches ``csrc/kv_pack.cu`` on a CUDA tensor and runs
its plain version on a CPU tensor; ``pack_kv.launches`` counts the
launches of both pack entries.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch import counting


def pack_kv_cost(rows, hd, item):
    """(operations, bytes) of quantizing ``rows`` rows of ``hd``: the rows
    read, codes and f32 scales written; |x|, max, a division and a
    conversion a value."""
    return 4 * rows * hd, rows * hd * item + rows * hd + rows * 4


def pack_kv_write_cost(n, n_written, hd, item, index_bytes):
    """(operations, bytes) of the int8 write of K and V, ``n`` rows each
    read, ``n_written`` rows' codes and scales written, plus the
    ``index_bytes`` of the slots' inputs (positions, block tables,
    validity)."""
    return 2 * 4 * n * hd, \
        2 * (n * hd * item + n_written * (hd + 4)) + index_bytes


def unpack_kv_cost(n, rows, out_item):
    """(operations, bytes) of dequantizing ``n`` codes in ``rows`` rows:
    codes and scales read, the output written."""
    return 2 * n, n + rows * 4 + n * out_item


def pack_kv_plain(t):
    """(..., hd) bf16/f32 -> ((..., hd) int8, (...) f32 scales)."""
    x = t.float()
    # divide by a tensor, not a Python number: on a CUDA tensor PyTorch
    # turns division by a scalar into a multiply by its rounded reciprocal,
    # which moves the scale by one ulp on some rows
    s = x.abs().amax(dim=-1) / torch.full((), 127.0, device=x.device)
    q = torch.round(x / torch.clamp(s, min=1e-8)[..., None]).to(torch.int8)
    return q, s


def page_slots(block_tables, positions, valid, page_size):
    """The (page, offset) each written row of a (B, S) chunk goes to,
    flattened to (B*S,) int64: position p of row b lands in page
    ``block_tables[b, clamp(p // page_size, 0, NB - 1)]`` at ``p %
    page_size``; invalid rows go to slot 0 of page 0, the garbage page."""
    B = positions.shape[0]
    NB = block_tables.shape[1]
    bidx = torch.arange(B, device=positions.device)[:, None]
    blk = torch.clamp(torch.div(positions, page_size, rounding_mode="floor"),
                      0, NB - 1).long()
    zero = torch.zeros((), dtype=torch.long, device=positions.device)
    page = torch.where(valid, block_tables.long()[bidx, blk], zero)
    off = torch.where(valid, (positions % page_size).long(), zero)
    return page.reshape(-1), off.reshape(-1)


def pack_kv_into_pages_plain(k, v, pool_k, pool_v, k_scale, v_scale,
                             block_tables, positions, valid):
    """:func:`pack_kv_plain` of k and v (B, S, Hkv, hd), then their codes
    and scales scattered in place into the int8 pages pool_k, pool_v
    (P, ps, Hkv, hd) and k_scale, v_scale (P, ps, Hkv) at
    :func:`page_slots`."""
    page, off = page_slots(block_tables, positions, valid, pool_k.shape[1])
    Hkv, hd = pool_k.shape[2], pool_k.shape[3]
    for x, pool, scale in ((k, pool_k, k_scale), (v, pool_v, v_scale)):
        q, s = pack_kv_plain(x)
        scale[page, off] = s.reshape(-1, Hkv)
        pool[page, off] = q.reshape(-1, Hkv, hd)


def unpack_kv_plain(q, s, dtype=torch.float32):
    """Inverse of :func:`pack_kv_plain` (up to quantization error)."""
    return (q.float() * s[..., None].float()).to(dtype)


@counting.counted("pack_kv", lambda t: pack_kv_cost(
    t.numel() // t.shape[-1], t.shape[-1], t.element_size()))
def pack_kv(t):
    """(..., hd) bf16/f32 -> ((..., hd) int8, (...) f32 scales)."""
    if t.device.type == "cpu":
        return pack_kv_plain(t)
    if t.device.type != "cuda":
        raise ValueError(f"pack_kv: no kernel for device {t.device}")
    if t.dtype not in ops.DTYPE_CODE or t.dim() == 0:
        raise TypeError(f"pack_kv: expected a bf16/f32 tensor with a last "
                        f"axis, got {t.dtype} of shape {tuple(t.shape)}")
    t = t.contiguous()
    hd = t.shape[-1]
    q = torch.empty(t.shape, dtype=torch.int8, device=t.device)
    s = torch.empty(t.shape[:-1], dtype=torch.float32, device=t.device)
    ops.launch("pack_kv", t.data_ptr(), q.data_ptr(), s.data_ptr(),
               s.numel(), hd, ops.DTYPE_CODE[t.dtype], device=t.device)
    pack_kv.launches += 1
    return q, s


def _pages_cost_of(k, v, pool_k, pool_v, k_scale, v_scale, block_tables,
                   positions, valid):
    Hkv, hd = k.shape[2], k.shape[3]
    return pack_kv_write_cost(
        positions.numel() * Hkv, int(valid.sum()) * Hkv, hd,
        k.element_size(),
        4 * (block_tables.numel() + positions.numel()) + valid.numel())


@counting.counted("pack_kv", _pages_cost_of)
def pack_kv_into_pages(k, v, pool_k, pool_v, k_scale, v_scale, block_tables,
                       positions, valid):
    """Quantize k and v (B, S, Hkv, hd) bf16/f32 row by row and write codes
    and scales in place into the int8 pages pool_k, pool_v (P, ps, Hkv, hd)
    and k_scale, v_scale (P, ps, Hkv) f32, at the slots :func:`page_slots`
    gives from block_tables (B, NB) int32, positions (B, S) int32 and valid
    (B, S) bool. On a CUDA tensor one launch does it all; invalid rows race
    on page 0, the garbage page."""
    if k.device.type == "cpu":
        return pack_kv_into_pages_plain(k, v, pool_k, pool_v, k_scale,
                                        v_scale, block_tables, positions,
                                        valid)
    if k.device.type != "cuda":
        raise ValueError(f"pack_kv_into_pages: no kernel for device "
                         f"{k.device}")
    name = "pack_kv_into_pages"
    if k.dtype not in ops.DTYPE_CODE or v.dtype != k.dtype:
        raise TypeError(f"{name}: k and v must both be bf16 or f32, got "
                        f"{k.dtype} and {v.dtype}")
    if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8 \
            or k_scale.dtype != torch.float32 \
            or v_scale.dtype != torch.float32:
        raise TypeError(f"{name}: expected int8 pages and f32 scales")
    if valid.dtype != torch.bool:
        raise TypeError(f"{name}: valid must be bool, got {valid.dtype}")
    ops.check_int32(name, {"block_tables": block_tables,
                           "positions": positions})
    P, ps, Hkv, hd = pool_k.shape
    B, S = positions.shape
    if tuple(k.shape) != (B, S, Hkv, hd) or v.shape != k.shape \
            or pool_v.shape != pool_k.shape \
            or tuple(k_scale.shape) != (P, ps, Hkv) \
            or v_scale.shape != k_scale.shape \
            or valid.shape != positions.shape \
            or block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: shapes do not fit: k {tuple(k.shape)}, "
                         f"pages {tuple(pool_k.shape)}, scales "
                         f"{tuple(k_scale.shape)}, positions {(B, S)}, "
                         f"block tables {tuple(block_tables.shape)}")
    k, v = k.contiguous(), v.contiguous()
    positions, valid = positions.contiguous(), valid.contiguous()
    block_tables = block_tables.contiguous()
    # the pages are written in place, so they must be the caller's storage
    ops.check_cuda(name, {"k": k, "v": v, "pool_k": pool_k, "pool_v": pool_v,
                          "k_scale": k_scale, "v_scale": v_scale,
                          "block_tables": block_tables,
                          "positions": positions, "valid": valid}, k.device)
    ops.launch("pack_kv_paged", k.data_ptr(), v.data_ptr(),
               block_tables.data_ptr(), positions.data_ptr(),
               valid.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
               k_scale.data_ptr(), v_scale.data_ptr(), B * S, S, Hkv, hd,
               block_tables.shape[1], ps, P, ops.DTYPE_CODE[k.dtype],
               device=k.device)
    pack_kv.launches += 1


def _ring_cost_of(k, v, cache_k, cache_v, k_scale, v_scale, positions, *,
                  ring_len=None, slot0=0):
    B, S, Hkv, hd = k.shape
    L = cache_k.shape[1]
    slots = positions.long() % (ring_len or L) - slot0
    written = int(((slots >= 0) & (slots < L)).sum())
    return pack_kv_write_cost(B * S * Hkv, written * Hkv, hd,
                              k.element_size(), 4 * positions.numel())


@counting.counted("pack_kv", _ring_cost_of)
def pack_kv_into_ring(k, v, cache_k, cache_v, k_scale, v_scale, positions,
                      *, ring_len=None, slot0: int = 0):
    """The int8 write of a dense (ring) cache: quantize k and v (B, S, Hkv,
    hd) row by row into cache_k, cache_v (B, L, Hkv, hd) int8 and k_scale,
    v_scale (B, L, Hkv) f32, in place, the token at position p of row b at
    slot p % L. The cache is seen as a pool of B pages of L slots with the
    block table ``arange(B)[:, None]``, so :func:`pack_kv_into_pages` does
    it in one launch. Every row is written: no two of a row's positions may
    share a slot (the caller passes at most L consecutive positions).

    A rank holding slots [slot0, slot0 + L) of a longer ring of
    ``ring_len`` (split-K's cut of the cache, ``distributed/sharding.py``)
    writes only the rows whose slot p % ring_len falls in its range: those
    rows are passed to the same launch as one-row pages of their batch
    row's page, at their local slots; no launch where the rank holds none
    of them."""
    B = positions.shape[0]
    L = cache_k.shape[1]
    if (ring_len is None or ring_len == L) and slot0 == 0:
        bt = torch.arange(B, dtype=torch.int32, device=k.device)[:, None]
        valid = torch.ones(positions.shape, dtype=torch.bool, device=k.device)
        pack_kv_into_pages(k, v, cache_k, cache_v, k_scale, v_scale, bt,
                           positions.to(torch.int32), valid)
        return
    slots = positions.long() % ring_len - slot0
    b, t = torch.nonzero((slots >= 0) & (slots < L), as_tuple=True)
    if not b.numel():
        return
    ones = torch.ones((b.numel(), 1), dtype=torch.bool, device=k.device)
    pack_kv_into_pages(k[b, t][:, None], v[b, t][:, None], cache_k, cache_v,
                       k_scale, v_scale, b.to(torch.int32)[:, None],
                       slots[b, t].to(torch.int32)[:, None], ones)


@counting.counted("unpack_kv", lambda q, s, dtype=torch.float32:
                  unpack_kv_cost(q.numel(), s.numel(), dtype.itemsize))
def unpack_kv(q, s, dtype=torch.float32):
    """(..., hd) int8 codes and (...) f32 scales -> (..., hd) in ``dtype``
    (bf16 or f32)."""
    if q.device.type == "cpu":
        return unpack_kv_plain(q, s, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unpack_kv: no kernel for device {q.device}")
    if q.dtype != torch.int8 or s.dtype != torch.float32 \
            or dtype not in ops.DTYPE_CODE:
        raise TypeError(f"unpack_kv: expected int8 codes, f32 scales and a "
                        f"bf16/f32 output, got {q.dtype}, {s.dtype}, {dtype}")
    if q.dim() == 0 or tuple(s.shape) != tuple(q.shape[:-1]):
        raise ValueError(f"unpack_kv: scales {tuple(s.shape)} do not fit "
                         f"codes {tuple(q.shape)}")
    hd = q.shape[-1]
    q, s = q.contiguous(), s.contiguous()
    ops.check_cuda("unpack_kv", {"q": q, "s": s}, q.device)
    if hd % 16 or q.data_ptr() % 16:
        raise ValueError("unpack_kv: the kernel reads 16 codes per 16-byte "
                         "load: hd must be a multiple of 16 and the codes "
                         "16-byte aligned")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    ops.launch("unpack_kv", q.data_ptr(), s.data_ptr(), out.data_ptr(),
               s.numel(), hd, ops.DTYPE_CODE[dtype], device=q.device)
    unpack_kv.launches += 1
    return out


pack_kv.launches = 0
unpack_kv.launches = 0
