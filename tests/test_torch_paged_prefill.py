"""The chunked-prefill branch of ``_paged_attention`` and the contract of
``kernels/paged_prefill.py::paged_prefill_attention`` on the CPU, where the
wrapper runs its plain twin: that twin computes, bit for bit, what the
branch computed before the kernel (the whole block table gathered, then
``flash_attention``); the wrapper refuses a logit softcap; int8 pools reach
the wrapper with their scales, whose plain twin gathers and unpacks them as
the branch did; padding lanes give zero rows; a mixed step's
decode rows still come from ``paged_decode``. The kernel itself is held to
the plain twin on the card (``tests/test_torch_cuda_kernels.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import paged_prefill as pp
from repro_torch.kernels.kv_pack import page_slots, unpack_kv
from repro_torch.kernels.paged_decode import paged_decode_plain
from repro_torch.models import transformer as ttfm
from repro_torch.models.attention import flash_attention

PS, NB = 8, 6
HEADS = [(8, 1), (10, 2), (8, 2), (4, 4)]        # G = 8, 5, 4, 1


def _cfg(Hq, Hkv, dtype):
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    return dataclasses.replace(cfg, n_heads=Hq, n_kv_heads=Hkv, dtype=dtype)


def _case(cfg, starts, lens, S, seed=0, int8=False):
    """q, k, v of a (B, S) chunk, the inputs of ``_paged_attention``, and a
    pool whose live pages already hold each lane's earlier context."""
    B = len(starts)
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    P = B * NB + 1
    pool = ttfm.init_paged_cache(cfg, P, PS, kv_dtype="int8" if int8
                                 else "auto", device="cpu")["pos0"]
    cache = {k: t[0] for k, t in pool.items()}
    for name, t in cache.items():                 # the earlier chunks
        x = torch.randn(t.shape, generator=g)
        t.copy_(x.abs() if "scale" in name else (3 * x).to(t.dtype))
    bt = torch.zeros(B, NB, dtype=torch.int32)
    free = list(np.random.default_rng(seed).permutation(np.arange(1, P)))
    for b, (s, n) in enumerate(zip(starts, lens)):
        for j in range(-(-(s + n) // PS)):
            bt[b, j] = int(free.pop())
    starts_t = torch.tensor(starts, dtype=torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    ar = torch.arange(S, dtype=torch.int32)[None]
    positions = starts_t[:, None] + ar
    paged = {"block_tables": bt, "valid": ar < lens_t[:, None],
             "chunk_starts": starts_t, "ctx_lens": starts_t + lens_t}
    q = torch.randn(B, S, Hq, hd, generator=g).to(dt)
    k = torch.randn(B, S, Hkv, hd, generator=g).to(dt)
    v = torch.randn(B, S, Hkv, hd, generator=g).to(dt)
    return q, k, v, positions, cache, paged


def _before(cfg, q, k, v, positions, cache, paged):
    """The chunked-prefill branch as it was before the kernel: the write,
    the gather of the whole block table, then ``flash_attention``."""
    pk, pv = cache["k"], cache["v"]
    B, S = positions.shape
    ps, Hkv, hd = pk.shape[1:]
    bt = paged["block_tables"].to(torch.int32)
    ctx = paged["ctx_lens"].to(torch.int32)
    page, off = page_slots(bt, positions, paged["valid"], ps)
    pk[page, off] = k.reshape(B * S, Hkv, hd).to(pk.dtype)
    pv[page, off] = v.reshape(B * S, Hkv, hd).to(pv.dtype)
    L = bt.shape[1] * ps
    btl = bt.long()
    kd = pk[btl].reshape(B, L, Hkv, hd)
    vd = pv[btl].reshape(B, L, Hkv, hd)
    kpos = torch.arange(L, dtype=torch.int32)[None]
    kpos = torch.where(kpos < ctx[:, None], kpos, torch.full_like(kpos, -1))
    return flash_attention(q, kd, vd, q_pos=positions, k_pos=kpos,
                           causal=True, window=0,
                           softcap_val=cfg.attn_logit_softcap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv", HEADS)
def test_plain_twin_is_the_branch_before_bit_for_bit(Hq, Hkv, dtype):
    """Mid-page starts, a context that is no multiple of the page size, a
    chunk ending at the block table's last slot, and a padding lane."""
    cfg = _cfg(Hq, Hkv, dtype)
    S = 16
    args = _case(cfg, starts=[0, 5, NB * PS - 9, 0], lens=[16, 11, 9, 0],
                 S=S, seed=Hq + Hkv)
    q, k, v, positions, cache, paged = args
    ref_cache = {n: t.clone() for n, t in cache.items()}
    ref = _before(cfg, q, k, v, positions, ref_cache, paged)
    before = pp.paged_prefill_attention.launches
    out, cache = ttfm._paged_attention(cfg, q, k, v, positions, cache,
                                       "paged_prefill", paged)
    assert pp.paged_prefill_attention.launches == before   # CPU: no launch
    assert out.dtype == ref.dtype and torch.equal(out, ref)
    for n in cache:       # page 0 takes the padding rows in any order
        assert torch.equal(cache[n][1:], ref_cache[n][1:])


def test_wrapper_raises_on_softcap():
    cfg = _cfg(8, 2, "float32")
    q, _, _, _, cache, paged = _case(cfg, [0], [4], S=4)
    with pytest.raises(ValueError, match="softcap"):
        pp.paged_prefill_attention(q, cache["k"], cache["v"],
                                   paged["block_tables"],
                                   paged["chunk_starts"], paged["ctx_lens"],
                                   softcap=30.0)


def test_int8_pool_takes_gather_and_unpack(monkeypatch):
    """An int8 pool reaches the wrapper with its scales (on the card the
    kernel dequantizes the live pages); on the CPU the plain twin
    dequantizes the gathered block table (two ``unpack_kv`` calls, K and V,
    each over the whole table) and runs ``flash_attention`` on it, bit for
    bit what the branch computed before the kernel, in f32 and in bf16."""
    unpacked, called = [], []

    def spy(codes, scales, dtype):
        unpacked.append(tuple(codes.shape))
        return unpack_kv(codes, scales, dtype)

    def wrapper(*a, **kw):
        called.append(kw)
        return pp.paged_prefill_attention(*a, **kw)

    monkeypatch.setattr(pp, "unpack_kv", spy)
    monkeypatch.setattr(ttfm, "paged_prefill_attention", wrapper)
    for dtype in ("float32", "bfloat16"):
        unpacked.clear()
        called.clear()
        cfg = _cfg(8, 2, dtype)
        q, k, v, positions, cache, paged = _case(cfg, [3, 0], [7, 10], S=10,
                                                 int8=True)
        assert cache["k"].dtype == torch.int8
        out, cache = ttfm._paged_attention(cfg, q, k, v, positions, cache,
                                           "paged_prefill", paged)
        B, L, hd = 2, NB * PS, cfg.head_dim
        assert len(called) == 1
        assert called[0]["k_scales"] is cache["k_scale"]
        assert called[0]["v_scales"] is cache["v_scale"]
        assert unpacked == [(B, L, 2, hd)] * 2
        # the branch before the kernel, on the pool as the call left it
        btl = paged["block_tables"].long()
        kd = unpack_kv(cache["k"][btl].reshape(B, L, 2, hd),
                       cache["k_scale"][btl].reshape(B, L, 2), q.dtype)
        vd = unpack_kv(cache["v"][btl].reshape(B, L, 2, hd),
                       cache["v_scale"][btl].reshape(B, L, 2), q.dtype)
        kpos = torch.arange(L, dtype=torch.int32)[None]
        kpos = torch.where(kpos < paged["ctx_lens"][:, None], kpos,
                           torch.full_like(kpos, -1))
        ref = flash_attention(q, kd, vd, q_pos=positions, k_pos=kpos,
                              causal=True, window=0,
                              softcap_val=cfg.attn_logit_softcap)
        assert out.dtype == ref.dtype and torch.equal(out, ref)


def test_cost_counts_int8_scales():
    """On int8 pages a live slot's K and V rows cost their codes and one f32
    scale each."""
    args = (2, 4, 8, 2, 16, 6, [0, 10], [4, 2], 2)
    f8, b8 = pp.paged_prefill_cost(*args, 1, int8=True)
    f16, b16 = pp.paged_prefill_cost(*args, 2)
    live = 4 + 12
    assert f8 == f16
    assert b16 - b8 == live * 2 * 2 * (16 * 2 - (16 + 4))


@pytest.mark.parametrize("Hq,Hkv", HEADS)
def test_padding_lanes_give_zero_rows(Hq, Hkv):
    """Padding lanes, as the engine pads a dispatch (start 0, no chunk,
    an all-garbage block table), attend to nothing."""
    cfg = _cfg(Hq, Hkv, "bfloat16")
    q, k, v, positions, cache, paged = _case(cfg, [4, 0, 0], [12, 0, 0],
                                             S=12, seed=3)
    paged["block_tables"][1:] = 0
    out, _ = ttfm._paged_attention(cfg, q, k, v, positions, cache,
                                   "paged_prefill", paged)
    assert torch.equal(out[1:], torch.zeros_like(out[1:]))
    assert out[0].abs().amax() > 0


def test_mixed_step_decode_rows_come_from_paged_decode():
    """Lanes 0 and 2 decode one token each, lane 1 prefills a chunk: the
    decode rows' outputs are ``paged_decode``'s, the chunk's rows the
    plain twin's."""
    cfg = _cfg(8, 2, "bfloat16")
    q, k, v, positions, cache, paged = _case(cfg, [20, 0, 9], [1, 8, 1],
                                             S=8, seed=5)
    paged["decode_mask"] = torch.tensor([True, False, True])
    ref_cache = {n: t.clone() for n, t in cache.items()}
    chunk = _before(cfg, q, k, v, positions, ref_cache, paged)
    dec = paged_decode_plain(q[:, 0].contiguous(), ref_cache["k"],
                             ref_cache["v"], paged["block_tables"],
                             paged["ctx_lens"])
    out, _ = ttfm._paged_attention(cfg, q, k, v, positions, cache,
                                   "paged_prefill", paged)
    assert torch.equal(out[1], chunk[1])
    for b in (0, 2):
        assert torch.equal(out[b, 0], dec[b])
        assert not torch.equal(out[b, 0], chunk[b, 0])
        assert torch.equal(out[b, 1:], chunk[b, 1:])


def test_cost_counts_live_causal_work():
    """The cost formula: causal products of the real rows only, the live
    pages' K/V once; padding lanes add nothing but their q, output and
    block table."""
    B, S, Hq, Hkv, hd, NB_ = 3, 4, 8, 2, 16, 6
    flops, nbytes = pp.paged_prefill_cost(B, S, Hq, Hkv, hd, NB_,
                                          [0, 10, 0], [4, 2, 0], 2, 2)
    keys = (1 + 2 + 3 + 4) + (11 + 12)
    assert flops == 4 * keys * Hq * hd
    assert nbytes == 2 * B * S * Hq * hd * 2 + (4 + 12) * Hkv * 2 * hd * 2 \
        + B * NB_ * 4 + 2 * B * 4
