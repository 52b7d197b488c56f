"""Each CUDA kernel against its plain PyTorch version on the card, over a
sweep of shapes and both input types. Needs an NVIDIA GPU with nvcc; on
any other host every test here skips.

    python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Tolerances: f32 within 1e-4, bf16 within 3e-2 (sums taken in another
order; on the tensor cores the decode kernels also round P to bf16), and
at a 32768-token context each decode output row within 1e-2 (bf16) or
1e-4 (f32) of its own norm; integer outputs exact; the int8 pack and
unpack bit-exact (same IEEE division, same round-half-to-even, one
rounding each). The expert GEMMs and the decode kernels also check which
route each launch took (the tensor cores for bf16 at the widths
``tc_eligible`` accepts with aligned pointers, else the CUDA cores) and,
on the tensor cores, that a row's result is bitwise the same whatever else
shares the launch."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _block_tables(cuda, B, P, ps, NB, seed):
    """Random distinct pages per request, lane 0 empty (ctx 0)."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, NB * ps + 1, B)
    ctx[0] = 0
    bt = np.zeros((B, NB), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        for j in range(-(-int(ctx[b]) // ps)):
            bt[b, j] = free.pop()
    return (torch.as_tensor(bt, device=cuda),
            torch.as_tensor(ctx, dtype=torch.int32, device=cuda))


PAGED_SHAPES = [(2, 4, 4, 32, 16, 4), (3, 8, 2, 16, 8, 5), (4, 4, 1, 64, 32, 3),
                (8, 32, 4, 128, 16, 64), (2, 16, 2, 256, 8, 6),
                (2, 32, 1, 64, 16, 4),         # G = 32: the CUDA cores
                (8, 40, 8, 128, 16, 64),       # llama4: G = 5
                (8, 32, 8, 128, 16, 64),       # qwen3-8b: G = 4
                (8, 40, 40, 128, 16, 64)]      # qwen1.5-32b: G = 1


def _decode_tc(dtype, hd, G):
    """The decode route a launch on fresh (aligned) tensors must take."""
    return dtype == torch.bfloat16 and hd % 16 == 0 and hd <= 128 and G <= 16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,hd,ps,NB", PAGED_SHAPES)
def test_paged_decode_kernel(cuda, dtype, B, Hq, Hkv, hd, ps, NB):
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    g = torch.Generator(device=cuda).manual_seed(0)
    P = B * NB + 1
    q = torch.randn(B, Hq, hd, generator=g, device=cuda).to(dtype)
    kp = torch.randn(P, ps, Hkv, hd, generator=g, device=cuda).to(dtype)
    vp = torch.randn(P, ps, Hkv, hd, generator=g, device=cuda).to(dtype)
    bt, ctx = _block_tables(cuda, B, P, ps, NB, seed=B * hd)
    before = (paged_decode.launches, paged_decode.tc_launches)
    out = paged_decode(q, kp, vp, bt, ctx)
    assert (paged_decode.launches, paged_decode.tc_launches) == (
        before[0] + 1, before[1] + _decode_tc(dtype, hd, Hq // Hkv))
    ref = paged_decode_plain(q, kp, vp, bt, ctx)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,hd,ps,NB", PAGED_SHAPES)
def test_paged_decode_int8_kernel(cuda, dtype, B, Hq, Hkv, hd, ps, NB):
    from repro_torch.kernels.kv_pack import pack_kv_plain
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    g = torch.Generator(device=cuda).manual_seed(4)
    P = B * NB + 1
    q = torch.randn(B, Hq, hd, generator=g, device=cuda).to(dtype)
    kp, ks = pack_kv_plain(3 * torch.randn(P, ps, Hkv, hd, generator=g,
                                           device=cuda))
    vp, vs = pack_kv_plain(3 * torch.randn(P, ps, Hkv, hd, generator=g,
                                           device=cuda))
    bt, ctx = _block_tables(cuda, B, P, ps, NB, seed=B * hd + 1)
    before = (paged_decode.launches, paged_decode.tc_launches)
    out = paged_decode(q, kp, vp, bt, ctx, k_scales=ks, v_scales=vs)
    assert (paged_decode.launches, paged_decode.tc_launches) == (
        before[0] + 1, before[1] + _decode_tc(dtype, hd, Hq // Hkv))
    ref = paged_decode_plain(q, kp, vp, bt, ctx, ks, vs)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 1, 4, 128), (512, 4, 128),
                                   (3, 5, 2, 32), (7, 48), (2, 4)])
def test_pack_kv_kernel(cuda, dtype, shape):
    from repro_torch.kernels.kv_pack import pack_kv, pack_kv_plain
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(shape, generator=g, device=cuda)
    x = x * torch.rand(shape[:-1] + (1,), generator=g, device=cuda) * 8
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0                                     # a zero row
    rows[-1, :4] = torch.tensor([127.0, 2.5, 3.5, -0.5])   # exact ties
    rows[-1, 4:] = 0.0
    x = x.to(dtype)
    before = pack_kv.launches
    q, s = pack_kv(x)
    assert pack_kv.launches == before + 1
    rq, rs = pack_kv_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert q.reshape(-1, shape[-1])[-1, :4].tolist() == [127, 2, 4, 0]
    assert not q.reshape(-1, shape[-1])[0].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("B,S,Hkv", [(1, 1, 1), (8, 1, 4), (2, 4, 3),
                                     (1, 512, 8), (4, 512, 2)])
def test_pack_kv_into_pages_kernel(cuda, dtype, hd, B, S, Hkv):
    """One launch writes K and V of a (B, S) chunk into int8 pages,
    bit-identical to the plain twin on every page but page 0 (invalid rows
    race there). Lanes start mid-page, so chunks cross pages; the last lane
    runs past its table into the clamped last block (of the rows that land
    on one slot, the last stays valid); a third of the first lane's rows
    are invalid."""
    from repro_torch.kernels.kv_pack import (pack_kv, pack_kv_into_pages,
                                             pack_kv_into_pages_plain,
                                             page_slots)
    g = torch.Generator(device=cuda).manual_seed(hd + Hkv)
    ps = 16
    NB = -(-(S + ps) // ps)
    P = B * NB + 1
    bt = (torch.randperm(P - 1, generator=g, device=cuda)[:B * NB] + 1) \
        .reshape(B, NB).to(torch.int32)
    starts = torch.arange(B, device=cuda) * 5 % ps
    starts[-1] = NB * ps - S // 2                     # past the table
    positions = (starts[:, None] + torch.arange(S, device=cuda)) \
        .to(torch.int32)
    valid = torch.ones(B, S, dtype=torch.bool, device=cuda)
    if B > 1:
        valid[0, ::3] = False                         # idle rows
    page, off = page_slots(bt, positions, valid, ps)
    keep, seen = valid.reshape(-1).tolist(), set()
    for i in reversed(range(B * S)):                  # one writer a slot
        slot = (int(page[i]), int(off[i]))
        if keep[i]:
            keep[i] = slot not in seen
            seen.add(slot)
    valid = torch.tensor(keep, device=cuda).reshape(B, S)
    k, v = (torch.randn(B, S, Hkv, hd, generator=g, device=cuda).mul(
        torch.rand(B, S, Hkv, 1, generator=g, device=cuda) * 8).to(dtype)
        for _ in range(2))
    k[-1, 0, 0] = 0.0                                 # a zero row
    k[-1, -1, -1, :4] = torch.tensor([127.0, 2.5, 3.5, -0.5])   # exact ties
    k[-1, -1, -1, 4:] = 0.0
    pools = [torch.randint(-127, 128, (P, ps, Hkv, hd), generator=g,
                           device=cuda, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(P, ps, Hkv, generator=g, device=cuda)
              for _ in range(2)]
    mine = [t.clone() for t in pools + scales]
    plain = [t.clone() for t in pools + scales]
    before = pack_kv.launches
    pack_kv_into_pages(k, v, *mine, bt, positions, valid)
    assert pack_kv.launches == before + 1
    pack_kv_into_pages_plain(k, v, *plain, bt, positions, valid)
    torch.cuda.synchronize()
    for a, b in zip(mine, plain):
        assert torch.equal(a[1:], b[1:])
    tie = mine[0][bt[-1, -1].long(), int(positions[-1, -1]) % ps, -1, :4]
    assert tie.tolist() == [127, 2, 4, 0]             # clamped to block NB-1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 1024, 4, 128), (3, 16), (5, 2, 48)])
def test_unpack_kv_kernel(cuda, dtype, shape):
    from repro_torch.kernels.kv_pack import unpack_kv, unpack_kv_plain
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randint(-127, 128, shape, generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand(shape[:-1], generator=g, device=cuda) * 0.1
    before = unpack_kv.launches
    out = unpack_kv(q, s, dtype)
    assert unpack_kv.launches == before + 1
    ref = unpack_kv_plain(q, s, dtype)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.equal(out, ref)


def _tc_route(dtype, D, F):
    """The GMM route a launch on fresh (aligned) tensors must take."""
    return dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,K,E,D,F", [
    (8, 8, 128, 2048, 768), (8, 8, 128, 768, 2048),     # serving decode
    (256, 8, 128, 2048, 768), (256, 8, 128, 768, 2048),  # serving prefill
    (8, 8, 128, 256, 96), (64, 2, 8, 64, 40), (700, 8, 16, 128, 200),
    (3, 1, 4, 72, 130),                     # F % 8 != 0: the CUDA cores
    (8, 1, 128, 5120, 8192), (8, 1, 128, 8192, 5120),     # llama4 decode
    (512, 1, 128, 5120, 8192), (512, 1, 128, 8192, 5120)])  # and prefill
def test_moe_gmm_ragged_kernel(cuda, dtype, T, K, E, D, F):
    from repro_torch.kernels.moe_dispatch import (pick_row_block,
                                                  ragged_dispatch)
    from repro_torch.kernels.moe_gmm import (moe_gmm_ragged,
                                             moe_gmm_ragged_plain)
    g = torch.Generator(device=cuda).manual_seed(1)
    ids = torch.topk(torch.randn(T, E, generator=g, device=cuda), K,
                     dim=-1).indices
    x = torch.randn(T, D, generator=g, device=cuda).to(dtype)
    w = (torch.randn(E, D, F, generator=g, device=cuda) / D ** 0.5).to(dtype)
    d = ragged_dispatch(x, ids, E, row_block=pick_row_block(T * K, E))
    # garbage in the padding rows must not leak into the output
    xs = d.xs.clone()
    pad = torch.ones(xs.shape[0], dtype=torch.bool, device=cuda)
    pad[d.dest.long()] = False
    xs[pad] = 7.0
    args = (xs, w, d.tile_expert, d.group_sizes, d.padded_offsets)
    before = (moe_gmm_ragged.launches, moe_gmm_ragged.tc_launches)
    out = moe_gmm_ragged(*args, n_block=d.row_block)
    assert (moe_gmm_ragged.launches, moe_gmm_ragged.tc_launches) == (
        before[0] + 1, before[1] + _tc_route(dtype, D, F))
    ref = moe_gmm_ragged_plain(*args, n_block=d.row_block)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert torch.equal(out[pad], torch.zeros_like(out[pad]))
    torch.testing.assert_close(out, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,K,E,D,F", [
    (2048, 8, 128, 2048, 768), (2048, 8, 128, 768, 2048),   # training
    # a rank's EP shard under expert_data_shard: half the experts (as many
    # slots each), F cut in two
    (2048, 4, 64, 2048, 384), (2048, 4, 64, 384, 2048),
    (64, 2, 8, 64, 40), (700, 8, 16, 128, 200),
    (3, 1, 4, 72, 130)])                    # F % 8 != 0: the CUDA cores
def test_ragged_gmm_backward_kernel(cuda, dtype, T, K, E, D, F):
    """``ragged_gmm``'s forward and dx launch the kernel (dx against wᵀ,
    dy rounded to the weights' type), held to the plain twin's f32
    formulation; dw is the same PyTorch ops in both, so the same bits."""
    from repro_torch.kernels.moe_dispatch import (pick_row_block,
                                                  ragged_dispatch, ragged_gmm,
                                                  ragged_gmm_plain)
    from repro_torch.kernels.moe_gmm import moe_gmm_ragged
    g = torch.Generator(device=cuda).manual_seed(9)
    ids = torch.topk(torch.randn(T, E, generator=g, device=cuda), K,
                     dim=-1).indices
    x = torch.randn(T, D, generator=g, device=cuda).to(dtype)
    w = (torch.randn(E, D, F, generator=g, device=cuda) / D ** 0.5).to(dtype)
    d = ragged_dispatch(x, ids, E, row_block=pick_row_block(T * K, E))
    dy = torch.randn(d.xs.shape[0], F, generator=g, device=cuda)
    meta = (d.tile_expert, d.group_sizes, d.padded_offsets, d.row_block)
    grads = []
    for fn in (ragged_gmm, ragged_gmm_plain):
        xs = d.xs.clone().requires_grad_()
        wr = w.clone().requires_grad_()
        before = (moe_gmm_ragged.launches, moe_gmm_ragged.tc_launches)
        out = fn(xs, wr, *meta)
        grads.append((out.detach(),) + torch.autograd.grad(out, (xs, wr), dy))
        n = (moe_gmm_ragged.launches - before[0],
             moe_gmm_ragged.tc_launches - before[1])
        assert n == ((2, _tc_route(dtype, D, F) + _tc_route(dtype, F, D))
                     if fn is ragged_gmm else (0, 0))
    torch.cuda.synchronize()
    (y, dx, dw), (y_ref, dx_ref, dw_ref) = grads
    assert dx.dtype == dw.dtype == dtype
    torch.testing.assert_close(y, y_ref, rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(dx.float(), dx_ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert torch.equal(dw, dw_ref)


def test_ragged_dw_same_bits_over_two_launches(cuda):
    """The ragged path's weight gradient at the training shape takes no
    atomics: two calls give the same bits, within f32 rounding of one
    product per expert."""
    from repro_torch.kernels.moe_dispatch import (pick_row_block,
                                                  ragged_dispatch, ragged_dw)
    T, K, E, D, F = 2048, 8, 128, 2048, 768
    g = torch.Generator(device=cuda).manual_seed(10)
    ids = torch.topk(torch.randn(T, E, generator=g, device=cuda), K,
                     dim=-1).indices
    x = torch.randn(T, D, generator=g, device=cuda).to(torch.bfloat16)
    d = ragged_dispatch(x, ids, E, row_block=pick_row_block(T * K, E))
    dy = torch.randn(d.xs.shape[0], F, generator=g, device=cuda)
    args = (d.xs, dy, d.tile_expert, d.padded_offsets, E)
    a = ragged_dw(*args, row_block=d.row_block)
    b = ragged_dw(*args, row_block=d.row_block)
    assert torch.equal(a, b)
    po = d.padded_offsets.tolist()
    ref = torch.stack([d.xs[po[e]:po[e + 1]].float().T
                       @ dy[po[e]:po[e + 1]] for e in range(E)])
    torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-3)


FLASH_SHAPES = [(4, 4, 4, 64, 512), (4, 8, 2, 128, 300),
                (8, 32, 4, 128, 1024), (4, 16, 2, 256, 129), (4, 8, 8, 32, 5),
                (4, 32, 1, 64, 100),           # G = 32: the CUDA cores
                (8, 40, 8, 128, 1024),         # llama4: G = 5
                (8, 16, 8, 256, 1024)]         # gemma3: hd 256, G = 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,hd,L", FLASH_SHAPES)
def test_flash_decode_kernel(cuda, dtype, B, Hq, Hkv, hd, L):
    """Rows: a ring that wrapped, a prefix cache, masked slots past q_pos,
    and a row with no valid slot, which must be exact zeros."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.models.attention import ring_positions
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(B, Hq, hd, generator=g, device=cuda).to(dtype)
    kc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda).to(dtype)
    vc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda).to(dtype)
    write = torch.tensor([3 * L + 2, L // 2, L - 1, 0], device=cuda)
    write = write.repeat(B // 4)
    k_pos = ring_positions(write, L)
    q_pos = write.to(torch.int32).clone()
    q_pos[1] -= min(2, L // 2)            # slots past q_pos are masked
    k_pos[3] = -1                         # no valid slot at all
    before = (flash_decode.launches, flash_decode.tc_launches)
    out = flash_decode(q, kc, vc, k_pos, q_pos)
    assert (flash_decode.launches, flash_decode.tc_launches) == (
        before[0] + 1, before[1] + _decode_tc(dtype, hd, Hq // Hkv))
    ref = flash_decode_plain(q, kc, vc, k_pos, q_pos)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert torch.equal(out[3], torch.zeros_like(out[3]))
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


# (B, Hq, Hkv, hd, L, window, softcap, int8 cache)
FLASH_TERMS = [(4, 8, 4, 256, 600, 200, 50.0, False),   # gemma2's terms
               (4, 16, 8, 256, 1100, 1024, 0.0, False),  # gemma3's window
               (4, 8, 2, 128, 600, 200, 30.0, False),
               (4, 8, 8, 128, 300, 0, 0.0, True),        # int8, G = 1
               (4, 16, 4, 128, 300, 0, 0.0, True),       # int8, G = 4
               (4, 8, 4, 256, 300, 100, 50.0, True),     # all three
               (4, 25, 5, 64, 2500, 1024, 0.0, False),   # hymba: G = 5
               (4, 25, 5, 64, 1024, 0, 0.0, False),
               (4, 56, 8, 128, 600, 0, 0.0, False),      # llava: G = 7
               (4, 56, 8, 128, 600, 0, 0.0, True)]


@pytest.mark.parametrize("route", ["float32", "bfloat16", "bfloat16 q off"])
@pytest.mark.parametrize("B,Hq,Hkv,hd,L,window,cap,int8", FLASH_TERMS)
def test_flash_decode_window_softcap_int8(cuda, route, B, Hq, Hkv, hd, L,
                                          window, cap, int8):
    """The sliding window, the logit softcap and int8 caches with their
    scales, on both routes: f32 (the CUDA cores), bf16 (the tensor cores up
    to hd 128, the CUDA cores at hd 256) and bf16 with q 2 bytes off a
    16-byte boundary (the CUDA cores). Rows as in
    ``test_flash_decode_kernel``; the window masks most of the wrapped
    ring. f32 without int8 within 1e-4, the rest within the bf16 bar."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.kv_pack import pack_kv_plain
    from repro_torch.models.attention import ring_positions
    dtype = torch.float32 if route == "float32" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(hd + L)
    buf = torch.randn(B * Hq * hd + 1, generator=g, device=cuda).to(dtype)
    q = (buf[1:] if route.endswith("off") else buf[:-1]).view(B, Hq, hd)
    kc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda) * 4
    vc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda)
    scales = {}
    if int8:
        kc, ks = pack_kv_plain(kc)
        vc, vs = pack_kv_plain(vc)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
    write = torch.tensor([3 * L + 2, L // 2, L - 1, 0], device=cuda)
    k_pos = ring_positions(write, L)
    q_pos = write.to(torch.int32).clone()
    q_pos[1] -= 2                         # slots past q_pos are masked
    k_pos[3] = -1                         # no valid slot at all
    terms = dict(window=window, softcap=cap, **scales)
    before = (flash_decode.launches, flash_decode.tc_launches)
    out = flash_decode(q, kc, vc, k_pos, q_pos, **terms)
    tc = route == "bfloat16" and _decode_tc(dtype, hd, Hq // Hkv)
    assert (flash_decode.launches, flash_decode.tc_launches) == (
        before[0] + 1, before[1] + tc)
    ref = flash_decode_plain(q, kc, vc, k_pos, q_pos, **terms)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert torch.equal(out[3], torch.zeros_like(out[3]))
    tol = TOL[torch.bfloat16 if int8 else dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if window:                  # the window masks: without it rows move
        wide = flash_decode_plain(q, kc, vc, k_pos, q_pos, softcap=cap,
                                  **scales)
        assert float((wide[0].float() - ref[0].float()).abs().max()) > 0.05


# (B, Hq, Hkv, hd, L, window, softcap, int8 cache)
SPLIT_TERMS = [(4, 32, 4, 128, 1024, 0, 0.0, False),    # qwen3-moe's heads
               (4, 8, 4, 256, 1024, 200, 50.0, False),  # gemma2's terms
               (4, 8, 2, 128, 512, 200, 30.0, False),
               (4, 16, 4, 128, 512, 0, 0.0, True)]      # int8


@pytest.mark.parametrize("n_split", [2, 4])
@pytest.mark.parametrize("route", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,hd,L,window,cap,int8", SPLIT_TERMS)
def test_flash_decode_split_k_partials(cuda, route, B, Hq, Hkv, hd, L,
                                       window, cap, int8, n_split):
    """Split-K shards: each call on a slice ``cache[:, l0:l1]`` of the ring
    (read in place) returns its f32 output and log-sum-exp, held to
    ``flash_decode_plain(return_lse=True)`` on the same slice; row 3 has no
    valid slot in any shard and row 1 none in the last (lse -inf, output
    exact zeros). The shards recombined (``combine_partials``) give the
    unsplit call's output within the bar of its type (int8: bf16's)."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.kv_pack import pack_kv_plain
    from repro_torch.models.attention import ring_positions
    from repro_torch.models.transformer import combine_partials
    dtype = torch.float32 if route == "float32" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(hd + L + n_split)
    q = torch.randn(B, Hq, hd, generator=g, device=cuda).to(dtype)
    kc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda) * 4
    vc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda)
    ks = vs = None
    if int8:
        kc, ks = pack_kv_plain(kc)
        vc, vs = pack_kv_plain(vc)
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
    write = torch.tensor([3 * L + 2, L // 2 - 1, L - 1, 0], device=cuda)
    k_pos = ring_positions(write, L)
    q_pos = write.to(torch.int32).clone()
    k_pos[3] = -1                         # no valid slot at all
    terms = dict(window=window, softcap=cap)
    Ls = L // n_split
    outs, lses = [], []
    for i in range(n_split):
        sl = slice(i * Ls, (i + 1) * Ls)
        sc = {} if ks is None else dict(k_scale=ks[:, sl], v_scale=vs[:, sl])
        kp = k_pos[:, sl].contiguous()
        before = (flash_decode.launches, flash_decode.tc_launches)
        o, lse = flash_decode(q, kc[:, sl], vc[:, sl], kp, q_pos,
                              return_lse=True, **terms, **sc)
        assert (flash_decode.launches, flash_decode.tc_launches) == (
            before[0] + 1, before[1] + _decode_tc(dtype, hd, Hq // Hkv))
        ro, rl = flash_decode_plain(q, kc[:, sl].contiguous(),
                                    vc[:, sl].contiguous(), kp, q_pos,
                                    return_lse=True, **terms,
                                    **{k: v.contiguous() for k, v in
                                       sc.items()})
        torch.cuda.synchronize()
        assert o.dtype == torch.float32 and lse.dtype == torch.float32
        assert torch.isneginf(lse[3]).all() and torch.equal(
            o[3], torch.zeros_like(o[3]))
        assert torch.equal(torch.isneginf(lse), torch.isneginf(rl))
        tol = TOL[torch.bfloat16 if int8 else dtype]
        torch.testing.assert_close(o, ro, rtol=tol, atol=tol)
        fin = ~torch.isneginf(rl)
        torch.testing.assert_close(lse[fin], rl[fin], rtol=tol, atol=tol)
        outs.append(o)
        lses.append(lse)
    assert torch.isneginf(lses[-1][1]).all()   # row 1 ends before L // 2
    whole = flash_decode(q, kc, vc, k_pos, q_pos, k_scale=ks, v_scale=vs,
                         **terms)
    got = combine_partials(torch.stack(outs), torch.stack(lses))
    tol = TOL[torch.bfloat16 if int8 else dtype]
    torch.testing.assert_close(got.to(dtype).float(), whole.float(),
                               rtol=tol, atol=tol)


def _paged_inputs(cuda, B, ctx, NB, int8_pages, seed, dtype=torch.bfloat16,
                  Hq=32, Hkv=4, hd=128, ps=16):
    """q in ``dtype`` and a pool with a distinct page for every block of
    every request, in ``dtype`` or int8 with scales."""
    from repro_torch.kernels.kv_pack import pack_kv_plain
    g = torch.Generator(device=cuda).manual_seed(seed)
    P = B * NB + 1
    q = torch.randn(B, Hq, hd, generator=g, device=cuda).to(dtype)
    kp = torch.randn(P, ps, Hkv, hd, generator=g, device=cuda)
    vp = torch.randn(P, ps, Hkv, hd, generator=g, device=cuda)
    scales = {}
    if int8_pages:
        kp, ks = pack_kv_plain(kp)
        vp, vs = pack_kv_plain(vp)
        scales = dict(k_scales=ks, v_scales=vs)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    perm = torch.randperm(P - 1, generator=g, device=cuda) + 1
    bt = perm.reshape(B, NB).to(torch.int32)
    bt[torch.arange(NB, device=cuda)[None] * ps >= torch.as_tensor(
        ctx, device=cuda)[:, None]] = 0          # unused entries: page 0
    return q, kp, vp, bt, torch.as_tensor(ctx, dtype=torch.int32,
                                          device=cuda), scales


@pytest.mark.parametrize("int8_pages", [False, True])
@pytest.mark.parametrize("row", [0, 3, 7])
def test_paged_decode_batch_invariant(cuda, int8_pages, row):
    """bf16 on the tensor cores: a request's output row is bitwise the same
    in a batch of 8, alone (B = 1), and alone with a block table twice as
    wide."""
    from repro_torch.kernels.paged_decode import paged_decode
    ctx = [1, 17, 300, 1024, 0, 511, 700, 129]
    NB, ps = 64, 16
    q, kp, vp, bt, ctx_t, scales = _paged_inputs(cuda, 8, ctx, NB,
                                                 int8_pages, seed=12)
    before = paged_decode.tc_launches
    full = paged_decode(q, kp, vp, bt, ctx_t, **scales)
    alone = paged_decode(q[row:row + 1].contiguous(), kp, vp,
                         bt[row:row + 1].contiguous(),
                         ctx_t[row:row + 1].contiguous(), **scales)
    wide_bt = torch.zeros(1, 2 * NB, dtype=torch.int32, device=cuda)
    wide_bt[:, :NB] = bt[row]
    wide = paged_decode(q[row:row + 1].contiguous(), kp, vp, wide_bt,
                        ctx_t[row:row + 1].contiguous(), **scales)
    assert paged_decode.tc_launches == before + 3
    assert torch.equal(alone[0], full[row])
    assert torch.equal(wide[0], full[row])


@pytest.mark.parametrize("row", [0, 1, 2, 5])
def test_flash_decode_batch_invariant(cuda, row):
    """bf16 on the tensor cores: a ring row's output is bitwise the same in
    a batch of 8, alone (B = 1), and alone in a cache 384 slots longer whose
    extra slots were never written."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.attention import ring_positions
    g = torch.Generator(device=cuda).manual_seed(13)
    B, Hq, Hkv, hd, L = 8, 32, 4, 128, 1024
    q = torch.randn(B, Hq, hd, generator=g, device=cuda).bfloat16()
    kc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda).bfloat16()
    vc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda).bfloat16()
    write = torch.tensor([99, 1500, 255, 600, 931, 1023, 0, 400],
                         device=cuda)
    k_pos = ring_positions(write, L)
    q_pos = write.to(torch.int32)
    before = flash_decode.tc_launches
    full = flash_decode(q, kc, vc, k_pos, q_pos)
    one = slice(row, row + 1)
    alone = flash_decode(q[one].contiguous(), kc[one].contiguous(),
                         vc[one].contiguous(), k_pos[one].contiguous(),
                         q_pos[one].contiguous())
    pad = 384
    kw = torch.zeros(1, L + pad, Hkv, hd, dtype=kc.dtype, device=cuda)
    vw = torch.zeros_like(kw)
    kw[:, :L], vw[:, :L] = kc[one], vc[one]
    pw = torch.full((1, L + pad), -1, dtype=torch.int32, device=cuda)
    pw[:, :L] = k_pos[one]
    wide = flash_decode(q[one].contiguous(), kw, vw, pw,
                        q_pos[one].contiguous())
    assert flash_decode.tc_launches == before + 3
    assert torch.equal(alone[0], full[row])
    assert torch.equal(wide[0], full[row])


def test_decode_unaligned_q_takes_cuda_cores(cuda):
    """bf16 at the serving widths, but q 2 bytes off a 16-byte boundary: the
    tensor-core route cannot take it, the CUDA cores do, and agree."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    g = torch.Generator(device=cuda).manual_seed(14)
    B, Hq, Hkv, hd, L = 2, 32, 4, 128, 64
    buf = torch.randn(B * Hq * hd + 1, generator=g, device=cuda).bfloat16()
    q = buf[1:].view(B, Hq, hd)
    assert q.is_contiguous() and q.data_ptr() % 16
    kc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda).bfloat16()
    vc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda).bfloat16()
    k_pos = torch.arange(L, dtype=torch.int32, device=cuda).repeat(B, 1)
    q_pos = torch.tensor([40, 63], dtype=torch.int32, device=cuda)
    kp, vp = (t.reshape(B * L // 16, 16, Hkv, hd) for t in (kc, vc))
    bt = torch.arange(B * L // 16, dtype=torch.int32,
                      device=cuda).reshape(B, L // 16)
    before = (flash_decode.launches, flash_decode.tc_launches,
              paged_decode.launches, paged_decode.tc_launches)
    out_f = flash_decode(q, kc, vc, k_pos, q_pos)
    out_p = paged_decode(q, kp, vp, bt, q_pos + 1)
    assert (flash_decode.launches, flash_decode.tc_launches,
            paged_decode.launches, paged_decode.tc_launches) == (
        before[0] + 1, before[1], before[2] + 1, before[3])
    torch.testing.assert_close(
        out_f.float(), flash_decode_plain(q, kc, vc, k_pos, q_pos).float(),
        rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(
        out_p.float(), paged_decode_plain(q, kp, vp, bt, q_pos + 1).float(),
        rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["paged", "paged_int8", "flash"])
def test_decode_long_context(cuda, dtype, kernel):
    """A 32768-token context at the serving widths (256 slices of the
    context per KV head), both routes: against the plain version, each
    request's output also relative to its own norm (``row_rel_err``)."""
    from repro_torch.kernels.decode_route import ROW_TOL, row_rel_err
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    from repro_torch.models.attention import ring_positions
    if kernel == "flash":
        g = torch.Generator(device=cuda).manual_seed(15)
        B, Hq, Hkv, hd, L = 2, 32, 4, 128, 32768
        q = torch.randn(B, Hq, hd, generator=g, device=cuda).to(dtype)
        kc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda).to(dtype)
        vc = torch.randn(B, L, Hkv, hd, generator=g, device=cuda).to(dtype)
        write = torch.tensor([40000, 20000], device=cuda)
        k_pos, q_pos = ring_positions(write, L), write.to(torch.int32)
        before = flash_decode.tc_launches
        out = flash_decode(q, kc, vc, k_pos, q_pos)
        ref = flash_decode_plain(q, kc, vc, k_pos, q_pos)
        tc = flash_decode.tc_launches - before
    else:
        q, kp, vp, bt, ctx, scales = _paged_inputs(
            cuda, 2, [32768, 20001], 2048, kernel == "paged_int8", seed=16,
            dtype=dtype)
        before = paged_decode.tc_launches
        out = paged_decode(q, kp, vp, bt, ctx, **scales)
        ref = paged_decode_plain(q, kp, vp, bt, ctx, *scales.values())
        tc = paged_decode.tc_launches - before
    torch.cuda.synchronize()
    assert tc == (dtype == torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    # the outputs are about 0.01 here, so the absolute bar above cannot see
    # a dropped slice; each request's error against its own norm can
    assert row_rel_err(out, ref) <= ROW_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,C,D,F", [
    (128, 4, 2048, 768),       # the decode regroup's capacity
    (128, 4, 768, 2048),
    (128, 71, 2048, 768),      # a 900-token prefill's capacity (C=71)
    (128, 71, 768, 2048),
    (16, 71, 256, 96),         # C=71 at a small width
    (4, 200, 256, 136),        # C > 128: two row tiles of one panel
    (5, 13, 37, 131), (3, 33, 70, 9), (2, 1, 8, 1),    # odd C, D and F
    (128, 4, 5120, 8192), (128, 4, 8192, 5120),  # llama4: decode regroup
    (128, 5, 5120, 8192), (128, 5, 8192, 5120)])  # a 512-token prefill
def test_moe_gmm_kernel(cuda, dtype, E, C, D, F):
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(E, C, D, generator=g, device=cuda).to(dtype)
    w = (torch.randn(E, D, F, generator=g, device=cuda) / D ** 0.5).to(dtype)
    before = (moe_gmm.launches, moe_gmm.tc_launches)
    out = moe_gmm(x, w)
    assert (moe_gmm.launches, moe_gmm.tc_launches) == (
        before[0] + 1, before[1] + _tc_route(dtype, D, F))
    ref = moe_gmm_plain(x, w)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (E, C, F)
    torch.testing.assert_close(out, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,C,D,F", [
    (128, 160, 2048, 768), (128, 160, 768, 2048),   # training: 4 rows of 40
    (64, 160, 2048, 384), (64, 160, 384, 2048),     # a rank's EP shard
    (16, 71, 256, 96), (5, 13, 37, 131)])           # odd C, D and F
def test_moe_gmm_backward_kernel(cuda, dtype, E, C, D, F):
    """``moe_gmm``'s forward, dx (dy @ wᵀ) and dw (xᵀ @ dy) are three
    launches of the kernel, held to autograd through the plain version."""
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(E, C, D, generator=g, device=cuda).to(dtype)
    w = (torch.randn(E, D, F, generator=g, device=cuda) / D ** 0.5).to(dtype)
    # the padded path's dy holds values of the activation type
    dy = torch.randn(E, C, F, generator=g, device=cuda).to(dtype).float()
    out = []
    for fn in (moe_gmm, moe_gmm_plain):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = (moe_gmm.launches, moe_gmm.tc_launches)
        y = fn(xr, wr)
        out.append(torch.autograd.grad(y, (xr, wr), dy))
        n = (moe_gmm.launches - before[0], moe_gmm.tc_launches - before[1])
        assert n == ((3, _tc_route(dtype, D, F) + _tc_route(dtype, F, D)
                      + _tc_route(dtype, C, F))
                     if fn is moe_gmm else (0, 0))
    torch.cuda.synchronize()
    (dx, dw), (dx_ref, dw_ref) = out
    assert dx.dtype == dw.dtype == dtype
    torch.testing.assert_close(dx.float(), dx_ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(dw.float(), dw_ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_moe_gmm_unaligned_takes_cuda_cores(cuda):
    """bf16 at a serving width, but x 2 bytes off a 16-byte boundary: the
    tensor-core route's 16-byte copies cannot take it, the CUDA cores do."""
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
    g = torch.Generator(device=cuda).manual_seed(9)
    E, C, D, F = 4, 5, 256, 128
    buf = torch.randn(E * C * D + 1, generator=g, device=cuda).bfloat16()
    x = buf[1:].view(E, C, D)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = (torch.randn(E, D, F, generator=g, device=cuda) / D ** 0.5).bfloat16()
    before = (moe_gmm.launches, moe_gmm.tc_launches)
    out = moe_gmm(x, w)
    assert (moe_gmm.launches, moe_gmm.tc_launches) == (before[0] + 1,
                                                       before[1])
    torch.testing.assert_close(out, moe_gmm_plain(x, w), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("C", [1, 4, 20, 40, 71, 100, 200])
def test_moe_gmm_batch_invariant(cuda, C):
    """bf16 on the tensor cores: the first rows of an expert's buffer give
    bitwise the same outputs whatever the capacity C (so whatever row tile
    the launch picks) and whatever fills the other rows."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    g = torch.Generator(device=cuda).manual_seed(10)
    E, D, F = 2, 2048, 768
    x = torch.randn(E, 200, D, generator=g, device=cuda).bfloat16()
    w = (torch.randn(E, D, F, generator=g, device=cuda) / D ** 0.5).bfloat16()
    full = moe_gmm(x, w)
    before = moe_gmm.tc_launches
    part = moe_gmm(x[:, :C].contiguous(), w)
    assert moe_gmm.tc_launches == before + 1
    assert torch.equal(part, full[:, :C])


@pytest.mark.parametrize("T,group", [(16, 8), (100, 40), (400, 300),
                                     (400, 1)])
def test_moe_gmm_ragged_batch_invariant(cuda, T, group):
    """bf16 on the tensor cores: token 0's output row is bitwise the same
    when it is dispatched alone and when T tokens are, `group` of them
    (token 0 first) on its expert: whatever row tile, rows per leader
    block and neighbours the launch gives it."""
    from repro_torch.kernels.moe_dispatch import (pick_row_block,
                                                  ragged_dispatch)
    from repro_torch.kernels.moe_gmm import moe_gmm_ragged
    g = torch.Generator(device=cuda).manual_seed(11)
    E, D, F = 8, 2048, 768
    x = torch.randn(T, D, generator=g, device=cuda).bfloat16()
    w = (torch.randn(E, D, F, generator=g, device=cuda) / D ** 0.5).bfloat16()

    def row0(n_tokens, n_same):
        ids = torch.arange(n_tokens, device=cuda) % E
        ids[ids == 3] = 4
        ids[:n_same] = 3
        d = ragged_dispatch(x[:n_tokens], ids[:, None], E,
                            row_block=pick_row_block(n_tokens, E))
        before = moe_gmm_ragged.tc_launches
        out = moe_gmm_ragged(d.xs, w, d.tile_expert, d.group_sizes,
                             d.padded_offsets, n_block=d.row_block)
        assert moe_gmm_ragged.tc_launches == before + 1
        return out[d.dest[0].long()]

    assert torch.equal(row0(T, group), row0(1, 1))


def _stats_case(cuda, T, K, E, S, skew, seed=2):
    g = torch.Generator(device=cuda).manual_seed(seed)
    ids = torch.randint(-1, E + 1, (T, K), generator=g, device=cuda,
                        dtype=torch.int32)             # -1 and E count nowhere
    if skew == "one_expert":
        ids.fill_(E // 2)
    elif skew == "hot":                                 # 3 of 4 on expert 0
        hot = torch.rand(T, K, generator=g, device=cuda) < 0.75
        ids = torch.where(hot, torch.zeros_like(ids), ids)
    src = torch.randint(-1, S + 1, (T,), generator=g, device=cuda,
                        dtype=torch.int32)
    return ids, src


def _slots(where):
    """(T, K) just under, at, or just over the single-block limit."""
    from repro_torch.kernels.source_expert_count import SINGLE_BLOCK_SLOTS
    n = SINGLE_BLOCK_SLOTS + {"under": -8, "at": 0, "over": 8}[where]
    return n // 8, 8


@pytest.mark.parametrize("T,K,E,S,skew", [
    (1, 1, 8, 2, None), (8, 8, 128, 2, None), (2048, 1, 128, 2, None),
    (300, 8, 128, 4, "hot"), (5000, 2, 64, 8, None), (64, 8, 128, 1, "hot"),
    (2048, 1, 128, 2, "one_expert"), (0, 8, 128, 2, None),
    ("under", None, 128, 8, "hot"), ("at", None, 128, 2, None),
    ("over", None, 128, 8, "hot"), ("over", None, 128, 2, "one_expert")])
def test_source_expert_count_kernel(cuda, T, K, E, S, skew):
    from repro_torch.kernels.source_expert_count import (
        source_expert_count, source_expert_count_plain)
    if isinstance(T, str):
        T, K = _slots(T)
    ids, src = _stats_case(cuda, T, K, E, S, skew)
    before = source_expert_count.launches
    b, a = source_expert_count(ids, src, n_experts=E, n_sources=S)
    assert source_expert_count.launches == before + 1
    rb, ra = source_expert_count_plain(ids, src, n_experts=E, n_sources=S)
    torch.cuda.synchronize()
    assert torch.equal(b, rb) and torch.equal(a, ra)


@pytest.mark.parametrize("limit", [1 << 30, -1])      # one block; the grid
@pytest.mark.parametrize("T,K,S,skew", [
    (8, 8, 2, None), (2048, 8, 2, "hot"), (4096, 8, 8, "one_expert")])
def test_source_expert_count_forced_path(cuda, limit, T, K, S, skew):
    """Either path, forced through ``single_block_slots``, at any size."""
    from repro_torch.kernels.source_expert_count import (
        source_expert_count, source_expert_count_plain)
    ids, src = _stats_case(cuda, T, K, 128, S, skew)
    b, a = source_expert_count(ids, src, n_experts=128, n_sources=S,
                               single_block_slots=limit)
    rb, ra = source_expert_count_plain(ids, src, n_experts=128, n_sources=S)
    torch.cuda.synchronize()
    assert torch.equal(b, rb) and torch.equal(a, ra)


@pytest.mark.parametrize("where", ["under", "over"])
def test_source_expert_count_launches(cuda, where):
    """Up to the single-block limit a call is one kernel and no memset;
    past it, the two memsets and the grid, as the profiler sees them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.source_expert_count import source_expert_count
    T, K = (8, 8) if where == "under" else _slots("over")
    ids, src = _stats_case(cuda, T, K, 128, 2, "hot")
    source_expert_count(ids, src, n_experts=128, n_sources=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        source_expert_count(ids, src, n_experts=128, n_sources=2)
        torch.cuda.synchronize()
    events = {e.key: e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
    memsets = sum(n for key, n in events.items() if "emset" in key)
    kernels = {key: n for key, n in events.items()
               if "source_expert_count" in key}
    if where == "under":
        assert memsets == 0 and len(events) == 1, events
        assert list(kernels.values()) == [1] and \
            "source_expert_count_block" in next(iter(kernels)), events
    else:
        assert memsets == 2 and list(kernels.values()) == [1], events
        assert "source_expert_count_grid" in next(iter(kernels)), events


def test_wrappers_raise_on_bad_input(cuda):
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ragged
    from repro_torch.kernels.paged_decode import paged_decode
    q = torch.zeros(2, 4, 16, device=cuda)
    kp = torch.zeros(3, 8, 2, 16, device=cuda)
    bt = torch.zeros(2, 2, dtype=torch.int64, device=cuda)
    ctx = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        paged_decode(q, kp, kp, bt, ctx)
    with pytest.raises(TypeError, match="dtype"):
        paged_decode(q.half(), kp, kp, bt.int(), ctx)
    ks = torch.zeros(3, 8, 2, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        paged_decode(q, kp, kp, bt.int(), ctx, k_scales=ks, v_scales=ks)
    with pytest.raises(ValueError, match="k_scales"):
        paged_decode(q, kp.to(torch.int8), kp.to(torch.int8), bt.int(), ctx,
                     k_scales=ks[:, :4], v_scales=ks)
    x = torch.zeros(16, 8, device=cuda)
    w = torch.zeros(2, 8, 4, device=cuda)
    meta = [torch.zeros(n, dtype=torch.int32, device=cuda) for n in (2, 2, 3)]
    with pytest.raises(ValueError, match="multiple of 8"):
        moe_gmm_ragged(x, w, *meta, n_block=4)
    with pytest.raises(ValueError, match="x "):
        moe_gmm(x[None], w[:1, :4])
    with pytest.raises(TypeError, match="dtype"):
        moe_gmm(x[None], w[:1].half())
    kc = torch.zeros(2, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="k_pos"):
        flash_decode(q, kc, kc, ctx[:, None], ctx)
    with pytest.raises(TypeError, match="int32"):
        flash_decode(q, kc, kc, bt.repeat(1, 4), ctx)


# (Hq, Hkv, hd, S, NB, chunk starts, chunk lengths) of a paged prefill
# call, ps = 16: chunks from 0 and from mid-page, contexts no multiple of
# the page size, rows past a chunk, a padding lane (0, 0); a lane whose
# chunk starts at 8000 of 8448 slots and one that ends at the last slot;
# a causal diagonal inside one 64-slot tile (start 10, 20 rows)
PREFILL_CASES = {
    "qwen3-moe G=8": (32, 4, 128, 64, 20, [0, 37, 100, 0], [64, 30, 61, 0]),
    "llama4 G=5": (40, 8, 128, 64, 20, [0, 37, 100, 0], [64, 30, 61, 0]),
    "qwen3-8b G=4": (32, 8, 128, 64, 20, [0, 37, 100, 0], [64, 30, 61, 0]),
    "qwen1.5 G=1": (40, 40, 128, 64, 20, [0, 37, 100, 0], [64, 30, 61, 0]),
    "8448-slot tables": (32, 4, 128, 256, 528, [8000, 8192, 0],
                         [256, 256, 200]),
    "diagonal in one tile": (32, 8, 128, 32, 4, [10, 0], [20, 32]),
    "hd 64": (16, 2, 64, 48, 8, [5, 0, 40], [43, 17, 48]),
    "hd 32": (12, 4, 32, 40, 8, [0, 21], [40, 33]),
    "hd 16 (CUDA cores)": (4, 2, 16, 24, 6, [0, 9, 0], [24, 15, 0]),
    "hd 48 (CUDA cores)": (6, 2, 48, 24, 6, [3, 0], [21, 24]),
}


def _prefill_inputs(cuda, dtype, Hq, Hkv, hd, S, NB, starts, lens, seed):
    """q, a pool whose page 0 holds garbage, and block tables with each
    lane's live pages, distinct, then page 0 past them."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    B, ps = len(starts), 16
    P = B * NB + 1
    q = torch.randn(B, S, Hq, hd, generator=g, device=cuda).to(dtype)
    kp = torch.randn(P, ps, Hkv, hd, generator=g, device=cuda).to(dtype)
    vp = torch.randn(P, ps, Hkv, hd, generator=g, device=cuda).to(dtype)
    free = list(np.random.default_rng(seed).permutation(np.arange(1, P)))
    bt = np.zeros((B, NB), np.int32)
    for b, (s, n) in enumerate(zip(starts, lens)):
        for j in range(-(-(s + n) // ps)):
            bt[b, j] = free.pop()
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    ctx = st + torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, kp, vp, torch.as_tensor(bt, device=cuda), st, ctx


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_paged_prefill_kernel(cuda, dtype, case):
    """The kernel against its plain twin on every real row (within the
    dtype's bar, and each (lane, token) row within ``ROW_TOL`` of its own
    norm); rows past a chunk and padding lanes exact zeros."""
    from repro_torch.kernels.decode_route import ROW_TOL, row_rel_err
    from repro_torch.kernels.paged_prefill import (
        TC_HEAD_DIMS, paged_prefill_attention, paged_prefill_attention_plain)
    Hq, Hkv, hd, S, NB, starts, lens = PREFILL_CASES[case]
    args = _prefill_inputs(cuda, dtype, Hq, Hkv, hd, S, NB, starts, lens,
                           seed=hd + Hq)
    before = (paged_prefill_attention.launches,
              paged_prefill_attention.tc_launches)
    out = paged_prefill_attention(*args)
    tc = dtype == torch.bfloat16 and hd in TC_HEAD_DIMS
    assert (paged_prefill_attention.launches,
            paged_prefill_attention.tc_launches) == (before[0] + 1,
                                                     before[1] + tc)
    ref = paged_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    for b, n in enumerate(lens):
        assert torch.equal(out[b, n:], torch.zeros_like(out[b, n:]))
        if n:
            torch.testing.assert_close(out[b, :n].float(),
                                       ref[b, :n].float(), rtol=TOL[dtype],
                                       atol=TOL[dtype])
            assert row_rel_err(out[b, :n], ref[b, :n]) <= ROW_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_paged_prefill_kernel_int8(cuda, dtype, case):
    """Int8 pages with f32 scales: the kernel, which dequantizes each live
    slot as ``unpack_kv`` does, against its plain twin (the whole table
    gathered and unpacked), on the route of q's type."""
    from repro_torch.kernels.decode_route import ROW_TOL, row_rel_err
    from repro_torch.kernels.kv_pack import pack_kv_plain
    from repro_torch.kernels.paged_prefill import (
        TC_HEAD_DIMS, paged_prefill_attention, paged_prefill_attention_plain)
    Hq, Hkv, hd, S, NB, starts, lens = PREFILL_CASES[case]
    q, kp, vp, bt, st, ctx = _prefill_inputs(cuda, dtype, Hq, Hkv, hd, S,
                                             NB, starts, lens,
                                             seed=hd + Hq + 1)
    kp, ks = pack_kv_plain(kp)
    vp, vs = pack_kv_plain(vp)
    args = (q, kp, vp, bt, st, ctx)
    before = (paged_prefill_attention.launches,
              paged_prefill_attention.tc_launches)
    out = paged_prefill_attention(*args, k_scales=ks, v_scales=vs)
    tc = dtype == torch.bfloat16 and hd in TC_HEAD_DIMS
    assert (paged_prefill_attention.launches,
            paged_prefill_attention.tc_launches) == (before[0] + 1,
                                                     before[1] + tc)
    ref = paged_prefill_attention_plain(*args, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    for b, n in enumerate(lens):
        assert torch.equal(out[b, n:], torch.zeros_like(out[b, n:]))
        if n:
            torch.testing.assert_close(out[b, :n].float(),
                                       ref[b, :n].float(), rtol=TOL[dtype],
                                       atol=TOL[dtype])
            assert row_rel_err(out[b, :n], ref[b, :n]) <= ROW_TOL[dtype]


def test_paged_prefill_counts_one_launch_a_layer(cuda):
    """``prefill_chunk_paged`` and ``mixed_step_paged`` on the card, on bf16
    and on int8 pages: one ``paged_prefill_attention`` launch a layer, on
    the tensor cores at a bf16 head width of 32 (the mixed step's decode
    rows still go through ``paged_decode``), and no ``unpack_kv``."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.kv_pack import unpack_kv
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              head_dim=32)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = tfm.init_params(cfg, generator=g, device=cuda)
    for kv_dtype in ("auto", "int8"):
        unpacked = unpack_kv.launches
        _count_prefill_launches(tfm, cfg, params, g, cuda, kv_dtype,
                                paged_prefill_attention, paged_decode)
        assert unpack_kv.launches == unpacked


def _count_prefill_launches(tfm, cfg, params, g, cuda, kv_dtype,
                            paged_prefill_attention, paged_decode):
    pages = tfm.init_paged_cache(cfg, 9, 16, kv_dtype=kv_dtype, device=cuda)
    bt = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 0]], dtype=torch.int32,
                      device=cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     generator=g, device=cuda),
             "chunk_starts": torch.tensor([0, 9], device=cuda),
             "chunk_lens": torch.tensor([20, 24], device=cuda)}
    before = (paged_prefill_attention.launches,
              paged_prefill_attention.tc_launches, paged_decode.launches)
    logits, pages, _ = tfm.prefill_chunk_paged(params, cfg, batch, pages,
                                               block_tables=bt)
    n = cfg.n_layers
    assert (paged_prefill_attention.launches,
            paged_prefill_attention.tc_launches, paged_decode.launches) == (
        before[0] + n, before[1] + n, before[2])
    batch = {"tokens": batch["tokens"][:, :8],
             "chunk_starts": torch.tensor([20, 33], device=cuda),
             "chunk_lens": torch.tensor([1, 8], device=cuda),
             "decode_mask": torch.tensor([True, False], device=cuda)}
    logits, pages, _ = tfm.mixed_step_paged(params, cfg, batch, pages,
                                            block_tables=bt)
    assert (paged_prefill_attention.launches,
            paged_prefill_attention.tc_launches, paged_decode.launches) == (
        before[0] + 2 * n, before[1] + 2 * n, before[2] + n)
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()


def test_paged_prefill_raises_on_bad_input(cuda):
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    q = torch.zeros(2, 4, 4, 16, device=cuda)
    kp = torch.zeros(3, 8, 2, 16, device=cuda)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    n = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="softcap"):
        paged_prefill_attention(q, kp, kp, bt, n, n, softcap=50.0)
    with pytest.raises(TypeError, match="int32"):
        paged_prefill_attention(q, kp, kp, bt.long(), n, n)
    with pytest.raises(TypeError, match="int8"):
        paged_prefill_attention(q, kp.to(torch.int8), kp.to(torch.int8), bt,
                                n, n)
    k8, sc = kp.to(torch.int8), torch.ones(3, 8, 2, device=cuda)
    with pytest.raises(ValueError, match="k_scales"):
        paged_prefill_attention(q, k8, k8, bt, n, n, k_scales=sc,
                                v_scales=sc[:2])
    with pytest.raises(ValueError, match="without"):
        paged_prefill_attention(q, kp, kp, bt, n, n, v_scales=sc)
    with pytest.raises(ValueError, match="does not fit"):
        paged_prefill_attention(q, kp[..., :8], kp[..., :8], bt, n, n)
