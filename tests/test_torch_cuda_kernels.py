"""Each CUDA kernel against its plain PyTorch version on the card, over a
sweep of shapes and both input types. Needs an NVIDIA GPU with nvcc; on
any other host every test here skips.

    python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Tolerances: f32 within 1e-4, bf16 within 3e-2 (sums taken in another
order), integer outputs exact; the int8 pack and unpack bit-exact (same
IEEE division, same round-half-to-even, one rounding each)."""
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
                (8, 32, 4, 128, 16, 64), (2, 16, 2, 256, 8, 6)]


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
    before = paged_decode.launches
    out = paged_decode(q, kp, vp, bt, ctx)
    assert paged_decode.launches == before + 1
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
    before = paged_decode.launches
    out = paged_decode(q, kp, vp, bt, ctx, k_scales=ks, v_scales=vs)
    assert paged_decode.launches == before + 1
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,K,E,D,F", [
    (8, 8, 128, 256, 96), (64, 2, 8, 64, 40), (700, 8, 16, 128, 200),
    (3, 1, 4, 72, 130)])
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
    out = moe_gmm_ragged(*args, n_block=d.row_block)
    ref = moe_gmm_ragged_plain(*args, n_block=d.row_block)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert torch.equal(out[pad], torch.zeros_like(out[pad]))
    torch.testing.assert_close(out, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("T,K,E,S", [(1, 1, 8, 2), (2048, 1, 128, 2),
                                     (300, 8, 128, 4), (5000, 2, 64, 8)])
def test_source_expert_count_kernel(cuda, T, K, E, S):
    from repro_torch.kernels.source_expert_count import (
        source_expert_count, source_expert_count_plain)
    g = torch.Generator(device=cuda).manual_seed(2)
    ids = torch.randint(-1, E + 1, (T, K), generator=g, device=cuda,
                        dtype=torch.int32)             # -1 and E count nowhere
    src = torch.randint(-1, S + 1, (T,), generator=g, device=cuda,
                        dtype=torch.int32)
    b, a = source_expert_count(ids, src, n_experts=E, n_sources=S)
    rb, ra = source_expert_count_plain(ids, src, n_experts=E, n_sources=S)
    torch.cuda.synchronize()
    assert torch.equal(b, rb) and torch.equal(a, ra)


def test_wrappers_raise_on_bad_input(cuda):
    from repro_torch.kernels.moe_gmm import moe_gmm_ragged
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
