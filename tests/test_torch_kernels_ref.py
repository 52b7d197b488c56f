"""Each kernel's plain PyTorch version against the reference's kernel on the
same numpy inputs (Pallas in interpret mode, as the reference's own tests
run it), and the wrappers' CPU routing.

Tolerances: float outputs within 1e-5 (f32) and 3e-2 (bf16); integer
outputs exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as j_flash_decode
from repro.kernels.moe_gmm import moe_gmm as j_moe_gmm
from repro.kernels.moe_dispatch import pick_row_block as j_pick_row_block
from repro.kernels.moe_dispatch import ragged_dispatch as j_ragged_dispatch
from repro.kernels.paged_decode import paged_decode_pallas, paged_decode_xla
from repro.models.attention import ring_positions as j_ring_positions
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.moe_gmm import (moe_gmm, moe_gmm_plain,
                                         moe_gmm_ragged, moe_gmm_ragged_plain)
from repro_torch.models.attention import ring_positions
from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
from repro_torch.kernels.source_expert_count import (
    source_expert_count, source_expert_count_plain)


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _block_tables(B, P, ps, NB, ctx, rng):
    """Random distinct physical pages per request (page 0 stays garbage)."""
    bt = np.zeros((B, NB), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        for j in range(-(-int(ctx[b]) // ps)):
            bt[b, j] = free.pop()
    return bt


@pytest.mark.parametrize("B,Hq,Hkv,hd,ps,NB", [
    (2, 4, 4, 32, 16, 4),     # MHA
    (3, 8, 2, 16, 8, 5),      # GQA 4:1
    (4, 4, 1, 64, 32, 3),     # MQA, bigger pages
    (3, 32, 4, 128, 16, 4),   # the served model's heads
])
def test_paged_decode_plain_matches_reference(B, Hq, Hkv, hd, ps, NB):
    P = B * NB + 4
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, Hq, hd)).astype(np.float32)
    kp = rng.normal(size=(P, ps, Hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(P, ps, Hkv, hd)).astype(np.float32)
    ctx = np.resize(np.minimum([0, 1, ps, NB * ps - 3], NB * ps), B) \
        .astype(np.int32)                       # includes an empty lane
    bt = _block_tables(B, P, ps, NB, ctx, rng)
    out = paged_decode_plain(_t(q), _t(kp), _t(vp), _t(bt), _t(ctx)).numpy()
    args = tuple(jnp.asarray(a) for a in (q, kp, vp, bt, ctx))
    for ref in (paged_decode_xla(*args),
                paged_decode_pallas(*args, interpret=True),
                jref.paged_decode_ref(*args)):
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    assert (out[ctx == 0] == 0).all()


def test_paged_decode_wrapper_runs_plain_on_cpu():
    rng = np.random.default_rng(4)
    B, Hq, Hkv, hd, ps, NB = 2, 8, 2, 16, 8, 3
    P = B * NB + 1
    q = _t(rng.normal(size=(B, Hq, hd)).astype(np.float32))
    kp = _t(rng.normal(size=(P, ps, Hkv, hd)).astype(np.float32))
    vp = _t(rng.normal(size=(P, ps, Hkv, hd)).astype(np.float32))
    ctx = _t(np.array([5, 24], np.int32))
    bt = _t(_block_tables(B, P, ps, NB, ctx.numpy(), rng))
    before = paged_decode.launches
    out = paged_decode(q, kp, vp, bt, ctx)
    assert paged_decode.launches == before       # no kernel on the CPU
    assert torch.equal(out, paged_decode_plain(q, kp, vp, bt, ctx))


@pytest.mark.parametrize("T,K,E,D,F", [
    (16, 2, 8, 32, 24),
    (40, 4, 8, 64, 48),
    (8, 8, 128, 32, 16),      # the served model's E and top-k, decode-sized
])
def test_moe_gmm_ragged_plain_matches_reference(T, K, E, D, F):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(T, D)).astype(np.float32)
    ids = np.stack([rng.permutation(E)[:K] for _ in range(T)]) \
        .astype(np.int32)
    w = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    nb = j_pick_row_block(T * K, E)
    d = j_ragged_dispatch(jnp.asarray(x), jnp.asarray(ids), E, row_block=nb)
    ref = jops.moe_gmm_ragged(d.xs, jnp.asarray(w), d.tile_expert,
                              d.group_sizes, d.padded_offsets, n_block=nb)
    meta = [_t(np.asarray(a)) for a in (d.xs, w, d.tile_expert,
                                        d.group_sizes, d.padded_offsets)]
    out = moe_gmm_ragged_plain(*meta, n_block=nb)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    before = moe_gmm_ragged.launches
    assert torch.equal(moe_gmm_ragged(*meta, n_block=nb), out)
    assert moe_gmm_ragged.launches == before


@pytest.mark.parametrize("T,K,E,S", [(64, 1, 8, 2), (100, 8, 128, 2),
                                     (33, 3, 16, 4)])
def test_source_expert_count_plain_is_exact(T, K, E, S):
    rng = np.random.default_rng(6)
    ids = rng.integers(-1, E, size=(T, K)).astype(np.int32)   # -1 = masked
    src = rng.integers(-1, S, size=(T,)).astype(np.int32)
    b, a = source_expert_count_plain(_t(ids), _t(src), n_experts=E,
                                     n_sources=S)
    jb, ja = jops.source_expert_count(jnp.asarray(ids), jnp.asarray(src),
                                      n_experts=E, n_sources=S)
    rb, ra = jref.source_expert_count_ref(jnp.asarray(ids), jnp.asarray(src),
                                          n_experts=E, n_sources=S)
    assert b.dtype == torch.int32 and a.dtype == torch.int32
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    before = source_expert_count.launches
    b2, a2 = source_expert_count(_t(ids), _t(src), n_experts=E, n_sources=S)
    assert torch.equal(b2, b) and torch.equal(a2, a)
    assert source_expert_count.launches == before


def _tt(a):
    """A JAX array (bf16 included) as a CPU tensor of the same bits."""
    return params_from_numpy(np.asarray(a), device="cpu")


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,Hq,Hkv,hd,L", [
    (4, 4, 4, 64, 512), (4, 8, 4, 64, 1024), (4, 8, 2, 128, 256),
    (4, 32, 4, 128, 128),      # the served model's heads
])
def test_flash_decode_plain_matches_reference(B, Hq, Hkv, hd, L, dtype, tol):
    """Rows: a prefix cache, a wrapped ring, a ring not yet full, and a row
    with no valid slot (exact zeros, as the Pallas kernel gives)."""
    rng = np.random.default_rng(B * L + hd)
    q = jnp.asarray(rng.normal(size=(B, Hq, hd)), dtype)
    kc = jnp.asarray(rng.normal(size=(B, L, Hkv, hd)), dtype)
    vc = jnp.asarray(rng.normal(size=(B, L, Hkv, hd)), dtype)
    write = np.array([L // 3, 2 * L + 5, L - 1, 7], np.int32)
    kpos = np.array(j_ring_positions(jnp.asarray(write), L))
    np.testing.assert_array_equal(
        ring_positions(torch.from_numpy(write), L).numpy(), kpos)
    qpos = write.copy()
    qpos[0] -= 10                 # slots past q_pos are masked too
    kpos[3] = -1                  # no valid slot at all
    jk, jq = jnp.asarray(kpos), jnp.asarray(qpos)
    pallas = np.asarray(j_flash_decode(q, kc, vc, jk, jq, l_block=128,
                                       interpret=True), np.float32)
    oracle = np.asarray(jref.flash_decode_ref(q, kc, vc, jk, jq), np.float32)
    args = (_tt(q), _tt(kc), _tt(vc), torch.from_numpy(kpos),
            torch.from_numpy(qpos))
    out = flash_decode_plain(*args)
    assert out.dtype == args[0].dtype
    out = out.float().numpy()
    np.testing.assert_allclose(out, pallas, rtol=tol, atol=tol)
    # the oracle softmaxes an all-masked row into the mean of V; the kernel
    # (and so the port) gives zeros there
    np.testing.assert_allclose(out[:3], oracle[:3], rtol=tol, atol=tol)
    assert (out[3] == 0).all() and (pallas[3] == 0).all()
    before = flash_decode.launches
    assert torch.equal(flash_decode(*args).float(), torch.from_numpy(out))
    assert flash_decode.launches == before


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, 3e-2)])
@pytest.mark.parametrize("E,C,D,F", [
    (2, 37, 100, 130), (3, 5, 64, 96), (4, 13, 200, 72),   # odd dims
    (8, 4, 64, 48),            # the decode-regroup capacity C = 4
])
def test_moe_gmm_plain_matches_reference(E, C, D, F, dtype, tol):
    rng = np.random.default_rng(E * C + D)
    x = jnp.asarray(rng.normal(size=(E, C, D)), dtype)
    w = jnp.asarray(rng.normal(size=(E, D, F)) / np.sqrt(D), dtype)
    ref = np.asarray(j_moe_gmm(x, w, c_block=32, f_block=128, d_block=64,
                               interpret=True))
    args = (_tt(x), _tt(w))
    out = moe_gmm_plain(*args)
    assert out.dtype == torch.float32 and tuple(out.shape) == (E, C, F)
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(jops.moe_gmm(x, w)),
                               rtol=tol, atol=tol)
    before = moe_gmm.launches
    assert torch.equal(moe_gmm(*args), out)
    assert moe_gmm.launches == before
