"""Int8 KV pages in the port against the reference: the plain pack and
unpack against ``pack_kv_xla``/``unpack_kv_xla`` and the Pallas kernels in
interpret mode on the same numpy inputs, paged decode on int8 pages, the
int8 pool's size, and the wrappers' CPU routing.

Tolerances: int8 codes exact (ties round half to even); scales within 1e-6
relative; unpacked values exact in f32 (one rounding, as the reference) and
bf16; paged decode within 1e-5 in f32, as the reference's own int8 parity
test holds its XLA path.

The port computes the scale as ``max|x| / 127``, an IEEE division, as
``pack_kv_xla`` does when it runs op by op. Under ``jax.jit``, and in the
Pallas kernel's body, XLA rewrites that division into a multiply by the
f32 constant 1/127: the scale then differs by one ulp on some rows, and a
code whose quotient sits on a rounding tie moves by one. Against the Pallas
kernel the codes are therefore held exact on every row whose scale is
bit-identical, and within one elsewhere (ROADMAP.md Queue C)."""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import reduced
from repro.kernels.kv_pack import (pack_kv_pallas, pack_kv_xla,
                                   unpack_kv_pallas, unpack_kv_xla)
from repro.kernels.paged_decode import paged_decode_pallas, paged_decode_xla
from repro.models import transformer as jtfm
from repro_torch.bridge import config_from_dict
from repro_torch.kernels.kv_pack import (pack_kv, pack_kv_plain, unpack_kv,
                                         unpack_kv_plain)
from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
from repro_torch.models import transformer as ttfm

TORCH_DT = {np.float32: torch.float32, ml_dtypes.bfloat16: torch.bfloat16}


def _t(a):
    """numpy (f32, int8 or the reference's bf16) -> a CPU tensor."""
    a = np.array(a, order="C", copy=True)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.uniform(0.01, 8.0, shape[:-1] + (1,)))
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0                 # one zero row
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 4, 128), (3, 16, 4, 128),
                                   (5, 2, 32)])
def test_pack_matches_reference(shape, dtype):
    x = _inputs(shape, dtype)
    q, s = pack_kv_plain(_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == shape and tuple(s.shape) == shape[:-1]
    rq, rs = pack_kv_xla(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    pq, ps = (np.asarray(a) for a in pack_kv_pallas(jnp.asarray(x),
                                                     interpret=True))
    np.testing.assert_allclose(s.numpy(), ps, rtol=1e-6, atol=0)
    same = s.numpy() == ps
    np.testing.assert_array_equal(q.numpy()[same], pq[same])
    assert (np.abs(q.numpy().astype(int) - pq) <= 1).all()
    zero = s.reshape(-1) == 0
    assert zero[1] and not q.reshape(-1, shape[-1])[1].any()
    assert torch.isfinite(s).all()
    tq, ts = pack_kv(_t(x))                           # CPU: the plain path
    assert torch.equal(tq, q) and torch.equal(ts, s)


def test_pack_rounds_ties_half_to_even():
    row = np.array([[127.0, 2.5, 3.5, -0.5]], np.float32)
    want = [[127, 2, 4, 0]]
    q, s = pack_kv_plain(torch.from_numpy(row))
    assert float(s[0]) == 1.0
    assert q.tolist() == want
    for rq, _ in (pack_kv_xla(jnp.asarray(row)),
                  pack_kv_pallas(jnp.asarray(row), interpret=True)):
        assert np.asarray(rq).tolist() == want


@pytest.mark.parametrize("out", [np.float32, ml_dtypes.bfloat16])
def test_unpack_matches_reference(out):
    x = _inputs((2, 24, 4, 128), np.float32, seed=1)
    jq, js = pack_kv_xla(jnp.asarray(x))
    dt = TORCH_DT[out]
    got = unpack_kv_plain(_t(jq), _t(js), dt)
    assert got.dtype == dt
    for ref in (unpack_kv_xla(jq, js, jnp.dtype(out)),
                unpack_kv_pallas(jq, js, jnp.dtype(out), interpret=True)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref).astype(np.float32))
    assert torch.equal(unpack_kv(_t(jq), _t(js), dt), got)
    # within half a quantization step of the input, zero row exact
    back = unpack_kv_plain(_t(jq), _t(js)).numpy()
    assert (np.abs(back - x) <= 0.5 * np.asarray(js)[..., None] + 1e-6).all()
    assert not back.reshape(-1, 128)[1].any()


@pytest.mark.parametrize("B,Hq,Hkv,hd,ps,NB", [
    (2, 4, 2, 32, 8, 4),      # the reference's int8 parity shape
    (3, 32, 4, 128, 16, 4),   # the served model's heads
])
def test_paged_decode_int8_matches_reference(B, Hq, Hkv, hd, ps, NB):
    P = B * NB + 2
    rng = np.random.default_rng(9)
    kf = (rng.normal(size=(P, ps, Hkv, hd)) * 3.0).astype(np.float32)
    vf = (rng.normal(size=(P, ps, Hkv, hd)) * 3.0).astype(np.float32)
    kq, ks = pack_kv_xla(jnp.asarray(kf))
    vq, vs = pack_kv_xla(jnp.asarray(vf))
    q = rng.normal(size=(B, Hq, hd)).astype(np.float32)
    ctx = np.resize([ps + 3, NB * ps, 0], B).astype(np.int32)
    bt = np.zeros((B, NB), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        for j in range(-(-int(ctx[b]) // ps)):
            bt[b, j] = free.pop()
    targs = [_t(a) for a in (q, kq, vq, bt, ctx)]
    out = paged_decode_plain(*targs, _t(ks), _t(vs)).numpy()
    jargs = [jnp.asarray(a) for a in (q, kq, vq, bt, ctx)]
    for ref in (paged_decode_xla(*jargs, k_scales=ks, v_scales=vs),
                paged_decode_pallas(*jargs, k_scales=ks, v_scales=vs,
                                    interpret=True)):
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    assert (out[ctx == 0] == 0).all()
    wrapped = paged_decode(*targs, k_scales=_t(ks), v_scales=_t(vs))
    np.testing.assert_array_equal(wrapped.numpy(), out)


def test_int8_pool_bytes_ratio():
    """Equal pool bytes hold 2*hd/(hd+4) times the tokens with int8 pages
    (2-byte fp values against int8 values plus an f32 scale per row)."""
    jcfg = get_smoke_config("qwen3-moe-30b-a3b")
    jcfg = reduced(jcfg, n_layers=2)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    hd = cfg.head_dim
    fp = ttfm.init_paged_cache(cfg, 4, 8, device="cpu")
    i8 = ttfm.init_paged_cache(cfg, 4, 8, kv_dtype="int8", device="cpu")
    assert set(i8["pos0"]) == {"k", "v", "k_scale", "v_scale"}
    assert i8["pos0"]["k"].dtype == torch.int8
    assert i8["pos0"]["k_scale"].dtype == torch.float32
    nb_fp = ttfm.paged_cache_page_nbytes(fp)
    nb_i8 = ttfm.paged_cache_page_nbytes(i8)
    assert nb_fp / nb_i8 == pytest.approx(2 * hd / (hd + 4))
    assert nb_fp == jtfm.paged_cache_page_nbytes(
        jtfm.init_paged_cache(jcfg, 4, 8))
    assert nb_i8 == jtfm.paged_cache_page_nbytes(
        jtfm.init_paged_cache(jcfg, 4, 8, kv_dtype="int8"))
