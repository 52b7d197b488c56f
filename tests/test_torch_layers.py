"""Port layers against the reference's on the same numpy inputs.

Tolerances: f32 within 1e-5; bf16 within 3e-2 (one bf16 rounding of
differently ordered f32 sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jl
from repro_torch.bridge import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = ["float32", "bfloat16"]


def _pair(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr, jnp.dtype(dtype))
    t = params_from_numpy(np.asarray(j), device="cpu")
    return j, t


def _close(t, j, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=(2, 5, 64)), dtype)
    sj, st = _pair(rng.normal(size=(64,)) * 0.1, "float32")
    _close(tl.rms_norm(xt, st, 1e-6), jl.rms_norm(xj, sj, 1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_rotates_split_halves(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(2, 5, 4, 16)), dtype)
    pos = rng.integers(0, 900, size=(2, 5)).astype(np.int32)
    out_t = tl.apply_rope(xt, torch.from_numpy(pos), 1e6)
    _close(out_t, jl.apply_rope(xj, jnp.asarray(pos), 1e6), dtype)
    # split halves: rotating by position 0 is the identity, and pairs are
    # (i, i + hd/2), not (2i, 2i + 1)
    zero = torch.zeros((2, 5), dtype=torch.int32)
    assert torch.equal(tl.apply_rope(xt, zero, 1e6), xt)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype):
    rng = np.random.default_rng(2)
    p = jl.init_mlp(jax.random.PRNGKey(0), 64, 48, jnp.dtype(dtype))
    xj, xt = _pair(rng.normal(size=(3, 64)), dtype)
    _close(tl.mlp(params_from_numpy(p, device="cpu"), xt), jl.mlp(p, xj),
           dtype)


def test_embed_and_logits(tiny_model):
    cfg, params = tiny_model
    emb = params_from_numpy(params["embed"], device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    xj = jl.embed_tokens(params["embed"], cfg, jnp.asarray(toks, jnp.int32))
    xt = tl.embed_tokens(emb, cfg, torch.from_numpy(toks))
    assert xt.dtype == torch.bfloat16
    np.testing.assert_array_equal(xt.float().numpy(),
                                  np.asarray(xj, np.float32))
    lj = jl.lm_logits(params["embed"], cfg, xj)
    lt = tl.lm_logits(emb, cfg, xt)
    assert lt.dtype == torch.float32
    _close(lt, lj, "bfloat16")


def test_dense_init_is_truncated_fan_in():
    g = torch.Generator().manual_seed(0)
    w = tl.dense_init((256, 64), 0, torch.float32, generator=g, device="cpu")
    std = 1.0 / np.sqrt(256)
    assert w.shape == (256, 64) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2.0 * std + 1e-7
    assert abs(float(w.std()) / std - 0.88) < 0.05     # truncated at 2 sigma
    w2 = tl.dense_init((256, 64), 0, torch.float32,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert torch.equal(w, w2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q_block,kv_block", [(512, 512), (16, 32)])
def test_flash_attention(dtype, q_block, kv_block):
    rng = np.random.default_rng(4)
    B, Sq, Skv, Hq, Hkv, hd = 2, 37, 70, 4, 2, 16
    qj, qt = _pair(rng.normal(size=(B, Sq, Hq, hd)), dtype)
    kj, kt = _pair(rng.normal(size=(B, Skv, Hkv, hd)), dtype)
    vj, vt = _pair(rng.normal(size=(B, Skv, Hkv, hd)), dtype)
    q_pos = (np.arange(Sq)[None] + np.array([[20], [33]])).astype(np.int32)
    k_pos = np.where(np.arange(Skv)[None] < np.array([[57], [70]]),
                     np.arange(Skv)[None], -1).astype(np.int32)
    kw = dict(causal=True, q_block=q_block, kv_block=kv_block)
    oj = jattn.flash_attention(qj, kj, vj, q_pos=jnp.asarray(q_pos),
                               k_pos=jnp.asarray(k_pos), **kw)
    ot = tattn.flash_attention(qt, kt, vt, q_pos=torch.from_numpy(q_pos),
                               k_pos=torch.from_numpy(k_pos), **kw)
    assert ot.dtype == qt.dtype and ot.shape == qt.shape
    _close(ot, oj, dtype)


@pytest.mark.parametrize("q_block,kv_block", [(512, 512), (16, 32)])
def test_flash_attention_recompute_keeps_the_gradient(monkeypatch, q_block,
                                                      kv_block):
    """Past ``REMAT_SCORES_BYTES`` the backward recomputes each query
    block's softmax: the same gradients, bit for bit, as keeping them, and
    within 1e-5 of the reference's (float32)."""
    rng = np.random.default_rng(5)
    B, Sq, Skv, Hq, Hkv, hd = 2, 37, 70, 4, 2, 16
    arrs = [rng.normal(size=(B, Sq, Hq, hd)), rng.normal(size=(B, Skv, Hkv,
                                                               hd)),
            rng.normal(size=(B, Skv, Hkv, hd))]
    w = rng.normal(size=(B, Sq, Hq, hd))
    q_pos = (np.arange(Sq)[None] + np.array([[20], [33]])).astype(np.int32)
    k_pos = np.where(np.arange(Skv)[None] < np.array([[57], [70]]),
                     np.arange(Skv)[None], -1).astype(np.int32)
    kw = dict(causal=True, q_block=q_block, kv_block=kv_block)

    def grads(limit):
        monkeypatch.setattr(tattn, "REMAT_SCORES_BYTES", limit)
        qkv = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
               for a in arrs]
        out = tattn.flash_attention(*qkv, q_pos=torch.from_numpy(q_pos),
                                    k_pos=torch.from_numpy(k_pos), **kw)
        (out * torch.from_numpy(w).float()).sum().backward()
        return [t.grad for t in qkv]

    kept, recomputed = grads(2 ** 62), grads(0)
    assert all(torch.equal(a, b) for a, b in zip(kept, recomputed))
    ref = jax.grad(lambda q, k, v: jnp.sum(jattn.flash_attention(
        q, k, v, q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos), **kw)
        * jnp.asarray(w, jnp.float32)), argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.float32) for a in arrs))
    for t, j in zip(recomputed, ref):
        _close(t, j, "float32")
