"""The port's capacity-padded MoE dispatch against the reference's
(``moe_layer(ragged=False)``): prefill with capacity overflow (tokens past an
expert's capacity dropped), the decode regroup (S == 1, B > 1: one dispatch
group), and the paged engine serving through it.

Integer outputs (statistics, the set of tokens that lost a slot) must be
identical; y within 3e-2 in bf16 and 1e-5 in f32; token streams identical
in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import reduced
from repro.models import build_model
from repro.models import moe as jmoe
from repro.serving import PagedEngineConfig as JConfig
from repro.serving import PagedModelRunner as JRunner
from repro.serving import PagedRealEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.bridge import config_from_dict, params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.serving import PagedEngineConfig as TConfig
from repro_torch.serving import PagedModelRunner as TRunner
from repro_torch.serving import PagedRealEngine as TEngine
from repro_torch.serving import Request as TRequest


def _layer(tiny_model, dtype):
    cfg, params = tiny_model
    cfg = dataclasses.replace(cfg, dtype=dtype)
    moe_p = jax.tree.map(
        lambda a: a[0].astype(jnp.dtype(dtype)) if a.ndim == 4 else a[0],
        params["blocks"]["pos0"]["moe"])
    return cfg, moe_p


def _run_both(cfg, moe_p, x, placement, src, mask, cf):
    kw = dict(n_sources=2, capacity_factor=cf)
    yj, sj = jmoe.moe_layer(moe_p, cfg, x, jnp.asarray(placement),
                            source_ids=jnp.asarray(src), ragged=False,
                            token_mask=None if mask is None
                            else jnp.asarray(mask), **kw)
    yt, st = tmoe.moe_layer(
        params_from_numpy(moe_p, device="cpu"), cfg,
        params_from_numpy(np.asarray(x), device="cpu"),
        torch.from_numpy(placement), source_ids=torch.from_numpy(src),
        ragged=False, token_mask=None if mask is None
        else torch.from_numpy(mask), **kw)
    return (np.asarray(yj, np.float32), sj), (yt.float().numpy(), st)


def _check_stats(st, sj):
    for k in ("expert_counts", "source_expert"):
        assert st[k].dtype == torch.int32
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]),
                                      err_msg=k)
    np.testing.assert_allclose(float(st["aux_loss"]), float(sj["aux_loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 3e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("B,S,masked", [
    (2, 20, False),         # prefill: 40 slots per row over 8 experts
    (3, 7, True),           # prefill with padding rows masked from stats
    (6, 1, False),          # decode regroup: one group of 6 tokens
    (1, 1, False),          # one decode token: no regroup
])
def test_padded_moe_layer_matches_reference(tiny_model, dtype, tol, B, S,
                                            masked):
    cfg, moe_p = _layer(tiny_model, dtype)
    rng = np.random.default_rng(B * 100 + S)
    x = jnp.asarray(rng.normal(size=(B, S, cfg.d_model)), jnp.dtype(dtype))
    placement = rng.permutation(cfg.moe.n_experts).astype(np.int32)
    src = (np.arange(B) % 2).astype(np.int32)
    mask = rng.random(size=(B, S)) < 0.6 if masked else None
    (yj, sj), (yt, st) = _run_both(cfg, moe_p, x, placement, src, mask,
                                   cf=None)
    assert yt.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(yt, yj, rtol=tol, atol=tol)
    _check_stats(st, sj)


@pytest.mark.parametrize("B,S", [(2, 20), (24, 1)])
def test_capacity_overflow_drops_the_same_tokens(tiny_model, B, S):
    """At capacity factor 0.25 the queues overflow (C = 4 slots per expert
    against S*K/E = 5 or 6 on average, skewed by the router): the tokens
    whose output changes against a capacity that drops nothing are the
    same in both packages, and y matches."""
    cfg, moe_p = _layer(tiny_model, "float32")
    rng = np.random.default_rng(7 + S)
    x = jnp.asarray(rng.normal(size=(B, S, cfg.d_model)), jnp.float32)
    placement = rng.permutation(cfg.moe.n_experts).astype(np.int32)
    src = np.zeros(B, np.int32)
    dropped = []
    for pkg in (0, 1):
        ys = [_run_both(cfg, moe_p, x, placement, src, None, cf)[pkg][0]
              for cf in (0.25, 64.0)]
        dropped.append(np.abs(ys[0] - ys[1]).max(axis=-1) > 1e-4)
    (yj, sj), (yt, st) = _run_both(cfg, moe_p, x, placement, src, None,
                                   cf=0.25)
    np.testing.assert_array_equal(dropped[1], dropped[0])
    assert dropped[0].any() and not dropped[0].all()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    _check_stats(st, sj)       # statistics count the dropped slots too


RUNNER = dict(page_size=8, n_pages=64, max_blocks_per_req=8, max_batch=4,
              token_budget=16, chunk_buckets=(8, 16), lane_buckets=(1, 2, 4),
              max_prefill_lanes=4)


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        n = int(rng.integers(3, 40))
        out.append(cls(req_id=i, prompt_len=n,
                       max_new_tokens=int(rng.integers(3, 8)),
                       arrival_time=0.001 * i,
                       prompt_tokens=rng.integers(0, vocab, n).tolist()))
    return out


def _serve_paged(engine_cls, runner, cfg, params, ecfg, reqs):
    engines = [engine_cls(i, cfg, params, ecfg, runner=runner, n_sources=2)
               for i in range(2)]
    for i, r in enumerate(reqs):
        engines[i % 2].enqueue(r, 0.0)
    stats, now = [], 0.0
    for _ in range(500):
        if not any(e.has_work for e in engines):
            break
        for e in engines:
            e.step(now)
            stats.append(e.window_stats())
        now += 0.01
    assert not any(e.has_work for e in engines)
    return engines, stats


@pytest.mark.parametrize("mixed", [False, True])
def test_paged_engine_serves_padded_dispatch_like_reference(mixed):
    cfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2,
                  dtype="float32")
    jp = build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    tp = params_from_numpy(jp, device="cpu")
    jcfg = JConfig(**RUNNER, attn_backend="xla", mixed_steps=mixed)
    tecfg = TConfig(**RUNNER, device="cpu", mixed_steps=mixed)
    jr = JRunner(cfg, jp, jcfg, n_sources=2, ragged_dispatch=False)
    tr = TRunner(tcfg, tp, tecfg, n_sources=2, ragged_dispatch=False)
    assert tr.ragged_dispatch is False
    j_reqs = _requests(JRequest, cfg.vocab_size)
    t_reqs = _requests(TRequest, cfg.vocab_size)
    j_eng, j_stats = _serve_paged(JEngine, jr, cfg, jp, jcfg, j_reqs)
    t_eng, t_stats = _serve_paged(TEngine, tr, tcfg, tp, tecfg, t_reqs)
    for jq, tq in zip(j_reqs, t_reqs):
        assert tq.output_tokens == jq.output_tokens, tq.req_id
    for je, te in zip(j_eng, t_eng):
        assert [r.req_id for r in te.finished] == \
            [r.req_id for r in je.finished]
    assert len(t_stats) == len(j_stats)
    for (jb, ja), (tb, ta) in zip(j_stats, t_stats):
        assert (jb is None) == (tb is None)
        if jb is not None:
            np.testing.assert_array_equal(tb, jb)
            np.testing.assert_array_equal(ta, ja)
