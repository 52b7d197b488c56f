"""The port's PagedRealEngine against the reference's, driven over the same
requests on a float32 twin of the test model: same finish order, same token
streams, same window statistics, same padding counters. Split steps, mixed
steps, a pool tight enough to preempt (recompute, or swap to the host KV
tier), and the prefix cache with copy-on-write pages."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.configs.base import reduced
from repro.models import build_model
from repro.serving import HostKVTier as JTier
from repro.serving import PagedEngineConfig as JConfig
from repro.serving import PagedModelRunner as JRunner
from repro.serving import PagedRealEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.bridge import config_from_dict, params_from_numpy
from repro_torch.serving import HostKVTier as TTier
from repro_torch.serving import PagedEngineConfig as TConfig
from repro_torch.serving import PagedModelRunner as TRunner
from repro_torch.serving import PagedRealEngine as TEngine
from repro_torch.serving import Request as TRequest

RUNNER = dict(page_size=8, n_pages=64, max_blocks_per_req=8, max_batch=4,
              token_budget=16, chunk_buckets=(8, 16), lane_buckets=(1, 2, 4),
              max_prefill_lanes=4)


@pytest.fixture(scope="module")
def twin():
    cfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2,
                  dtype="float32")
    jp = build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    tp = params_from_numpy(jp, device="cpu")
    # one runner per package for the whole module: the reference's jit
    # caches are shared by every case
    jr = JRunner(cfg, jp, JConfig(**RUNNER, attn_backend="xla"), n_sources=2)
    tr = TRunner(tcfg, tp, TConfig(**RUNNER, device="cpu"), n_sources=2)
    return cfg, jp, jr, tcfg, tp, tr


def _requests(cls, vocab, shared_prefix, seed=0):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, 20).tolist() if shared_prefix else []
    out = []
    for i in range(6):
        n = int(rng.integers(3, 40 - len(system)))
        toks = system + rng.integers(0, vocab, n).tolist()
        out.append(cls(req_id=i, prompt_len=len(toks),
                       max_new_tokens=int(rng.integers(3, 8)),
                       arrival_time=0.001 * i, prompt_tokens=toks))
    return out


def _serve(engine_cls, cfg_cls, req_cls, tier_cls, cfg, params, runner,
           vocab, **ecfg_kw):
    ecfg = cfg_cls(**dict(RUNNER, **ecfg_kw))
    swap = ecfg.swap_policy == "swap"
    engines = [engine_cls(i, cfg, params, ecfg, runner=runner, n_sources=2,
                          tier=tier_cls() if swap else None)
               for i in range(2)]
    reqs = _requests(req_cls, vocab, ecfg.prefix_sharing)
    # under sharing, arrivals are staggered so that later requests find
    # the prefix registered; otherwise all arrive at once
    gap = 2 if ecfg.prefix_sharing else 0
    now, stats = 0.0, [[], []]
    for step in range(500):
        for i, r in enumerate(reqs):
            if i * gap == step:
                engines[i % 2].enqueue(r, now)
        if step >= gap * len(reqs) and not any(e.has_work for e in engines):
            break
        for i, e in enumerate(engines):
            e.step(now)
            stats[i].append(e.window_stats())
        now += 0.01
    assert not any(e.has_work for e in engines)
    for e in engines:
        e.pool.check_invariants()
    return engines, reqs, stats


@pytest.mark.parametrize("case", [
    dict(),                                   # split steps
    dict(mixed_steps=True),                   # fused mixed steps
    dict(n_pages=9),                          # tight pool: preempt+recompute
    dict(n_pages=9, swap_policy="swap"),      # tight pool: swap to host
    dict(prefix_sharing=True),                # radix prefix cache + COW
])
def test_engine_matches_reference(twin, case):
    cfg, jp, jr, tcfg, tp, tr = twin
    padded0 = (jr.padded_tokens_total, jr.padding_waste_tokens,
               tr.padded_tokens_total, tr.padding_waste_tokens)
    j_eng, j_reqs, j_stats = _serve(JEngine, JConfig, JRequest, JTier, cfg,
                                    jp, jr, cfg.vocab_size,
                                    attn_backend="xla", **case)
    t_eng, t_reqs, t_stats = _serve(TEngine, TConfig, TRequest, TTier, tcfg,
                                    tp, tr, cfg.vocab_size, device="cpu",
                                    **case)
    for je, te in zip(j_eng, t_eng):
        assert [r.req_id for r in te.finished] == \
            [r.req_id for r in je.finished]
        assert te.step_count == je.step_count
        assert te.total_prefill_tokens == je.total_prefill_tokens
        assert te.total_decode_tokens == je.total_decode_tokens
    for jr_, tr_ in zip(j_reqs, t_reqs):
        assert tr_.output_tokens == jr_.output_tokens, tr_.req_id
        assert tr_.n_preemptions == jr_.n_preemptions
        assert tr_.error == jr_.error
    for js, ts in zip(j_stats, t_stats):          # step by step, per engine
        assert len(js) == len(ts)
        for (jb, ja), (tb, ta) in zip(js, ts):
            assert (jb is None) == (tb is None)
            if jb is not None:
                np.testing.assert_array_equal(tb, jb)
                np.testing.assert_array_equal(ta, ja)
    assert (tr.padded_tokens_total - padded0[2],
            tr.padding_waste_tokens - padded0[3]) == \
        (jr.padded_tokens_total - padded0[0],
         jr.padding_waste_tokens - padded0[1])
    if case.get("n_pages") == 9:
        assert sum(r.n_preemptions for r in t_reqs) > 0
    if case.get("swap_policy") == "swap":
        out_pages = [e.tier.stat_out_pages for e in t_eng]
        assert sum(out_pages) > 0
        assert out_pages == [e.tier.stat_out_pages for e in j_eng]
        assert [e.tier.stat_in_pages for e in t_eng] == \
            [e.tier.stat_in_pages for e in j_eng]
    if case.get("prefix_sharing"):
        hits = [e.prefix_hit_tokens for e in t_eng]
        assert sum(hits) > 0
        assert hits == [e.prefix_hit_tokens for e in j_eng]
    trace = t_eng[0].trace(1.0)
    assert trace.n_running == 0 and trace.kv_usage == 0.0
