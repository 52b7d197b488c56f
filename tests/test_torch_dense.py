"""The port's dense-cache serving plane against the reference's, on a
float32 twin of the test model: ``prefill`` (a cache longer than the prompt,
and a ring shorter than it) and ``decode_step`` (wrapping the ring), then
``RealModelEngine`` and ``serve_real_cluster`` over two of them, in both MoE
dispatch modes (ragged, capacity-padded).

Logits and caches within 1e-5 (f32); MoE statistics, token streams,
Algorithm-1 decisions and migrations identical. The port's dense decode goes
through the flash-decode kernel's function (softmax weights kept in f32),
the reference's through ``flash_attention`` (weights cast to the KV dtype):
in bf16 the two agree within 3e-2. The entry points are compared in float32
only: in bf16 the reference's own top-k routing differs between its
op-by-op and its jitted run of one layer (XLA fuses the bf16 rounding
away), so a bf16 comparison would test near ties, not the port."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import reduced
from repro.core import PlacementConfig as JPlacement
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import transformer as jtfm
from repro.serving import RealClusterConfig as JCluster
from repro.serving import Request as JRequest
from repro.serving import serve_real_cluster as j_serve
from repro.serving.engine_util import pin_dispatch_mode
from repro.serving.real_engine import RealModelEngine as _JEngine
from repro_torch.bridge import config_from_dict, params_from_numpy
from repro_torch.core import PlacementConfig as TPlacement
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as t_build_model
from repro_torch.models import transformer as ttfm
from repro_torch.serving import RealClusterConfig as TCluster
from repro_torch.serving import RealModelEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import serve_real_cluster as t_serve

TOL = 1e-5


class JEngine(_JEngine):
    """The reference's engine with the two token counters that the
    reference's ``serve_real_cluster`` reads (its progress marker) and that
    this engine lacks: without them that cluster raises AttributeError
    before its first round. They count as the port's engine counts."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.total_prefill_tokens = 0
        self.total_decode_tokens = 0
        decode = self._decode

        def counted(*a):
            self.total_decode_tokens += len(self.req_of_slot)
            return decode(*a)

        self._decode = counted

    def _prefill_into_slot(self, req, slot, now):
        super()._prefill_into_slot(req, slot, now)
        self.total_prefill_tokens += req.prompt_len


@pytest.fixture(scope="module")
def twin():
    cfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2,
                  dtype="float32")
    jp = build_model(cfg).init(jax.random.PRNGKey(0))
    return (cfg, jp, config_from_dict(dataclasses.asdict(cfg)),
            params_from_numpy(jp, device="cpu"))


def _close(t, j, what):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=TOL, atol=TOL, err_msg=what)


def _same_stats(ts, js):
    for k in ("expert_counts", "source_expert"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)


def _same_cache(tc, jc):
    for name in jc:
        for leaf in ("k", "v"):
            _close(tc[name][leaf], jc[name][leaf], f"{name}/{leaf}")


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("S,L", [(10, 16),    # cache longer than the prompt
                                 (20, 16)])   # ring: the last 16 tokens kept
def test_dense_prefill_and_decode_match_reference(twin, ragged, S, L):
    cfg, jp, tcfg, tp = twin
    B = 2
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.array([S, S - 3], np.int32)
    src = np.array([0, 1], np.int32)
    kw = dict(source_ids=src, n_sources=2)
    jprefill = pin_dispatch_mode(jtfm.prefill, lambda: ragged)
    jdecode = pin_dispatch_mode(jtfm.decode_step, lambda: ragged)
    jl, jc, js = jprefill(
        jp, cfg, {"tokens": jnp.asarray(tokens),
                  "lengths": jnp.asarray(lengths)},
        jtfm.init_cache(cfg, B, L), source_ids=jnp.asarray(src), n_sources=2)
    tl, tc, ts = ttfm.prefill(
        tp, tcfg, {"tokens": torch.from_numpy(tokens),
                   "lengths": torch.from_numpy(lengths)},
        ttfm.init_cache(tcfg, B, L, device="cpu"),
        source_ids=torch.from_numpy(src), n_sources=2, ragged=ragged)
    _close(tl, jl, "prefill logits")
    _same_cache(tc, jc)
    _same_stats(ts, js)
    # decode past the end of the ring: positions S-3 .. S+L wrap around
    pos = lengths.copy()
    for step in range(L // 2 + 4):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc, js = jdecode(jp, cfg, jnp.asarray(nxt), jc, jnp.asarray(pos),
                             source_ids=jnp.asarray(src), n_sources=2)
        tl, tc, ts = ttfm.decode_step(
            tp, tcfg, torch.from_numpy(nxt), tc, torch.from_numpy(pos),
            source_ids=torch.from_numpy(src), n_sources=2, ragged=ragged)
        _close(tl, jl, f"decode logits, step {step}")
        _same_stats(ts, js)
        pos += 1
    assert pos.max() > L
    _same_cache(tc, jc)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, 3e-2)])
def test_decode_attention_matches_reference(dtype, tol):
    """The port's decode attention (the flash-decode function) against the
    reference's (its flash_attention) on a wrapped ring cache, without and
    with a sliding window."""
    rng = np.random.default_rng(1)
    B, Hq, Hkv, hd, L = 3, 8, 2, 32, 64
    q = jnp.asarray(rng.normal(size=(B, 1, Hq, hd)), dtype)
    kc = jnp.asarray(rng.normal(size=(B, L, Hkv, hd)), dtype)
    vc = jnp.asarray(rng.normal(size=(B, L, Hkv, hd)), dtype)
    write = jnp.asarray([5, L - 1, 3 * L + 7], jnp.int32)
    kpos = jattn.ring_positions(write, L)
    qpos = write[:, None]
    ref = jattn.decode_attention(q, kc, vc, q_pos=qpos, k_pos=kpos)
    tt = lambda a: params_from_numpy(np.asarray(a), device="cpu")
    out = tattn.decode_attention(tt(q), tt(kc), tt(vc), q_pos=tt(qpos),
                                 k_pos=tattn.ring_positions(tt(write), L))
    assert out.shape == (B, 1, Hq, hd) and out.dtype == tt(q).dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)
    # with a window of 16 slots, as the reference's decode_attention
    ref = jattn.decode_attention(q, kc, vc, q_pos=qpos, k_pos=kpos,
                                 window=16)
    out = tattn.decode_attention(tt(q), tt(kc), tt(vc), q_pos=tt(qpos),
                                 k_pos=tt(kpos), window=16)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_build_model_and_what_is_not_ported(twin):
    cfg, jp, tcfg, tp = twin
    fns = t_build_model(tcfg)
    params = fns.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["blocks"]["pos0"]["moe"]["w_gate"].shape == \
        tp["blocks"]["pos0"]["moe"]["w_gate"].shape
    cache = fns.init_cache(2, 8, device="cpu")
    assert cache["pos0"]["k"].shape == (2, 2, 8, cfg.n_kv_heads,
                                        cfg.head_dim)
    # the loss is the reference's (training is ported)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jm = build_model(cfg).loss(jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    tl, tm = fns.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    for t, j in ((tl, jl), (tm["ce"], jm["ce"]), (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(t), float(j), rtol=TOL, atol=TOL)
    # an int8 cache: int8 codes and f32 per-(slot, head) scales
    q8 = fns.init_cache(2, 8, kv_dtype="int8", device="cpu")["pos0"]
    assert {k: (tuple(v.shape), v.dtype) for k, v in q8.items()} == {
        "k": ((2, 2, 8, cfg.n_kv_heads, cfg.head_dim), torch.int8),
        "v": ((2, 2, 8, cfg.n_kv_heads, cfg.head_dim), torch.int8),
        "k_scale": ((2, 2, 8, cfg.n_kv_heads), torch.float32),
        "v_scale": ((2, 2, 8, cfg.n_kv_heads), torch.float32)}
    # the other families go where the reference sends them: xlstm for
    # "ssm" (a list of recurrent states), encdec for "encdec" (cross K/V)
    for family, kind, keys in (("ssm", list, None),
                               ("encdec", dict, {"k", "v", "xk", "xv"})):
        jc = build_model(dataclasses.replace(cfg, family=family)) \
            .init_cache(2, 8)
        tc = t_build_model(dataclasses.replace(tcfg, family=family)) \
            .init_cache(2, 8, device="cpu")
        assert type(jc) is type(tc) is kind
        assert len(tc) == len(jc)
        if keys:
            assert set(tc) == set(jc) == keys
    for build, c in ((build_model, cfg), (t_build_model, tcfg)):
        with pytest.raises(ValueError, match="unknown family"):
            build(dataclasses.replace(c, family="rnn"))


# prompt lengths drawn from a few values: the reference's engine compiles
# its prefill once per prompt length
LENGTHS = (6, 11, 17)


def _requests(cls, vocab, n, gap, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.choice(LENGTHS))
        out.append(cls(req_id=i, prompt_len=plen,
                       max_new_tokens=int(rng.integers(3, 7)),
                       arrival_time=gap * i,
                       prompt_tokens=rng.integers(0, vocab, plen).tolist()))
    return out


@pytest.mark.parametrize("ragged", [True, False])
def test_real_engine_matches_reference(twin, ragged):
    cfg, jp, tcfg, tp = twin
    engines = (JEngine(0, cfg, jp, max_slots=4, max_len=32,
                       ragged_dispatch=ragged),
               TEngine(0, tcfg, tp, max_slots=4, max_len=32,
                       ragged_dispatch=ragged, device="cpu"))
    runs = []
    for e, cls in zip(engines, (JRequest, TRequest)):
        reqs = _requests(cls, cfg.vocab_size, n=6, gap=0.0)
        for r in reqs:
            e.enqueue(r, 0.0)
        stats, finished, now = [], [], 0.0
        while e.has_work:
            finished += [r.req_id for r in e.step(now) or []]
            stats.append(e.window_stats())
            now += 0.01
            assert len(stats) < 200
        runs.append((reqs, stats, finished, e.trace(now)))
    (jreqs, jstats, jfin, jtr), (treqs, tstats, tfin, ttr) = runs
    assert tfin == jfin
    for jr, tr in zip(jreqs, treqs):
        assert tr.output_tokens == jr.output_tokens, tr.req_id
        assert (tr.first_token_time, tr.finish_time) == \
            (jr.first_token_time, jr.finish_time)
    assert len(tstats) == len(jstats)
    for (jb, ja), (tb, ta) in zip(jstats, tstats):
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(ta, ja)
    assert (ttr.kv_usage, ttr.n_running, ttr.n_waiting) == \
        (jtr.kv_usage, jtr.n_running, jtr.n_waiting)
    je, te = engines
    assert te.step_count == je.step_count
    assert (te.total_prefill_tokens, te.total_decode_tokens) == \
        (sum(r.prompt_len for r in treqs),
         sum(len(r.output_tokens) - 1 for r in treqs))
    # every slot decodes and, with no token mask, counts in B: idle ones too
    K, E = cfg.moe.top_k, cfg.moe.n_experts
    decode_B = sum(int(b.sum()) for b, _ in tstats) \
        - sum(r.prompt_len for r in treqs) * K * cfg.n_moe_layers
    assert decode_B == te.step_count * te.max_slots * K * cfg.n_moe_layers


def _plain(x):
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return _plain(x.tolist())
    if isinstance(x, np.generic):
        return _plain(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


@pytest.mark.parametrize("ragged,migrate", [(True, False), (False, True)])
def test_cluster_over_dense_engines_matches_reference(twin, ragged, migrate):
    cfg, jp, tcfg, tp = twin
    runs = []
    for eng, req, clus, serve, plc, params, mcfg, kw in (
            (JEngine, JRequest, JCluster, j_serve, JPlacement, jp, cfg, {}),
            (TEngine, TRequest, TCluster, t_serve, TPlacement, tp, tcfg,
             dict(device="cpu"))):
        engines = [eng(i, mcfg, params, max_slots=4, max_len=32,
                       ragged_dispatch=ragged, **kw) for i in range(2)]
        reqs = _requests(req, cfg.vocab_size, n=8, gap=0.1, seed=5)
        ccfg = clus(window_tokens=48, placement_cfg=plc.uncalibrated()) \
            if migrate else clus(window_tokens=200)
        res = serve(reqs, engines, cluster_cfg=ccfg)
        runs.append((res, reqs))
    (jres, jreqs), (tres, treqs) = runs
    for jr, tr in zip(jreqs, treqs):
        assert tr.full_output_tokens == jr.full_output_tokens, tr.req_id
        assert (tr.engine_id, tr.error, tr.first_token_time,
                tr.finish_time) == (jr.engine_id, jr.error,
                                    jr.first_token_time, jr.finish_time)
    assert tres.duration_s == jres.duration_s
    assert _plain(tres.signals) == _plain(jres.signals)
    sig = tres.signals
    assert sig["unfinished"] == 0 and not sig["errors"]
    assert min(sig["per_engine"].values()) > 0
    if migrate:
        assert sig["migrations"] > 0 and sig["expert_moves"] > 0
