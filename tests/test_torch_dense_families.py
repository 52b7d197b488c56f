"""The dense families (qwen3-8b, qwen1.5-32b, gemma2-2b, gemma3-12b) in the
port against the reference, on float32 twins of their smoke configs with
the JAX init converted leaf by leaf: parameter trees, ``prefill`` and
``decode_step`` (gemma's local layers keep a 16-slot ring that the prompts
overflow and decode wraps; softcaps, qk-norm, qkv bias and post norms on),
int8 dense caches, decode attention with a window, a softcap and int8
scales, the dense engine and ``serve_real_cluster`` over dense and paged
engines, and the paged pool's refusal of windows and softcaps.

Float32 logits and caches within 1e-5. An int8 cache differs from the
reference's in one known way: the port's decode keeps the softmax weights
in f32 where the reference casts them to bf16 (ROADMAP.md Queue C, "Dense
decode in bf16"), so int8 logits are held at the bf16 bar, 3e-2, and the
codes written after a decode step to the 1/127 rule of
``tests/test_torch_kv_pack.py`` (exact where the scales agree, within one
elsewhere)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config
from repro.configs.base import reduced
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import transformer as jtfm
from repro.serving import PagedEngineConfig as JPaged
from repro.serving import PagedModelRunner as JRunner
from repro.serving import PagedRealEngine as JPagedEngine
from repro.serving import RealClusterConfig as JCluster
from repro.serving import Request as JRequest
from repro.serving import serve_real_cluster as j_serve
from repro.serving.real_engine import RealModelEngine as _JEngine
from repro_torch.bridge import config_from_dict, params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as t_build_model
from repro_torch.models import transformer as ttfm
from repro_torch.serving import PagedEngineConfig as TPaged
from repro_torch.serving import PagedModelRunner as TRunner
from repro_torch.serving import PagedRealEngine as TPagedEngine
from repro_torch.serving import RealClusterConfig as TCluster
from repro_torch.serving import RealModelEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import serve_real_cluster as t_serve

TOL = 1e-5
BF16_TOL = 3e-2
ARCHS = ("qwen3-8b", "qwen1.5-32b", "gemma2-2b", "gemma3-12b")


class JEngine(_JEngine):
    """The reference's engine with the two token counters that the
    reference's ``serve_real_cluster`` reads and that this engine lacks (as
    in ``tests/test_torch_dense.py``)."""

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


_TWINS = {}


def twin(arch, dtype="float32"):
    """(reference cfg, reference params, port cfg, port params on the
    CPU) of the arch's smoke config in ``dtype``, one per module run."""
    if (arch, dtype) not in _TWINS:
        cfg = reduced(get_smoke_config(arch), dtype=dtype)
        jp = build_model(cfg).init(jax.random.PRNGKey(0))
        _TWINS[arch, dtype] = (cfg, jp,
                               config_from_dict(dataclasses.asdict(cfg)),
                               params_from_numpy(jp, device="cpu"))
    return _TWINS[arch, dtype]


def _close(t, j, what, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_params_match_reference(arch):
    """The copied config equals the reference's; ``init`` gives the
    reference's tree: the same leaves, shapes and dtypes (local layers and
    the post norms included)."""
    assert dataclasses.asdict(t_get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    cfg, jp, tcfg, _ = twin(arch)
    tp = t_build_model(tcfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    ts = {k: (s, d.replace("torch.", "")) for k, (s, d) in
          _shapes(tp).items()}
    assert ts == _shapes(jp)
    if cfg.post_norms:
        assert "post_ffn_norm" in tp["blocks"]["pos0"]


def _prompt(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return tokens, np.array([S, S - 5], np.int32)[:B]


def _run_both(arch, kv_dtype, B=2, S=24, L=40, steps=12, dtype="float32"):
    """prefill of (B, S) prompts into a (B, L) cache, then ``steps``
    decode steps, in both packages: yields (what, port logits, reference
    logits, port cache, reference cache) after each call."""
    cfg, jp, tcfg, tp = twin(arch, dtype)
    tokens, lengths = _prompt(cfg, B, S, seed=3)
    jl, jc, _ = jtfm.prefill(
        jp, cfg, {"tokens": jnp.asarray(tokens),
                  "lengths": jnp.asarray(lengths)},
        jtfm.init_cache(cfg, B, L, kv_dtype=kv_dtype))
    tl, tc, _ = ttfm.prefill(
        tp, tcfg, {"tokens": torch.from_numpy(tokens),
                   "lengths": torch.from_numpy(lengths)},
        ttfm.init_cache(tcfg, B, L, kv_dtype=kv_dtype, device="cpu"))
    yield "prefill", tl, jl, tc, jc
    pos = lengths.copy()
    for step in range(steps):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc, _ = jtfm.decode_step(jp, cfg, jnp.asarray(nxt), jc,
                                     jnp.asarray(pos))
        tl, tc, _ = ttfm.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                     torch.from_numpy(pos))
        pos += 1
        yield f"decode step {step}", tl, jl, tc, jc


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Logits after prefill and after every decode step, and every cache
    leaf at the end, within 1e-5. The gemmas' local layers hold a 16-slot
    ring: the 24-token prompt takes the ring branch of prefill, and decode
    runs to position 35, past the ring's next wrap at 32."""
    cfg = twin(arch)[0]
    if cfg.sliding_window:
        assert cfg.sliding_window == 16 and cfg.local_global_ratio > 0
    assert cfg.attn_logit_softcap or cfg.qk_norm or cfg.qkv_bias
    for what, tl, jl, tc, jc in _run_both(arch, "bfloat16"):
        _close(tl, jl, f"{arch}: {what} logits")
    for name in jc:
        assert set(tc[name]) == set(jc[name]) == {"k", "v"}
        for leaf in jc[name]:
            _close(tc[name][leaf], jc[name][leaf], f"{name}/{leaf}")
    ring = [tc[n]["k"].shape[2] for n in tc]
    assert (min(ring) == 16) == bool(cfg.sliding_window)


def _codes_match(tq, jq, ts, js, what):
    """The 1/127 rule: codes exact where the scales agree, within one
    elsewhere; scales within the bf16 bar (the rows they quantize come from
    decode steps whose softmax weights differ by that rounding)."""
    tq, jq = tq.numpy().astype(np.int32), np.asarray(jq).astype(np.int32)
    ts, js = ts.numpy(), np.asarray(js)
    same = ts == js
    assert np.array_equal(tq[same], jq[same]), what
    assert np.abs(tq - jq).max() <= 1, what
    np.testing.assert_allclose(ts, js, rtol=BF16_TOL, atol=1e-7,
                               err_msg=what)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "gemma2-2b",
                                  "llava-next-34b", "hymba-1.5b"])
def test_int8_dense_cache_matches_reference(arch):
    """int8 dense caches on the float32 twins: the first layers' codes
    after prefill and every code at the end by the 1/127 rule; every logit
    within the bf16 bar. The caches' leaves, dtypes and shapes are the
    reference's. hymba's mamba state beside the int8 ring (``mamba_h``,
    ``mamba_conv``, f32) is held to the bf16 bar too: the reference rounds
    its int8 decode's weights to bf16 (ROADMAP.md, "Dense decode in
    bf16"), and the state carries that rounding on."""
    for what, tl, jl, tc, jc in _run_both(arch, "int8"):
        _close(tl, jl, f"{arch} int8: {what} logits", tol=BF16_TOL)
        if what == "prefill":
            for leaf in ("k", "v"):
                c = tc["pos0"]
                _codes_match(c[leaf], jc["pos0"][leaf], c[leaf + "_scale"],
                             jc["pos0"][leaf + "_scale"], f"prefill {leaf}")
    for name in jc:
        c = tc[name]
        assert {k: (tuple(v.shape), v.dtype) for k, v in c.items()} == {
            k: (tuple(v.shape), torch.int8 if v.dtype == jnp.int8
                else torch.float32) for k, v in jc[name].items()}
        for leaf in ("k", "v"):
            _codes_match(c[leaf], jc[name][leaf], c[leaf + "_scale"],
                         jc[name][leaf + "_scale"], f"{name}/{leaf}")
        for leaf in ("mamba_h", "mamba_conv"):
            if leaf in jc[name]:
                _close(c[leaf], jc[name][leaf], f"{name}/{leaf}",
                       tol=BF16_TOL)


def test_int8_against_bf16_meets_reference_bar():
    """The reference's own bar (``tests/test_models.py``,
    ``test_int8_kv_cache_close_to_bf16``) on the port's bf16 qwen1.5 smoke
    model: prefill, then one decode step, with a bf16 and an int8 cache:
    max |int8 - bf16| < 0.05 * max|bf16| + 0.05."""
    _, _, tcfg, tp = twin("qwen1.5-32b", dtype="bfloat16")
    B, S = 2, 16
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, S))
                            .astype(np.int32))
    fns = t_build_model(tcfg)
    outs = {}
    for kvd in ("bfloat16", "int8"):
        cache = fns.init_cache(B, 40, kv_dtype=kvd, device="cpu")
        _, cache, _ = fns.prefill(
            tp, {"tokens": toks[:, :S - 1],
                 "lengths": torch.full((B,), S - 1, dtype=torch.int32)},
            cache)
        lg, _, _ = fns.decode(tp, toks[:, S - 1], cache,
                              torch.full((B,), S - 1, dtype=torch.int32))
        outs[kvd] = lg.float().numpy()
    scale = np.abs(outs["bfloat16"]).max()
    assert np.abs(outs["int8"] - outs["bfloat16"]).max() < 0.05 * scale + 0.05


@pytest.mark.parametrize("window,cap,int8", [(16, 0.0, False),
                                             (0, 50.0, False),
                                             (16, 30.0, False),
                                             (0, 0.0, True),
                                             (16, 50.0, True)])
def test_decode_attention_window_softcap_scales(window, cap, int8):
    """The port's decode attention (the flash-decode function) against the
    reference's ``decode_attention`` with a window, a softcap and int8
    scales, on a 64-slot cache longer than the 16-slot window, rows at
    assorted positions (one wrapped past the ring's end). f32 without int8
    within 1e-5; int8 within the bf16 bar."""
    rng = np.random.default_rng(2)
    B, Hq, Hkv, hd, L = 3, 8, 2, 32, 64
    q = rng.normal(size=(B, 1, Hq, hd)).astype(np.float32)
    kc = rng.normal(size=(B, L, Hkv, hd)).astype(np.float32) * 3
    vc = rng.normal(size=(B, L, Hkv, hd)).astype(np.float32)
    write = np.array([5, L - 1, 3 * L + 7], np.int32)
    kw = {}
    jkw = {}
    if int8:
        kq, ks = (np.array(a) for a in jtfm._quantize_kv(jnp.asarray(kc)))
        vq, vs = (np.array(a) for a in jtfm._quantize_kv(jnp.asarray(vc)))
        kc, vc = kq, vq
        jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        kw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    jw = jnp.asarray(write)
    ref = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), q_pos=jw[:, None],
        k_pos=jattn.ring_positions(jw, L), window=window, softcap_val=cap,
        **jkw)
    tw = torch.from_numpy(write)
    out = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        q_pos=tw[:, None], k_pos=tattn.ring_positions(tw, L), window=window,
        softcap_val=cap, **kw)
    assert out.shape == (B, 1, Hq, hd) and out.dtype == torch.float32
    tol = BF16_TOL if int8 else TOL
    _close(out, ref, f"window={window} cap={cap} int8={int8}", tol=tol)
    if window:       # the window really masks: without it the output moves
        full = tattn.decode_attention(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            q_pos=tw[:, None], k_pos=tattn.ring_positions(tw, L),
            softcap_val=cap, **kw)
        assert float((full - out).abs().max()) > 1e-2


# prompt lengths drawn from a few values: the reference's engine compiles
# its prefill once per prompt length; 21 and 27 overflow the twins' 16-slot
# local rings
LENGTHS = (6, 21, 27)


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


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-12b"])
def test_real_engine_matches_reference(arch):
    """One dense engine per package, six requests: the same finish order,
    token streams and times, the same traces; no MoE statistics."""
    cfg, jp, tcfg, tp = twin(arch)
    engines = (JEngine(0, cfg, jp, max_slots=4, max_len=48),
               TEngine(0, tcfg, tp, max_slots=4, max_len=48, device="cpu"))
    runs = []
    for e, cls in zip(engines, (JRequest, TRequest)):
        reqs = _requests(cls, cfg.vocab_size, n=6, gap=0.0)
        for r in reqs:
            e.enqueue(r, 0.0)
        finished, traces, now = [], [], 0.0
        while e.has_work:
            finished += [r.req_id for r in e.step(now) or []]
            t = e.trace(now)
            traces.append((t.kv_usage, t.n_running, t.n_waiting))
            assert e.window_stats() == (None, None)
            now += 0.01
            assert len(traces) < 200
        runs.append((reqs, finished, traces))
    (jreqs, jfin, jtr), (treqs, tfin, ttr) = runs
    assert tfin == jfin and ttr == jtr
    for jr, tr in zip(jreqs, treqs):
        assert tr.output_tokens == jr.output_tokens, tr.req_id
        assert (tr.first_token_time, tr.finish_time) == \
            (jr.first_token_time, jr.finish_time)
    assert engines[1].step_count == engines[0].step_count


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


def _same_serve(jres, jreqs, tres, treqs):
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
    # no experts: no placement, no migration, only Algorithm-1 decisions
    assert sig["migrations"] == 0 and sig["expert_moves"] == 0
    assert sum(sig["decisions"].values()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cluster_over_dense_engines_matches_reference(arch):
    """``serve_real_cluster`` over two dense engines per package, eight
    requests arriving over time: identical streams, Algorithm-1 decisions
    and signals. The models have no experts, so the cluster builds no
    coordinator and the migrator moves nothing."""
    cfg, jp, tcfg, tp = twin(arch)
    runs = []
    for eng, req, clus, serve, params, mcfg, kw in (
            (JEngine, JRequest, JCluster, j_serve, jp, cfg, {}),
            (TEngine, TRequest, TCluster, t_serve, tp, tcfg,
             dict(device="cpu"))):
        engines = [eng(i, mcfg, params, max_slots=4, max_len=48, **kw)
                   for i in range(2)]
        reqs = _requests(req, cfg.vocab_size, n=8, gap=0.1, seed=5)
        res = serve(reqs, engines, cluster_cfg=clus(window_tokens=200))
        runs.append((res, reqs))
    (jres, jreqs), (tres, treqs) = runs
    _same_serve(jres, jreqs, tres, treqs)


RUNNER = dict(page_size=8, n_pages=48, max_blocks_per_req=8, max_batch=4,
              token_budget=16, chunk_buckets=(8, 16))


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen1.5-32b"])
def test_cluster_over_paged_engines_matches_reference(arch, kv_dtype):
    """``serve_real_cluster`` over two paged engines on one runner per
    package, on fp and on int8 pages (qwen3-8b: 4 query heads per KV head;
    qwen1.5: multi-head, G = 1): identical streams, decisions, signals."""
    cfg, jp, tcfg, tp = twin(arch)
    runs = []
    for ecls, rcls, engcls, req, clus, serve, params, mcfg, kw in (
            (JPaged, JRunner, JPagedEngine, JRequest, JCluster, j_serve, jp,
             cfg, dict(attn_backend="xla")),
            (TPaged, TRunner, TPagedEngine, TRequest, TCluster, t_serve, tp,
             tcfg, dict(device="cpu"))):
        ecfg = ecls(**RUNNER, kv_dtype=kv_dtype, **kw)
        runner = rcls(mcfg, params, ecfg, n_sources=2)
        engines = [engcls(i, mcfg, params, ecfg, runner=runner, n_sources=2)
                   for i in range(2)]
        reqs = _requests(req, cfg.vocab_size, n=8, gap=0.1, seed=5)
        res = serve(reqs, engines, cluster_cfg=clus(window_tokens=200))
        for e in engines:
            e.pool.check_invariants()
        runs.append((res, reqs))
    (jres, jreqs), (tres, treqs) = runs
    _same_serve(jres, jreqs, tres, treqs)


@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma3-12b"])
def test_gemmas_refuse_a_paged_pool(arch):
    """Windows and softcaps stay on the dense plane: both packages refuse a
    paged pool for the gemmas, with the same message."""
    cfg, _, tcfg, _ = twin(arch)
    with pytest.raises(NotImplementedError) as jerr:
        jtfm.init_paged_cache(cfg, 8, 8)
    with pytest.raises(NotImplementedError) as terr:
        ttfm.init_paged_cache(tcfg, 8, 8, device="cpu")
    assert str(terr.value) == str(jerr.value)
