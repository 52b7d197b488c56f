"""The four other families (llava-next-34b, hymba-1.5b, xlstm-125m,
seamless-m4t-large-v2) in the port against the reference, on float32 twins
of their smoke configs with the JAX init converted leaf by leaf through
``bridge`` (lists kept as lists): configs and parameter trees, the
recurrent blocks of ``models/ssm.py`` (mamba, mLSTM, sLSTM) with and
without a carried state over lengths that are not a multiple of the chunk,
``prefill`` then ``decode_step`` with their caches or states (llava from
embeddings and from tokens, hymba's 16-slot ring wrapping across its
8-token chunks, xlstm across its 16-token chunks, seamless with encoder
lengths shorter than the cross cache), ``serve_real_cluster`` over two
dense engines for llava, hymba and xlstm (xlstm's prefilled state is not
spliced into its slot, in both packages), and the paged plane's refusals.

Float32 within 1e-5; the blocks in bfloat16 within 3e-2."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config
from repro.configs import list_archs as j_list_archs
from repro.configs.base import reduced
from repro.models import build_model
from repro.models import encdec as jencdec
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.serving import PagedEngineConfig as JPaged
from repro.serving import PagedModelRunner as JRunner
from repro.serving import RealClusterConfig as JCluster
from repro.serving import Request as JRequest
from repro.serving import serve_real_cluster as j_serve
from repro.serving.real_engine import RealModelEngine as _JEngine
from repro_torch.bridge import (config_from_dict, params_from_numpy,
                                tree_leaves, tree_map)
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_archs as t_list_archs
from repro_torch.models import build_model as t_build_model
from repro_torch.models import encdec as tencdec
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.models import xlstm as txlstm
from repro_torch.serving import PagedEngineConfig as TPaged
from repro_torch.serving import PagedModelRunner as TRunner
from repro_torch.serving import RealClusterConfig as TCluster
from repro_torch.serving import RealModelEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import serve_real_cluster as t_serve
from repro_torch.serving.real_cluster import ExpertMigrator

TOL = 1e-5
BF16_TOL = 3e-2
ARCHS = ("llava-next-34b", "hymba-1.5b", "xlstm-125m",
         "seamless-m4t-large-v2")
SERVED = ARCHS[:3]


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


def twin(arch):
    """(reference cfg, reference params, port cfg, port params on the CPU)
    of the arch's float32 smoke config, one per module run."""
    if arch not in _TWINS:
        cfg = reduced(get_smoke_config(arch), dtype="float32")
        jp = build_model(cfg).init(jax.random.PRNGKey(0))
        _TWINS[arch] = (cfg, jp, config_from_dict(dataclasses.asdict(cfg)),
                        params_from_numpy(jp, device="cpu"))
    return _TWINS[arch]


def _close(t, j, what, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _flat(tree, prefix=""):
    """{path: leaf} of a nesting of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _layout(tree):
    """{path: (shape, dtype)}, the port's dtypes named as numpy's."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _flat(tree).items()}


def _close_trees(t, j, what, tol=TOL):
    tf, jf = _flat(t), _flat(jax.tree.map(np.asarray, j))
    assert tf.keys() == jf.keys(), what
    for path, a in tf.items():
        assert tuple(a.shape) == jf[path].shape, (what, path)
        _close(a, jf[path], f"{what}: {path}", tol)


def test_registry_lists_every_arch_in_reference_order():
    assert t_list_archs() == j_list_archs()
    assert len(t_list_archs()) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_params_match_reference(arch):
    """The copied config equals the reference's; ``init`` gives the
    reference's tree (the same nesting of dicts and lists, leaves, shapes
    and dtypes), and the bridge keeps that nesting both ways."""
    assert dataclasses.asdict(t_get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    cfg, jp, tcfg, tp_conv = twin(arch)
    tp = t_build_model(tcfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    assert _layout(tp) == _layout(jax.tree.map(np.asarray, jp))
    assert _layout(tp_conv) == _layout(tp)
    if cfg.family == "ssm":
        assert isinstance(tp_conv["blocks"], list)
        assert isinstance(tp_conv["block_norms"], list)
    if cfg.family == "encdec":   # the vmap-stacked layers stay stacked
        assert tp["enc"]["attn"]["wq"].shape[0] == cfg.enc_layers
        assert tp["dec"]["cross"]["wk"].shape[0] == cfg.dec_layers


# ---------------------------------------------------------------- ssm.py
def _tree_j(t):
    return jax.tree.map(jnp.asarray, t)


def _block_case(kind, dtype, carried, S):
    """(reference output and state, port output and state) of one block on
    the same input, from a carried state or from zeros."""
    rng = np.random.default_rng(11)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    D, H, N, W, chunk = 32, 4, 4, 4, 8
    key = jax.random.PRNGKey(5)
    if kind == "mamba":
        jp = jssm.init_mamba(key, D, N, W, 2, jdt)
        jfn = lambda x, st: jssm.mamba_block(  # noqa: E731
            jp, x, N, W, state=st, chunk=chunk, return_state=True)
        tfn = lambda p, x, st: tssm.mamba_block(  # noqa: E731
            p, x, N, W, state=st, chunk=chunk, return_state=True)
    elif kind == "mlstm":
        jp = jssm.init_mlstm(key, D, H, jdt)
        jfn = lambda x, st: jssm.mlstm_block(  # noqa: E731
            jp, x, H, state=st, chunk=chunk, return_state=True)
        tfn = lambda p, x, st: tssm.mlstm_block(  # noqa: E731
            p, x, H, state=st, chunk=chunk, return_state=True)
    else:
        jp = jssm.init_slstm(key, D, H, jdt)
        jfn = lambda x, st: jssm.slstm_block(  # noqa: E731
            jp, x, H, state=st, return_state=True)
        tfn = lambda p, x, st: tssm.slstm_block(  # noqa: E731
            p, x, H, state=st, return_state=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jfn = jax.jit(jfn)
    jst = tst = None
    if carried:      # the state after a 11-token prefix
        pre = rng.normal(size=(2, 11, D)).astype(np.float32)
        _, jst = jfn(jnp.asarray(pre, jdt), None)
        _, tst = tfn(tp, torch.from_numpy(pre).to(tdt), None)
        _close_trees(tst, jst, f"{kind} prefix state",
                     TOL if dtype == "float32" else BF16_TOL)
        tst = params_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    x = rng.normal(size=(2, S, D)).astype(np.float32)
    return jfn(jnp.asarray(x, jdt), jst), tfn(tp, torch.from_numpy(x).to(tdt),
                                              tst)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,S", [("mamba", 13), ("mamba", 1),
                                    ("mlstm", 21), ("mlstm", 1),
                                    ("slstm", 9)])
def test_ssm_blocks_match_reference(kind, S, dtype, carried):
    """Each block's output and final state against the reference's: S = 13
    and 21 are not multiples of the 8-token chunk (mLSTM pads its last
    chunk; mamba's scan is one recurrence), S = 1 is ``mlstm_step`` and
    mamba's decode step. 1e-5 in float32, 3e-2 in bfloat16."""
    (jo, js), (to, ts) = _block_case(kind, dtype, carried, S)
    tol = TOL if dtype == "float32" else BF16_TOL
    assert to.dtype == (torch.float32 if dtype == "float32"
                        else torch.bfloat16)
    _close(to, jo, f"{kind} output", tol)
    _close_trees(ts, js, f"{kind} state", tol)


# ---------------------------------------------------------------- models
def _prompt(cfg, B, S, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _entry_points(arch, batch_np, B, S, L, steps, decode_kw=None):
    """prefill then ``steps`` decode steps in both packages, greedy on the
    reference's logits: yields (what, port logits, reference logits, port
    cache, reference cache)."""
    cfg, jp, tcfg, tp = twin(arch)
    jfns, tfns = build_model(cfg), t_build_model(tcfg)
    jprefill, jdecode = jax.jit(jfns.prefill), jax.jit(jfns.decode)
    jl, jc, _ = jprefill(jp, {k: jnp.asarray(v) for k, v in
                              batch_np.items()}, jfns.init_cache(B, L))
    tl, tc, _ = tfns.prefill(tp, {k: torch.from_numpy(v) for k, v in
                                  batch_np.items()},
                             tfns.init_cache(B, L, device="cpu"))
    yield "prefill", tl, jl, tc, jc
    pos = batch_np.get("lengths", np.full(B, S, np.int32)).copy()
    dkw = decode_kw or {}
    for step in range(steps):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc, _ = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(pos),
                            **{k: jnp.asarray(v) for k, v in dkw.items()})
        tl, tc, _ = tfns.decode(tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(pos),
                                **{k: torch.from_numpy(v)
                                   for k, v in dkw.items()})
        pos += 1
        yield f"decode step {step}", tl, jl, tc, jc


def _check(arch, gen):
    for what, tl, jl, tc, jc in gen:
        _close(tl, jl, f"{arch}: {what} logits")
    _close_trees(tc, jc, f"{arch}: cache")
    return tc


@pytest.mark.parametrize("source", ["embeddings", "tokens"])
def test_llava_entry_points_match_reference(source):
    """llava prefills from stand-in patch embeddings (the VLM input) or
    from tokens, then decodes tokens: logits at every step and the KV cache
    within 1e-5."""
    cfg = twin("llava-next-34b")[0]
    assert cfg.input_mode == "embeddings"
    B, S = 2, 20
    rng = np.random.default_rng(1)
    batch = {"lengths": np.array([S, S - 4], np.int32)}
    if source == "embeddings":
        batch["embeddings"] = rng.normal(size=(B, S, cfg.d_model)) \
            .astype(np.float32)
    else:
        batch["tokens"] = _prompt(cfg, B, S)
    _check("llava", _entry_points("llava-next-34b", batch, B, S, 40, 6))


def test_hymba_entry_points_match_reference():
    """hymba: 27-token prompts (past the 16-slot ring of its local layers
    and across three of its 8-token chunks) then 10 decode steps that wrap
    the ring again; logits, KV rings and mamba states within 1e-5, the
    global layer's cache (one of three) at the full 48 slots."""
    cfg = twin("hymba-1.5b")[0]
    assert (cfg.sliding_window, cfg.ssm.chunk_size) == (16, 8)
    B, S = 2, 27
    batch = {"tokens": _prompt(cfg, B, S),
             "lengths": np.array([S, S - 6], np.int32)}
    tc = _check("hymba", _entry_points("hymba-1.5b", batch, B, S, 48, 10))
    assert sorted(c["k"].shape[2] for c in tc.values()) == [16, 16, 48]
    assert all(float(c["mamba_h"].abs().max()) > 0 for c in tc.values())


def test_xlstm_entry_points_match_reference():
    """xlstm: 37-token prompts (two full 16-token chunks and a padded
    third) then 8 decode steps; logits and every block's state within
    1e-5."""
    cfg = twin("xlstm-125m")[0]
    B, S = 2, 37
    batch = {"tokens": _prompt(cfg, B, S),
             "lengths": np.array([S, S - 3], np.int32)}
    tc = _check("xlstm", _entry_points("xlstm-125m", batch, B, S, 0, 8))
    assert isinstance(tc, list) and len(tc) == cfg.n_layers


def test_seamless_entry_points_match_reference():
    """seamless: 12 stand-in frames into a 24-slot cross cache, a 7-token
    decoder prompt, then 6 decode steps with ``enc_lengths`` (10 and 12)
    masking the cross slots never written; logits and the four caches
    within 1e-5. Without ``enc_lengths`` the unwritten slots are attended,
    as in the reference, and the logits move."""
    cfg, jp, tcfg, tp = twin("seamless-m4t-large-v2")
    rng = np.random.default_rng(2)
    B, S, S_src, L = 2, 7, 12, 24
    batch = {"embeddings": rng.normal(size=(B, S_src, cfg.d_model))
             .astype(np.float32),
             "tokens": _prompt(cfg, B, S),
             "lengths": np.array([S, S], np.int32)}
    enc_lengths = np.array([10, 12], np.int32)
    tc = _check("seamless", _entry_points(
        "seamless-m4t-large-v2", batch, B, S, L, 6,
        decode_kw={"enc_lengths": enc_lengths}))
    assert set(tc) == {"k", "v", "xk", "xv"}
    tok = torch.zeros(B, dtype=torch.int32)
    pos = torch.full((B,), S + 6, dtype=torch.int32)
    masked = tencdec.decode_step(tp, tcfg, tok, tree_map(torch.clone, tc),
                                 pos, enc_lengths=torch.from_numpy(
                                     enc_lengths))[0]
    whole = tencdec.decode_step(tp, tcfg, tok, tree_map(torch.clone, tc),
                                pos)[0]
    jwhole = jencdec.decode_step(jp, cfg, jnp.zeros(B, jnp.int32), _tree_j(
        tree_map(lambda t: t.numpy(), tc)), jnp.asarray(pos.numpy()))[0]
    _close(whole, jwhole, "seamless without enc_lengths")
    assert float((whole - masked).abs().max()) > 1e-4


def test_entry_points_keep_prefill_decode_consistency():
    """On the port alone: one decode after a prefill of S - 1 tokens gives
    the logits of a prefill of S tokens, for hymba (the mamba state and the
    ring across the boundary) and xlstm (S - 1 = 20 pads its last chunk;
    the step and chunk forms differ by rounding)."""
    for arch, S in (("hymba-1.5b", 21), ("xlstm-125m", 21)):
        _, _, tcfg, tp = twin(arch)
        fns = t_build_model(tcfg)
        toks = torch.from_numpy(_prompt(tcfg, 2, S))
        full, _, _ = fns.prefill(tp, {"tokens": toks},
                                 fns.init_cache(2, 32, device="cpu"))
        _, cache, _ = fns.prefill(tp, {"tokens": toks[:, :S - 1]},
                                  fns.init_cache(2, 32, device="cpu"))
        lg, _, _ = fns.decode(tp, toks[:, S - 1], cache,
                              torch.full((2,), S - 1, dtype=torch.int32))
        _close(lg, full.numpy(), f"{arch}: decode vs prefill", 1e-4)


def test_build_model_picks_the_reference_family_module():
    """``build_model`` sends each family where the reference's does (the
    caches show it: a list of states for ``ssm``, cross K/V for
    ``encdec``, mamba state for ``hybrid``), and both raise ``ValueError``
    for an unknown family."""
    for arch in ARCHS:
        cfg, _, tcfg, _ = twin(arch)
        jc = build_model(cfg).init_cache(2, 8)
        tc = t_build_model(tcfg).init_cache(2, 8, device="cpu")
        assert _layout(tc) == _layout(jax.tree.map(np.asarray, jc)), arch
    for mod in (build_model, t_build_model):
        with pytest.raises(ValueError, match="unknown family"):
            mod(dataclasses.replace(twin("xlstm-125m")[2], family="rnn"))


# ---------------------------------------------------------------- serving
LENGTHS = (6, 21, 27)


def _requests(cls, vocab, n, gap, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.choice(LENGTHS))
        out.append(cls(req_id=i, prompt_len=plen,
                       max_new_tokens=int(rng.integers(3, 7)),
                       arrival_time=gap * i,
                       prompt_tokens=rng.integers(0, vocab, plen).tolist()))
    return out


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


@pytest.mark.parametrize("arch", SERVED)
def test_cluster_over_dense_engines_matches_reference(arch):
    """``serve_real_cluster`` over two dense engines per package, eight
    requests arriving over time (prompts of 21 and 27 tokens overflow
    hymba's 16-slot rings): the same streams, times, Algorithm-1 decisions
    and signals. No experts: nothing migrates. xlstm's streams include the
    reference's dropped splice."""
    cfg, jp, tcfg, tp = twin(arch)
    runs = []
    for eng, req, clus, serve, params, mcfg, kw in (
            (JEngine, JRequest, JCluster, j_serve, jp, cfg, {}),
            (TEngine, TRequest, TCluster, t_serve, tp, tcfg,
             dict(device="cpu"))):
        engines = [eng(i, mcfg, params, max_slots=4, max_len=48, **kw)
                   for i in range(2)]
        reqs = _requests(req, cfg.vocab_size, n=8, gap=0.1)
        res = serve(reqs, engines, cluster_cfg=clus(window_tokens=200))
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
    assert sig["migrations"] == 0 and sig["expert_moves"] == 0
    assert sum(sig["decisions"].values()) > 0


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_prefill_splice_follows_reference_rule(arch):
    """One prefill into slot 1 of a 4-slot engine, in both packages: hymba's
    ``(n_super, batch, ...)`` leaves (KV rings and mamba state) are spliced
    at [:, 1]; xlstm's ``(batch, ...)`` states are not (1 != 4), so every
    state leaf is left as it was, though the prefill's state is not zero."""
    cfg, jp, tcfg, tp = twin(arch)
    prompt = _prompt(cfg, 1, 21)[0].tolist()
    after = []
    for eng, req, params, mcfg, kw in (
            (JEngine, JRequest, jp, cfg, {}),
            (TEngine, TRequest, tp, tcfg, dict(device="cpu"))):
        e = eng(0, mcfg, params, max_slots=4, max_len=32, **kw)
        snap = lambda: {k: np.array(v.numpy() if torch.is_tensor(v)  # noqa
                                    else v, np.float32)
                        for k, v in _flat(e.cache).items()}
        before = snap()
        e.slots.acquire(-1)          # slot 0 taken: the request gets slot 1
        e.enqueue(req(req_id=0, prompt_len=21, max_new_tokens=2,
                      arrival_time=0.0, prompt_tokens=prompt), 0.0)
        e._admit(0.0)
        now = snap()
        after.append(({k: not np.array_equal(before[k], now[k])
                       for k in now}, now))
    (jchg, jnow), (tchg, tnow) = after
    assert tchg == jchg
    if arch == "xlstm-125m":
        assert not any(tchg.values())
        fns = t_build_model(tcfg)
        _, st, _ = fns.prefill(tp, {"tokens": torch.tensor([prompt])},
                               fns.init_cache(1, 32, device="cpu"))
        assert float(st[0]["C"].abs().sum()) > 0
    else:
        assert all(tchg.values())
    for k in tnow:
        np.testing.assert_allclose(tnow[k], jnow[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_migrator_finds_no_experts(arch):
    """``ExpertMigrator`` over engines of a model without experts (xlstm's
    list-shaped blocks included) finds no expert tensors, keys the tree by
    ``()``, and adopts a placement and restores the start by moving
    nothing."""
    _, _, tcfg, tp = twin(arch)
    engines = [TEngine(i, tcfg, tp, max_slots=2, max_len=32, device="cpu")
               for i in range(2)]
    mig = ExpertMigrator(engines, tcfg)
    trees = mig.trees()
    assert list(trees) == [()] and trees[()] is tp
    snap = [t.clone() for t in tree_leaves(tp)]
    mig.adopt(mig.cur)
    mig.restore()
    assert all(torch.equal(a, b) for a, b in zip(snap, tree_leaves(tp)))


# ---------------------------------------------------------------- refusals
def test_paged_plane_refuses_llava_and_hymba():
    """The paged runner serves token models only (llava is refused), and
    the paged pool refuses hymba's mamba state: both packages, the same
    messages."""
    cfg, jp, tcfg, tp = twin("llava-next-34b")
    ecfg = dict(page_size=8, n_pages=16, max_blocks_per_req=4, max_batch=2,
                token_budget=16, chunk_buckets=(8, 16))
    msgs = []
    for runner, paged, params, mcfg, kw in (
            (JRunner, JPaged, jp, cfg, dict(attn_backend="xla")),
            (TRunner, TPaged, tp, tcfg, dict(device="cpu"))):
        with pytest.raises(NotImplementedError) as err:
            runner(mcfg, params, paged(**ecfg, **kw), n_sources=2)
        msgs.append(str(err.value))
    hcfg, _, htcfg, _ = twin("hymba-1.5b")
    with pytest.raises(NotImplementedError) as jerr:
        jtfm.init_paged_cache(hcfg, 8, 8)
    with pytest.raises(NotImplementedError) as terr:
        ttfm.init_paged_cache(htcfg, 8, 8, device="cpu")
    msgs += [str(jerr.value), str(terr.value)]
    assert msgs[0] == msgs[1] == "paged runtime serves token models"
    assert msgs[2] == msgs[3] == "paged KV: mamba state is not paged"


def test_xlstm_states_are_not_written_in_place():
    """xlstm's prefill and decode return new states and leave the given
    ones as they were, as the reference's functional entry points do."""
    _, _, tcfg, tp = twin("xlstm-125m")
    cache = txlstm.init_cache(tcfg, 2, device="cpu")
    snap = [t.clone() for t in tree_leaves(cache)]
    toks = torch.from_numpy(_prompt(tcfg, 2, 5))
    _, st, _ = txlstm.prefill(tp, tcfg, {"tokens": toks}, cache)
    txlstm.decode_step(tp, tcfg, toks[:, 0], st, torch.zeros(2))
    assert all(torch.equal(a, b) for a, b in zip(snap, tree_leaves(cache)))
