"""llama4-maverick in the port against the reference, on a float32 twin of
its smoke config cut to one period (a dense layer, then a MoE layer with
128-wide experts cut to 8, top-1, and one shared expert). The port's params
are the reference's init converted leaf by leaf.

Floats within 1e-5 (the MoE layer) or 1e-4 (logits and pages after two
layers, the bar of ``test_torch_transformer.py``); integers exact. Whole
serves through ``serve_real_cluster`` must give the reference's tokens,
decisions, migrations, expert moves, staged adoptions and every other
signal, and leave the caller's weights bitwise as they were."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs.base import reduced
from repro.models import build_model
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.serving.engine_util import pin_dispatch_mode
from repro_torch.bridge import (config_from_dict, params_from_numpy,
                                tree_leaves)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model as build_torch_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from test_torch_cluster import JAX, RUNNER, TORCH, _assert_same_run, _run
from test_torch_transformer import BT, Pair, _chunk, _prompts

ARCH = "llama4-maverick-400b-a17b"


@pytest.fixture(scope="module")
def twin():
    cfg = reduced(j_get_smoke_config(ARCH), n_layers=2, dtype="float32")
    jp = build_model(cfg).init(jax.random.PRNGKey(0))
    return (cfg, jp, config_from_dict(dataclasses.asdict(cfg)),
            params_from_numpy(jp, device="cpu"))


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_config_is_the_reference_config(which):
    j = j_get_config(ARCH) if which == "config" else j_get_smoke_config(ARCH)
    t = get_config(ARCH) if which == "config" else get_smoke_config(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.moe.n_shared_experts == 1 and t.moe.moe_every == 2


def test_one_period_is_a_dense_then_a_moe_layer(twin):
    _, jp, tcfg, tp = twin
    assert [d.moe for d in ttfm.period_descriptors(tcfg)] == [False, True]
    assert ttfm.n_super_blocks(tcfg) == 1 and tcfg.n_moe_layers == 1
    assert set(tp["blocks"]["pos1"]["moe"]) == {"router", "w_gate", "w_up",
                                                "w_down", "shared"}
    # the port's own init (through build_model) draws the same tree,
    # shapes and types
    own = build_torch_model(tcfg).init(torch.Generator().manual_seed(0),
                                       device="cpu")
    flat = lambda t: {k: v for k, v in _items(t)}  # noqa: E731
    assert {k: (tuple(v.shape), v.dtype) for k, v in flat(own).items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in flat(tp).items()}
    assert ttfm.identity_placement(tcfg).shape == (1, tcfg.moe.n_experts)


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "padded"])
@pytest.mark.parametrize("S", [5, 1], ids=["prefill", "decode_regroup"])
def test_moe_layer_with_shared_expert(twin, ragged, S):
    """Both dispatch paths, a prefill-shaped batch and the decode regroup
    (S == 1, B > 1: one dispatch group, the reference's shared branch on
    the regrouped view)."""
    cfg, jp, tcfg, tp = twin
    rng = np.random.default_rng(S + 10 * ragged)
    jm = jax.tree.map(lambda a: a[0], jp["blocks"]["pos1"]["moe"])
    tm = {k: (v[0] if not isinstance(v, dict) else
              {n: w[0] for n, w in v.items()})
          for k, v in tp["blocks"]["pos1"]["moe"].items()}
    B, E = 3, cfg.moe.n_experts
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    placement = rng.permutation(E).astype(np.int32)
    src = np.array([0, 1, 1], np.int32)
    mask = rng.random(size=(B, S)) < 0.7
    yj, sj = jmoe.moe_layer(jm, cfg, jnp.asarray(x), jnp.asarray(placement),
                            source_ids=jnp.asarray(src), n_sources=2,
                            ragged=ragged, token_mask=jnp.asarray(mask))
    yt, st = tmoe.moe_layer(tm, tcfg, torch.from_numpy(x),
                            torch.from_numpy(placement),
                            source_ids=torch.from_numpy(src), n_sources=2,
                            ragged=ragged, token_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    for k in ("expert_counts", "source_expert"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]),
                                      err_msg=k)
    np.testing.assert_allclose(float(st["aux_loss"]), float(sj["aux_loss"]),
                               rtol=1e-5)
    # the shared expert is a real part of the output
    no_shared = dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, n_shared_experts=0))
    y0, _ = tmoe.moe_layer(tm, no_shared, torch.from_numpy(x),
                           torch.from_numpy(placement), ragged=ragged)
    assert (yt - y0).abs().max() > 1e-3


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_paged_entry_points_match_reference(twin, kv_dtype):
    """Chunked prefill of two requests in two chunks, three decode steps
    (one lane idle), then a mixed step (a decode lane and a new prompt)."""
    pair = Pair(twin, kv_dtype=kv_dtype)
    prompts = _prompts(pair.jcfg, [13, 21])
    pair.prefill(_chunk(prompts, [0, 0], [8, 8], 8), [0, 0], [8, 8], BT,
                 [0, 1])
    logits = pair.prefill(_chunk(prompts, [8, 8], [5, 13], 16), [8, 8],
                          [5, 13], BT, [0, 1])
    nxt = logits.argmax(-1).tolist()
    for step in range(3):
        logits = pair.decode(nxt + [0], [13 + step, 21 + step, 0],
                             BT + [[0, 0, 0, 0]], [True, True, False],
                             [0, 1, 0])
        nxt = logits[:2].argmax(-1).tolist()
    toks = np.zeros((2, 16), np.int32)
    toks[0, 0] = nxt[0]
    toks[1, :10] = _prompts(pair.jcfg, [10], seed=1)[0]
    pair.prefill(toks, [16, 0], [1, 10], [BT[0], [6, 7, 0, 0]], [0, 1],
                 decode_mask=[True, False])


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "padded"])
def test_dense_prefill_and_decode_match_reference(twin, ragged):
    cfg, jp, tcfg, tp = twin
    B, S, L = 2, 10, 16
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.array([S, S - 3], np.int32)
    src = np.array([0, 1], np.int32)
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
    pos = lengths.copy()
    for step in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
        for k in ("expert_counts", "source_expert"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc, js = jdecode(jp, cfg, jnp.asarray(nxt), jc, jnp.asarray(pos),
                             source_ids=jnp.asarray(src), n_sources=2)
        tl, tc, ts = ttfm.decode_step(
            tp, tcfg, torch.from_numpy(nxt), tc, torch.from_numpy(pos),
            source_ids=torch.from_numpy(src), n_sources=2, ragged=ragged)
        pos += 1
    for name in jc:
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tc[name][leaf].numpy(),
                                       np.asarray(jc[name][leaf]),
                                       rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def cluster_twin(twin):
    """``test_torch_cluster``'s twin, for llama4: one runner per package
    and KV dtype."""
    cfg, jp, tcfg, tp = twin
    models = {id(JAX): (cfg, jp), id(TORCH): (tcfg, tp)}
    runners = {}

    def runner(pkg, kv_dtype):
        key = (id(pkg), kv_dtype)
        if key not in runners:
            mcfg, params = models[id(pkg)]
            ecfg = pkg["cfg_cls"](**RUNNER, kv_dtype=kv_dtype, **pkg["ecfg"])
            runners[key] = pkg["runner_cls"](mcfg, params, ecfg, n_sources=2)
        return runners[key]

    return models, runner


CASES = {
    "uncalibrated": dict(migrate=True),
    "predictive_prefetch": dict(migrate=True, predictive=True),
    "int8_pages": dict(kv_dtype="int8", migrate=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_cluster_matches_reference(cluster_twin, name):
    case = CASES[name]
    tcfg, tp = cluster_twin[0][id(TORCH)]
    before = [t.clone() for t in tree_leaves(tp)]
    ptrs = [t.data_ptr() for t in tree_leaves(tp)]
    j = _run(cluster_twin, JAX, case)
    t = _run(cluster_twin, TORCH, case)
    _assert_same_run(j, t)
    sig = t[0].signals
    assert sig["unfinished"] == 0 and not sig["errors"]
    assert sig["migrations"] > 0 and sig["expert_moves"] > 0
    if case.get("predictive"):
        assert sig["prefetch_pointer_swaps"] > 0
    # the caller's weights, in place and bitwise as before the serve, and
    # the engines back at the starting placement
    assert [x.data_ptr() for x in tree_leaves(tp)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), before))
    for e in t[2]:
        np.testing.assert_array_equal(
            e.placement, ttfm.identity_placement(tcfg).numpy())
