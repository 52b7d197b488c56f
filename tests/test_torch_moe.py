"""The port's MoE layer and ragged dispatch against the reference's.

Integer outputs (dispatch layout, B, A, routing ids) must be identical;
y within 3e-2 in bf16 and 1e-5 in f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import moe_dispatch as jmd
from repro.models import moe as jmoe
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import moe_dispatch as tmd
from repro_torch.models import moe as tmoe

FIELDS = ("xs", "dest", "group_sizes", "group_offsets", "padded_offsets",
          "tile_expert", "sort_idx")


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("T,K,E", [(16, 2, 8), (8, 8, 128), (96, 8, 128),
                                   (1, 2, 8)])
def test_ragged_dispatch_is_integer_identical(T, K, E):
    rng = np.random.default_rng(T + E)
    x = rng.normal(size=(T, 32)).astype(np.float32)
    # skewed routing: repeated experts exercise the stable sort
    ids = rng.integers(0, max(E // 4, 2), size=(T, K)).astype(np.int32)
    nb = jmd.pick_row_block(T * K, E)
    assert tmd.pick_row_block(T * K, E) == nb
    assert tmd.padded_rows(T * K, E, nb) == jmd.padded_rows(T * K, E, nb)
    jd = jmd.ragged_dispatch(jnp.asarray(x), jnp.asarray(ids), E,
                             row_block=nb)
    td = tmd.ragged_dispatch(torch.from_numpy(x), torch.from_numpy(ids), E,
                             row_block=nb)
    assert td.row_block == jd.row_block
    for f in FIELDS:
        a, b = getattr(td, f), np.asarray(getattr(jd, f))
        if f != "xs":
            assert a.dtype == torch.int32, f
        assert tuple(a.shape) == b.shape, f
        np.testing.assert_array_equal(_np(a), b, err_msg=f)


def test_ragged_combine():
    rng = np.random.default_rng(1)
    ys = rng.normal(size=(24, 6)).astype(np.float32)
    dest = rng.permutation(24)[:10].astype(np.int32)
    gates = rng.random(size=(5, 2)).astype(np.float32)
    out = tmd.ragged_combine(torch.from_numpy(ys), torch.from_numpy(dest),
                             torch.from_numpy(gates))
    ref = jmd.ragged_combine(jnp.asarray(ys), jnp.asarray(dest),
                             jnp.asarray(gates))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def _layer_case(cfg, params, dtype, seed):
    rng = np.random.default_rng(seed)
    moe_p = jax.tree.map(lambda a: a[0], params["blocks"]["pos0"]["moe"])
    B, S, E = 3, 5, cfg.moe.n_experts
    x = jnp.asarray(rng.normal(size=(B, S, cfg.d_model)), jnp.dtype(dtype))
    placement = rng.permutation(E).astype(np.int32)
    src = np.array([0, 1, 1], np.int32)
    mask = rng.random(size=(B, S)) < 0.7
    return moe_p, x, placement, src, mask


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 3e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("masked", [False, True])
def test_moe_layer_matches_reference(tiny_model, dtype, tol, masked):
    cfg, params = tiny_model
    cfg = dataclasses.replace(cfg, dtype=dtype)
    moe_p, x, placement, src, mask = _layer_case(cfg, params, dtype, 2)
    moe_p = jax.tree.map(
        lambda a: a.astype(jnp.dtype(dtype)) if a.ndim == 3 else a, moe_p)
    m = mask if masked else None
    yj, sj = jmoe.moe_layer(moe_p, cfg, x, jnp.asarray(placement),
                            source_ids=jnp.asarray(src), n_sources=2,
                            token_mask=None if m is None else jnp.asarray(m))
    yt, st = tmoe.moe_layer(
        params_from_numpy(moe_p, device="cpu"), cfg,
        params_from_numpy(np.asarray(x), device="cpu"),
        torch.from_numpy(placement), source_ids=torch.from_numpy(src),
        n_sources=2, token_mask=None if m is None else torch.from_numpy(m))
    assert yt.dtype == params_from_numpy(np.asarray(x), device="cpu").dtype
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               rtol=tol, atol=tol)
    for k in ("expert_counts", "source_expert"):
        assert st[k].dtype == torch.int32
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]),
                                      err_msg=k)
    np.testing.assert_allclose(float(st["aux_loss"]), float(sj["aux_loss"]),
                               rtol=1e-5)
    if masked:
        assert int(st["expert_counts"].sum()) == int(mask.sum()) * \
            cfg.moe.top_k


def test_route_matches_reference(tiny_model):
    cfg, params = tiny_model
    moe_p = jax.tree.map(lambda a: a[0], params["blocks"]["pos0"]["moe"])
    x = np.random.default_rng(3).normal(size=(12, cfg.d_model)) \
        .astype(np.float32)
    gj, ij, pj = jmoe.route(moe_p, cfg, jnp.asarray(x))
    gt, it, pt = tmoe.route(params_from_numpy(moe_p, device="cpu"), cfg,
                            torch.from_numpy(x))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-6)


def test_expert_statistics_match_reference():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 8, size=(20, 2)).astype(np.int32)
    src = rng.integers(0, 3, size=(20,)).astype(np.int32)
    mask = rng.random(size=(20,)) < 0.5
    sj = jmoe.expert_statistics(jnp.asarray(ids), 8, jnp.asarray(src), 3,
                                token_mask=jnp.asarray(mask))
    st = tmoe.expert_statistics(torch.from_numpy(ids), 8,
                                torch.from_numpy(src), 3,
                                token_mask=torch.from_numpy(mask))
    for k in sj:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))


def test_migrate_expert_weights_is_exact(tiny_model):
    cfg, params = tiny_model
    moe_p = jax.tree.map(lambda a: a[0], params["blocks"]["pos0"]["moe"])
    E = cfg.moe.n_experts
    rng = np.random.default_rng(5)
    old = rng.permutation(E).astype(np.int32)
    new = rng.permutation(E).astype(np.int32)
    mj = jmoe.migrate_expert_weights(moe_p, jnp.asarray(old),
                                     jnp.asarray(new))
    mt = tmoe.migrate_expert_weights(params_from_numpy(moe_p, device="cpu"),
                                     torch.from_numpy(old),
                                     torch.from_numpy(new))
    for k in ("w_gate", "w_up", "w_down", "router"):
        np.testing.assert_array_equal(_np(mt[k]), np.asarray(mj[k],
                                                             np.float32))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("skew", ["hot_expert", "one_expert"])
def test_source_stats_on_unsorted_ids_match_reference(tiny_model, skew,
                                                      masked):
    """The port counts A[s, e] on the router's ids as they come; the
    reference counts them sorted by physical expert. Under skewed routing
    and a token mask the two must be integer-identical."""
    cfg, params = tiny_model
    moe_p = jax.tree.map(lambda a: a[0], params["blocks"]["pos0"]["moe"])
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    B, S = 4, 6
    T = B * S
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if skew == "hot_expert":       # 3 of 4 slots on expert 1, rest random
        ids = np.where(rng.random((B, S, K)) < 0.75, 1,
                       rng.integers(0, E, (B, S, K)))
    else:                          # every slot on one expert
        ids = np.full((B, S, K), E - 1)
    ids = ids.astype(np.int32)
    gates = rng.random((B, S, K)).astype(np.float32)
    placement = rng.permutation(E).astype(np.int32)
    src2d = np.repeat(np.array([0, 1, 1, 0], np.int32)[:, None], S, 1)
    mask = rng.random((B, S)) < 0.6 if masked else None
    _, sj = jmoe._ragged_moe_ffn(
        moe_p, jnp.asarray(x), jnp.asarray(gates), jnp.asarray(ids),
        jnp.asarray(placement), E, K, None, jnp.asarray(src2d), 2, True,
        token_mask=None if mask is None else jnp.asarray(mask))
    _, st = tmoe._ragged_moe_ffn(
        params_from_numpy(moe_p, device="cpu"), torch.from_numpy(x),
        torch.from_numpy(gates), torch.from_numpy(ids),
        torch.from_numpy(placement), E, K, torch.from_numpy(src2d), 2, True,
        token_mask=None if mask is None else torch.from_numpy(mask))
    for k in ("expert_counts", "source_expert"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]),
                                      err_msg=k)
    n = T if mask is None else int(mask.sum())
    assert int(st["source_expert"].sum()) == n * K


# ------------------------------------------------------------ migration
def _models():
    """The qwen3 test model (two super-blocks of one MoE layer) and the
    llama4 one (one super-block: a dense layer, then a MoE layer with a
    shared expert), each as (reference cfg, reference params, port cfg)."""
    from repro.configs import get_smoke_config
    from repro.configs.base import reduced
    from repro.models import build_model
    from repro_torch.bridge import config_from_dict
    out = {}
    for arch in ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"):
        cfg = reduced(get_smoke_config(arch), n_layers=2)
        out[arch] = (cfg, build_model(cfg).init(jax.random.PRNGKey(0)),
                     config_from_dict(dataclasses.asdict(cfg)))
    return out


@pytest.fixture(scope="module")
def models():
    return _models()


def _perms(kind, n_moe, E, seed):
    rng = np.random.default_rng(seed)
    ident = np.tile(np.arange(E), (n_moe, 1))
    if kind == "identity":
        return ident, ident.copy()
    if kind == "full_cycle":           # every expert one slot on
        return ident, np.roll(ident, 1, axis=1)
    if kind == "one_swap":
        new = ident.copy()
        new[:, [1, E - 2]] = new[:, [E - 2, 1]]
        return ident, new
    return (np.stack([rng.permutation(E) for _ in range(n_moe)]),
            np.stack([rng.permutation(E) for _ in range(n_moe)]))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_tree_equal(t, j):
    jl = dict(_leaves(jax.tree.map(np.asarray, j)))
    for name, leaf in _leaves(t):
        np.testing.assert_array_equal(_np(leaf), np.asarray(jl[name],
                                                            np.float32),
                                      err_msg=name)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("kind", ["random", "full_cycle", "one_swap",
                                  "identity"])
def test_migration_in_place_equals_reference(models, arch, kind):
    """The port moves only the moved expert rows, in the live leaves; the
    result is the reference's functional migration bit for bit, and the
    router and the shared expert are not touched."""
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as ttfm
    cfg, jp, tcfg = models[arch]
    old, new = _perms(kind, cfg.n_moe_layers, cfg.moe.n_experts, seed=7)
    # the weights laid out under ``old``, by the reference
    start = jtfm.migrate_params_for_placement(jp, cfg, np.tile(
        np.arange(cfg.moe.n_experts), (cfg.n_moe_layers, 1)), old)
    tp = params_from_numpy(start, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in _leaves(tp)}
    keep = {k: v.clone() for k, v in _leaves(tp)
            if "shared" in k or "router" in k}
    out = ttfm.migrate_params_for_placement(tp, tcfg, old, new)
    assert out is tp
    _assert_tree_equal(tp, jtfm.migrate_params_for_placement(start, cfg, old,
                                                             new))
    assert {k: v.data_ptr() for k, v in _leaves(tp)} == ptrs
    for k, v in _leaves(tp):
        if k in keep:
            assert torch.equal(v, keep[k]), k
    moved = int((old != new).sum())
    assert ttfm.move_experts(tp, tcfg, new, old) == moved
    _assert_tree_equal(tp, start)


class _Engine:
    """What the cluster's migrator reads of an engine: its placement and
    its weights, held directly (a dense engine) or by a runner (a paged
    one)."""

    def __init__(self, params=None, runner=None, placement=None):
        if runner is not None:
            self.runner = runner
        else:
            self.params = params
        self.placement = placement


def test_stage_then_commit_equals_a_live_move(models):
    from repro_torch.models import transformer as ttfm
    cfg, jp, tcfg = models["llama4-maverick-400b-a17b"]
    old, new = _perms("random", cfg.n_moe_layers, cfg.moe.n_experts, seed=3)
    live = params_from_numpy(jp, device="cpu")
    staged = params_from_numpy(jp, device="cpu")
    stage = ttfm.stage_expert_prefetch(staged, tcfg, old, new)
    moved = int((old != new).sum())
    # the stage holds the moved rows alone and leaves the tree as it was
    assert sum(r.shape[0] for *_, rows in stage for r in rows.values()) == \
        3 * moved
    _assert_tree_equal(staged, jp)
    assert ttfm.commit_expert_prefetch(staged, stage) == moved
    ttfm.migrate_params_for_placement(live, tcfg, old, new)
    for (name, a), (_, b) in zip(_leaves(staged), _leaves(live)):
        assert torch.equal(a, b), name


def test_migrator_moves_each_tree_once_and_restores(models):
    """Three engines: two dense ones that share one tree and a paged one
    on a runner with its own copy. A stage that went stale (another
    placement was adopted first) falls back to a live move; a fresh one is
    committed and counts as a pointer swap; ``restore`` brings both trees
    and every engine's placement back to the start."""
    from repro.models import transformer as jtfm
    from repro_torch.serving.real_cluster import ExpertMigrator
    cfg, jp, tcfg = models["qwen3-moe-30b-a3b"]
    n, E = cfg.n_moe_layers, cfg.moe.n_experts
    start = np.tile(np.arange(E), (n, 1))
    a, b, c = (_perms("random", n, E, seed=s)[1] for s in (1, 2, 3))
    shared = params_from_numpy(jp, device="cpu")
    own = params_from_numpy(jp, device="cpu")
    runner = type("Runner", (), {"params": own})()
    engines = [_Engine(params=shared, placement=start),
               _Engine(params=shared, placement=start),
               _Engine(runner=runner, placement=start)]
    mover = ExpertMigrator(engines, tcfg)
    assert len(mover.trees()) == 2
    mover.stage(a)                     # stale once b is adopted instead
    mover.adopt(b)
    ref = jtfm.migrate_params_for_placement(jp, cfg, start, b)
    _assert_tree_equal(shared, ref)
    _assert_tree_equal(own, ref)
    assert mover.pointer_swaps == 0 and mover.staged is None
    mover.stage(c)
    _assert_tree_equal(shared, ref)    # staging leaves the weights alone
    mover.adopt(c)
    ref = jtfm.migrate_params_for_placement(ref, cfg, b, c)
    _assert_tree_equal(shared, ref)
    _assert_tree_equal(own, ref)
    assert mover.pointer_swaps == 1
    assert all(e.placement is c for e in engines)
    mover.restore()
    _assert_tree_equal(shared, jp)
    _assert_tree_equal(own, jp)
    assert all(np.array_equal(e.placement, start) for e in engines)
