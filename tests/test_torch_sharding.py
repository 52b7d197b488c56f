"""The port's sharding policy and spec helpers against the reference's, and
its split-K decode against the reference's ``_split_decode``.

Specs: for every arch x the four ``SHAPES`` x the three abstract meshes
(debug (2, 4), production (16, 16) and (2, 16, 16)), ``make_policy``'s
fields and the ``make_param_specs`` / ``batch_specs`` / ``cache_specs_tree``
trees must be equal leaf by leaf. The reference runs on a stand-in mesh
(any object with a ``shape`` dict and ``axis_names``) and on
``jax.eval_shape`` trees; the port on its abstract meshes and ``meta``
trees. No devices are needed, so the comparison runs at 256 and 512
"chips" on the CPU.

Split-K: the port's split decode (the plain route: each shard's partial
output and log-sum-exp from ``flash_decode_plain``, combined in f32)
against the reference's ``_split_decode`` called directly, within 1e-5 in
float32, with windows, softcaps and a shard with no valid slot. On int8
scales the reference rounds its softmax weights to bf16 even in float32
(ROADMAP.md Queue C), so there the bar is bf16's, and the split is held
at 1e-5 to the port's own unsplit decode.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.distributed import sharding as jsh
from repro.models import api as japi
from repro.models import transformer as jtfm
from repro_torch.bridge import tree_leaves
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import list_archs
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttfm

MESHES = {
    "debug_2x4": tmesh.make_debug_mesh(),
    "pod_16x16": tmesh.make_production_mesh(),
    "multipod_2x16x16": tmesh.make_production_mesh(multi_pod=True),
}
POLICY_FIELDS = ("batch_axes", "fsdp_axes", "model_axis", "expert_data_shard",
                 "expert_rowparallel", "kv_split", "kv_split_axes")


def _stand_in(mesh):
    return types.SimpleNamespace(shape=dict(mesh.shape),
                                 axis_names=mesh.axis_names)


def _jkey(k) -> str:
    if hasattr(k, "key"):
        return k.key
    if hasattr(k, "idx"):
        return f"[{k.idx}]"
    return getattr(k, "name", str(k))


def _j_flat(tree):
    """{path: tuple} of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(_jkey(k) for k in path): tuple(s) for path, s in leaves}


def _t_flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_t_flat(v, path + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_t_flat(v, path + (f"[{i}]",)))
        return out
    return {path: tree if isinstance(tree, tuple) else
            (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def _j_shapes(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(_jkey(k) for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in leaves}


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    return (jcfg, tcfg, japi.param_specs_abstract(jcfg),
            tapi.param_specs_abstract(tcfg))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_i", range(len(SHAPES)),
                         ids=[s.name for s in SHAPES])
@pytest.mark.parametrize("arch", list_archs())
def test_policy_and_spec_trees_match_reference(arch, shape_i, mesh_name):
    mesh = MESHES[mesh_name]
    jcfg, tcfg, jparams, tparams = _abstract(arch)
    jshape, tshape = J_SHAPES[shape_i], SHAPES[shape_i]
    mode = "train" if tshape.kind == "train" else "serve"
    jpol = jsh.make_policy(jcfg, jshape, _stand_in(mesh), mode)
    tpol = tsh.make_policy(tcfg, tshape, mesh, mode)
    for f in POLICY_FIELDS:
        assert getattr(tpol, f) == getattr(jpol, f), f
    assert _t_flat(tsh.make_param_specs(tparams, tcfg, tpol)) \
        == _j_flat(jsh.make_param_specs(jparams, jcfg, jpol))
    jin, tin = japi.input_specs(jcfg, jshape), tapi.input_specs(tcfg, tshape)
    assert _t_flat(tsh.batch_specs(tcfg, tshape, tpol, tin)) \
        == _j_flat(jsh.batch_specs(jcfg, jshape, jpol, jin))
    if tshape.kind != "train":
        jc, tc = japi.cache_specs(jcfg, jshape), tapi.cache_specs(tcfg, tshape)
        assert _t_flat(tsh.cache_specs_tree(tcfg, tpol, tc)) \
            == _j_flat(jsh.cache_specs_tree(jcfg, jpol, jc))


@pytest.mark.parametrize("arch", list_archs())
def test_spec_helpers_give_reference_shapes_and_dtypes(arch):
    jcfg, tcfg, jparams, tparams = _abstract(arch)
    assert _t_flat(tparams) == _j_shapes(jparams)
    assert all(t.device.type == "meta" for t in tree_leaves(tparams))
    for js, ts in zip(J_SHAPES, SHAPES):
        assert _t_flat(tapi.input_specs(tcfg, ts)) \
            == _j_shapes(japi.input_specs(jcfg, js))
        if ts.kind != "train":
            assert _t_flat(tapi.cache_specs(tcfg, ts)) \
                == _j_shapes(japi.cache_specs(jcfg, js))
    jp, tp = japi.placement_spec(jcfg), tapi.placement_spec(tcfg)
    assert (jp is None) == (tp is None)
    if jp is not None:
        assert (tuple(tp.shape), str(tp.dtype)) \
            == (tuple(jp.shape), "torch." + str(jp.dtype))


def test_meshes_have_reference_shapes():
    assert MESHES["debug_2x4"].shape == {"data": 2, "model": 4}
    assert tmesh.make_debug_mesh(multi_pod=True).shape \
        == {"pod": 2, "data": 2, "model": 2}
    assert MESHES["pod_16x16"].shape == {"data": 16, "model": 16}
    assert MESHES["multipod_2x16x16"].axis_names == ("pod", "data", "model")


def test_local_shapes_follow_the_spec():
    cfg = get_config("qwen3-moe-30b-a3b")
    pol = tsh.make_policy(cfg, SHAPES[2], MESHES["debug_2x4"], "serve")
    assert pol.kv_split == 4 and pol.kv_split_axes == ("model",)
    assert pol.shard_kv_cache((128, 32768, 4, 128)) == (64, 8192, 4, 128)
    assert pol.shard_kv_scale((128, 32768, 4)) == (64, 8192, 4)
    assert pol.shard_heads((128, 1, 32, 128)) == (64, 1, 8, 128)
    assert pol.shard_resid((128, 1, 2048)) == (64, 1, 2048)
    assert pol.shard_expert_ffn((128, 9, 768)) == (32, 9, 384)
    specs = tsh.make_param_specs(tapi.param_specs_abstract(cfg), cfg, pol)
    assert specs["blocks"]["pos0"]["moe"]["w_gate"] \
        == (None, "model", None, "data")
    assert specs["embed"]["embedding"] == ("model", None)


# ------------------------------------------------------------------ split-K
def _split_case(seed, *, B=3, L=32, Hq=4, Hkv=2, hd=16, window=0, cap=0.0,
                quant=False, empty_shard=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, (B, L, Hkv, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (B, L, Hkv, hd)).astype(np.int8)
        ks = (rng.random((B, L, Hkv)) * 0.02).astype(np.float32)
        vs = (rng.random((B, L, Hkv)) * 0.02).astype(np.float32)
    else:
        k = rng.standard_normal((B, L, Hkv, hd)).astype(np.float32)
        v = rng.standard_normal((B, L, Hkv, hd)).astype(np.float32)
        ks = vs = None
    # rows at different fill levels; a short one leaves the later shards
    # without a valid slot
    pos = np.array([L // 8 if empty_shard else L - 3, L + 5, 2 * L + 1][:B],
                   np.int32)
    return q, k, v, ks, vs, pos


@pytest.mark.parametrize("n_split", [1, 2, 4])
@pytest.mark.parametrize("case", ["plain", "window", "softcap", "int8",
                                  "empty_shard"])
def test_split_decode_matches_reference(case, n_split):
    kw = {"window": dict(window=12), "softcap": dict(cap=5.0),
          "int8": dict(quant=True), "empty_shard": dict(empty_shard=True),
          "plain": {}}[case]
    q, k, v, ks, vs, pos = _split_case(n_split, **kw)
    window, cap = kw.get("window", 0), kw.get("cap", 0.0)
    L = k.shape[1]
    jpos = jnp.asarray(pos)[:, None]
    jkp = jtfm.ring_positions(jnp.asarray(pos), L)
    ref = jtfm._split_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpos, jkp, window,
        cap, n_split, None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs))
    tpos = torch.from_numpy(pos)
    got = ttfm.split_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tpos[:, None], ttfm.ring_positions(tpos, L), window, cap, n_split,
        None if ks is None else torch.from_numpy(ks),
        None if vs is None else torch.from_numpy(vs))
    assert got.shape == (q.shape[0], 1, q.shape[2], q.shape[3])
    if case != "int8":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)
        return
    # an int8 cache dequantizes to bf16, and the reference then rounds its
    # softmax weights to bf16 even in a float32 model, split or not
    # (ROADMAP.md Queue C, "Dense decode in bf16"); the port's kernel keeps
    # them in f32. So the reference is met at the bf16 bar, and the split
    # is held at 1e-5 to the port's own unsplit decode of the same cache.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-2)
    whole = ttfm.split_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tpos[:, None], ttfm.ring_positions(tpos, L), window, cap, 1,
        torch.from_numpy(ks), torch.from_numpy(vs))
    torch.testing.assert_close(got, whole, atol=1e-5, rtol=1e-5)


def test_split_decode_partials_recombine_to_unsplit():
    """Each shard's (output, log-sum-exp) from ``flash_decode_plain``,
    combined, equals one unsplit call; a shard with no valid slot has
    lse = -inf and output 0."""
    from repro_torch.kernels.flash_decode import flash_decode_plain
    q, k, v, _, _, pos = _split_case(7, empty_shard=True)
    qt, kt, vt = (torch.from_numpy(a) for a in (q[:, 0], k, v))
    tpos = torch.from_numpy(pos)
    kp = ttfm.ring_positions(tpos, k.shape[1])
    full = flash_decode_plain(qt, kt, vt, kp, tpos)
    outs, lses = [], []
    for s in range(4):
        sl = slice(8 * s, 8 * s + 8)
        o, lse = flash_decode_plain(qt, kt[:, sl], vt[:, sl], kp[:, sl],
                                    tpos, return_lse=True)
        outs.append(o)
        lses.append(lse)
    assert torch.isneginf(lses[3][0]).all() and (outs[3][0] == 0).all()
    got = ttfm.combine_partials(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(got, full, atol=1e-6, rtol=1e-6)
