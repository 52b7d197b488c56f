"""The port's training path against the reference's, on the CPU: the token
cross-entropy; the ragged GMM's value and both gradients against
``jax.vjp`` of the reference's ``custom_vjp`` (its Pallas forward in
interpret mode); the padded MoE layer's gradients against ``jax.grad`` of
the reference's einsum layer; every family's ``loss`` and all its grads
against ``jax.value_and_grad``; AdamW (fp32, bf16 and int8 moments) and
int8 gradient compression through ``make_train_step``.

Same numpy-seeded inputs and the same params (the reference's init
converted by ``bridge``) in both packages, float32 twins. Tolerances:
values and grads within 1e-5 (sums taken in another order); a bf16 leaf
(xLSTM's blocks are bf16 whatever the config's dtype, and so are their
grads) within 1e-5 plus one bf16 unit in the last place, because a
difference far below 1e-5 before the rounding can round to the
neighbouring bf16 value. The reference's train step runs op by op, so its
int8 scales are IEEE divisions as the port's are: codes are held exact
where the scales agree bit for bit and within one elsewhere, as
``tests/test_torch_kv_pack.py`` holds them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import get_smoke_config
from repro.configs.base import reduced
from repro.kernels.moe_dispatch import pick_row_block as j_pick_row_block
from repro.kernels.moe_dispatch import ragged_dispatch as j_dispatch
from repro.kernels.moe_dispatch import ragged_gmm as j_ragged_gmm
from repro.models import build_model
from repro.models.layers import cross_entropy as j_cross_entropy
from repro.train import AdamWConfig as JAdamW
from repro.train import make_train_state as j_make_state
from repro.train import make_train_step as j_make_step
from repro_torch.bridge import (config_from_dict, params_from_numpy,
                                params_to_numpy, tree_flatten,
                                tree_unflatten)
from repro_torch.kernels.moe_dispatch import (ragged_dw, ragged_gmm,
                                              ragged_gmm_plain)
from repro_torch.models import build_model as t_build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import cross_entropy
from repro_torch.train import AdamWConfig, make_train_state, make_train_step
from repro_torch.train import optimizer as topt

TOL = 1e-5
BF16_ULP = 2.0 ** -7      # the most a bf16 unit in the last place is, relative


def _np(a):
    return np.asarray(a).astype(np.float64)


def _close(t, j, what, tol=TOL):
    """A port tensor against a reference array: within ``tol``, plus one
    bf16 unit in the last place for a bf16 leaf."""
    bf16 = str(np.asarray(j).dtype) == "bfloat16"
    t = t.detach().float().numpy().astype(np.float64) \
        if isinstance(t, torch.Tensor) else _np(t)
    j = _np(j)
    assert t.shape == j.shape, what
    bar = tol + (BF16_ULP * np.abs(j) if bf16 else 0.0)
    err = np.abs(t - j)
    assert (err <= bar).all(), f"{what}: max |diff| {err.max()}"


def _t(a):
    return params_from_numpy(np.asarray(a), device="cpu")


# ---------------------------------------------------------------- loss head
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6) if masked else None
    ref = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                        None if mask is None else torch.as_tensor(mask))
    assert got.dtype == torch.float32
    _close(got, ref, "cross_entropy")
    # an empty mask divides by 1, as the reference's maximum(sum, 1)
    zero = np.zeros((3, 7), bool)
    assert float(cross_entropy(torch.as_tensor(logits),
                               torch.as_tensor(labels),
                               torch.as_tensor(zero))) == 0.0


# ---------------------------------------------------------------- the GEMMs
def _layout(T, K, E, D, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D)).astype(np.float32)
    ids = np.argsort(rng.random((T, E)), axis=1)[:, :K].astype(np.int32)
    nb = j_pick_row_block(T * K, E)
    return j_dispatch(jnp.asarray(x), jnp.asarray(ids), E, row_block=nb), rng


@pytest.mark.parametrize("fn", [ragged_gmm, ragged_gmm_plain],
                         ids=["ragged_gmm", "plain_twin"])
@pytest.mark.parametrize("T,K,E,D,F", [(40, 2, 8, 32, 24),
                                       (100, 4, 16, 64, 48)])
def test_ragged_gmm_value_and_grads_match_reference(fn, T, K, E, D, F):
    d, rng = _layout(T, K, E, D, seed=T)
    w = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    meta = (d.tile_expert, d.group_sizes, d.padded_offsets)
    y, vjp = jax.vjp(lambda xs, w: j_ragged_gmm(xs, w, *meta, d.row_block,
                                                True), d.xs, jnp.asarray(w))
    # the output's padding rows are 0 whatever xs holds, so their cotangent
    # is 0 in any backward (the combine gathers only real rows); the
    # reference's dx does not mask them and the port's does, which agree
    # only there
    dy = rng.normal(size=y.shape).astype(np.float32)
    real = np.zeros(y.shape[0], bool)
    real[np.asarray(d.dest)] = True
    dy[~real] = 0.0
    jdx, jdw = vjp(jnp.asarray(dy))
    xs = _t(d.xs).requires_grad_()
    wt = _t(w).requires_grad_()
    out = fn(xs, wt, *(_t(m) for m in meta), d.row_block)
    tdx, tdw = torch.autograd.grad(out, (xs, wt), torch.as_tensor(dy))
    _close(out, y, "y")
    _close(tdx, jdx, "dx")
    _close(tdw, jdw, "dw")


def test_ragged_dw_same_bits_over_two_calls():
    d, rng = _layout(100, 4, 16, 64, seed=3)
    dy = torch.as_tensor(rng.normal(size=(d.xs.shape[0], 48)),
                         dtype=torch.float32)
    args = (_t(d.xs), dy, _t(d.tile_expert), _t(d.padded_offsets), 16)
    a = ragged_dw(*args, row_block=d.row_block)
    b = ragged_dw(*args, row_block=d.row_block)
    assert torch.equal(a, b) and a.dtype == torch.float32


@pytest.fixture(scope="module")
def moe_twin():
    cfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2,
                  dtype="float32")
    jp = build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, jp, config_from_dict(dataclasses.asdict(cfg)), \
        params_from_numpy(jp, device="cpu")


def test_padded_moe_layer_grads_match_reference(moe_twin):
    """The capacity-padded layer (its three products through ``moe_gmm``,
    its drops past the capacity) differentiated with respect to the
    layer's params and input, against ``jax.grad`` of the reference's
    einsum layer; the loss reads the output and the router aux loss."""
    cfg, jp, tcfg, tp = moe_twin
    lp = jax.tree.map(lambda a: a[0], jp["blocks"]["pos0"]["moe"])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    place = np.random.default_rng(6).permutation(
        cfg.moe.n_experts).astype(np.int32)

    def jloss(p, x):
        y, st = jmoe.moe_layer(p, cfg, x, jnp.asarray(place), ragged=False,
                               collect_stats=False)
        return jnp.sum(y * r) + st["aux_loss"]

    jg = jax.grad(jloss, argnums=(0, 1))(lp, jnp.asarray(x))
    tl = {k: v.detach().requires_grad_() for k, v in
          jax.tree.map(_t, lp).items()}
    tx = _t(x).requires_grad_()
    y, st = tmoe.moe_layer(tl, tcfg, tx, _t(place), ragged=False,
                           collect_stats=False)
    loss = torch.sum(y * torch.as_tensor(r)) + st["aux_loss"]
    names = sorted(tl)
    grads = torch.autograd.grad(loss, [tl[k] for k in names] + [tx])
    for k, g in zip(names, grads):
        _close(g, jg[0][k], f"d{k}")
    _close(grads[-1], jg[1], "dx")


# ---------------------------------------------------------------- families
FAMILIES = [("qwen3-moe-30b-a3b", True), ("qwen3-moe-30b-a3b", False),
            ("llama4-maverick-400b-a17b", True), ("qwen3-8b", True),
            ("gemma2-2b", True), ("llava-next-34b", True),
            ("hymba-1.5b", True), ("xlstm-125m", True),
            ("seamless-m4t-large-v2", True)]


def family_batch(cfg, B=2, S=16, seed=0):
    """numpy tokens and next-token labels (and stand-in embeddings for the
    embedding-input and encoder-decoder configs), as the reference's
    launcher lays a batch out."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.input_mode == "embeddings" or cfg.family == "encdec":
        batch["embeddings"] = rng.normal(size=(B, S, cfg.d_model)) \
            .astype(np.float32)
        if cfg.family != "encdec":
            del batch["tokens"]
    return batch


@pytest.mark.parametrize("arch,ragged", FAMILIES,
                         ids=[f"{a}-{'ragged' if r else 'padded'}"
                              for a, r in FAMILIES])
def test_loss_and_grads_match_reference(arch, ragged, monkeypatch):
    """``build_model(cfg).loss`` and the grads of every param leaf against
    ``jax.value_and_grad`` of the reference's: the MoE configs on the
    dispatch path asked for (the reference's through ``moe.PERF``), llava
    from embeddings, hymba's mamba branch, gemma2's windows and softcaps,
    xLSTM's recurrent blocks, the encoder-decoder."""
    cfg = reduced(get_smoke_config(arch), dtype="float32")
    if cfg.family in ("moe", "dense") and arch != "llama4-maverick-400b-a17b":
        cfg = reduced(cfg, n_layers=2)
    monkeypatch.setitem(jmoe.PERF, "ragged_dispatch", ragged)
    fns = build_model(cfg)
    jp = fns.init(jax.random.PRNGKey(0))
    batch = family_batch(cfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: fns.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    tfns = t_build_model(config_from_dict(dataclasses.asdict(cfg)))
    tp = params_from_numpy(jp, device="cpu")
    live = [p.detach().requires_grad_() for p in tree_flatten(tp)]
    tl, tm = tfns.loss(tree_unflatten(tp, live),
                       {k: torch.as_tensor(v) for k, v in batch.items()},
                       ragged=ragged)
    grads = torch.autograd.grad(tl, live, allow_unused=True)
    _close(tl, jl, "loss")
    _close(tm["ce"], jm["ce"], "ce")
    _close(tm["aux"], jm["aux"], "aux")
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for i, (g, j) in enumerate(zip(grads, jleaves)):
        _close(torch.zeros(j.shape) if g is None else g, j, f"grad {i}")


# ---------------------------------------------------------------- AdamW
def _jloss(p, batch):
    h = jnp.tanh(batch["x"] @ p["w"] + p["b"])
    loss = jnp.sum(h * batch["y"]) + 0.1 * jnp.sum(p["e"]["emb"] ** 2) \
        + 0.01 * jnp.sum(p["e"]["bf"].astype(jnp.float32) ** 2) \
        + jnp.sum(p["layers"][0] * p["layers"][1])
    return loss, {"ce": loss, "aux": jnp.zeros((), jnp.float32)}


def _tloss(p, batch):
    h = torch.tanh(batch["x"] @ p["w"] + p["b"])
    loss = torch.sum(h * batch["y"]) + 0.1 * torch.sum(p["e"]["emb"] ** 2) \
        + 0.01 * torch.sum(p["e"]["bf"].float() ** 2) \
        + torch.sum(p["layers"][0] * p["layers"][1])
    return loss, {"ce": loss, "aux": torch.zeros(())}


def _opt_params(rng):
    """Leaves of several sizes: 1200 elements (not a multiple of the int8
    block), a bf16 leaf, a list."""
    return {"w": rng.normal(size=(16, 8)).astype(np.float32),
            "b": np.zeros(8, np.float32),
            "e": {"emb": rng.normal(size=(300, 4)).astype(np.float32),
                  "bf": jnp.asarray(rng.normal(size=(10, 13)), jnp.bfloat16)},
            "layers": [rng.normal(size=(3, 5)).astype(np.float32),
                       rng.normal(size=(3, 5)).astype(np.float32)]}


def _codes_close(t_codes, j_codes, t_scale, j_scale, what):
    tc, jc = t_codes.numpy(), np.asarray(j_codes)
    ts, js = t_scale.numpy(), np.asarray(j_scale)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0, err_msg=what)
    same = ts == js
    assert np.array_equal(tc[same], jc[same]), what
    assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1, what


@pytest.mark.parametrize("moments,compression", [
    ("float32", None), ("bfloat16", None), ("int8", None),
    ("bfloat16", "int8")])
def test_train_step_matches_reference(moments, compression, monkeypatch):
    """3 steps of ``make_train_step`` in both packages from the same params
    and batches: params and moments equal. Slices of 256 elements, so that
    a leaf is updated in several slices, each holding whole int8 blocks."""
    monkeypatch.setattr(topt, "SLICE_ELEMS", 256)
    rng = np.random.default_rng(1)
    jp = _opt_params(rng)
    batches = [{"x": rng.normal(size=(6, 16)).astype(np.float32),
                "y": rng.normal(size=(6, 8)).astype(np.float32)}
               for _ in range(3)]
    kw = dict(lr=1e-3, moment_dtype=moments)
    jstate = j_make_state(jax.tree.map(jnp.asarray, jp), JAdamW(**kw))
    jstep = j_make_step(_jloss, JAdamW(**kw), grad_compression=compression)
    tstate = make_train_state(params_from_numpy(jp, device="cpu"),
                              AdamWConfig(**kw))
    tstep = make_train_step(_tloss, AdamWConfig(**kw),
                            grad_compression=compression)
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
        _close(tm["loss"], jm["loss"], "loss", tol=1e-4)
    assert int(tstate.opt.step) == int(jstate.opt.step) == 3
    for i, (t, j) in enumerate(zip(tree_flatten(tstate.params),
                                   jax.tree.leaves(jstate.params))):
        assert str(t.dtype).split(".")[1] == str(np.asarray(j).dtype)
        _close(t, j, f"param {i}")
    tl = [tree_flatten(x) for x in tstate.opt[1:]]
    jl = [jax.tree.leaves(x) for x in jstate.opt[1:]]
    for i in range(len(tl[0])):
        if moments == "int8":
            _codes_close(tl[0][i], jl[0][i], tl[2][i], jl[2][i], f"mu {i}")
            _codes_close(tl[1][i], jl[1][i], tl[3][i], jl[3][i], f"nu {i}")
        else:
            _close(tl[0][i], jl[0][i], f"mu {i}")
            _close(tl[1][i], jl[1][i], f"nu {i}")


def test_train_step_leaves_its_state_and_gives_unread_leaves_zero_grads():
    """The caller's state is left as it was, the returned params require no
    grad, and a leaf the loss never reads still decays (weight decay on a
    zero gradient), as in the reference."""
    rng = np.random.default_rng(2)
    p = params_from_numpy(_opt_params(rng), device="cpu")
    p["unused"] = torch.ones(4)
    state = make_train_state(p, AdamWConfig(lr=1e-2))
    before = [t.clone() for t in tree_flatten(state)]
    step = make_train_step(_tloss, AdamWConfig(lr=1e-2))
    batch = {"x": torch.randn(6, 16), "y": torch.randn(6, 8)}
    new, m = step(state, batch)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree_flatten(state)))
    assert not any(t.requires_grad for t in tree_flatten(new.params))
    assert float(new.params["unused"][0]) == pytest.approx(1 - 1e-2 * 0.1)
    assert set(m) == {"ce", "aux", "loss"}
    assert params_to_numpy(new.params)["w"].dtype == np.float32
