"""The port's model checkpoints (``repro_torch/ft/checkpoint.py``): round
trip and step, atomic overwrite and the structure check, as
``tests/test_ft.py`` holds the reference's; then across the two packages,
both ways: the smoke params of qwen3-8b and qwen3-moe (bf16, by bit
pattern) restore bit for bit, and a ``TrainState`` saved after 2 steps in
one package restores bit for bit in the other and trains on there as in
its own (float32 twins, params within 1e-5). The reference writes zlib
leaves here, as an install without ``zstandard`` does (the port reads zlib
only)."""
import dataclasses
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ft.checkpoint as jckpt
from repro.configs import get_smoke_config
from repro.configs.base import reduced
from repro.models import build_model
from repro.train import AdamWConfig as JAdamW
from repro.train import make_train_state as j_make_state
from repro.train import make_train_step as j_make_step
from repro_torch.bridge import (config_from_dict, params_from_numpy,
                                tree_flatten)
from repro_torch.ft import (checkpoint_step, restore_checkpoint,
                            save_checkpoint)
from repro_torch.models import build_model as t_build_model
from repro_torch.train import AdamWConfig, make_train_state, make_train_step


@pytest.fixture
def zlib_reference(monkeypatch):
    monkeypatch.setattr(jckpt, "_compress", lambda d: zlib.compress(d, 3))


def _bits(a):
    """A leaf's dtype name and raw bytes, for either package."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().tobytes()
        return str(t.numpy().dtype), t.numpy().tobytes()
    a = np.asarray(a)
    return str(a.dtype), a.tobytes()


def test_checkpoint_roundtrip_and_step(tmp_path):
    cfg = get_smoke_config("qwen3-8b")
    params = t_build_model(cfg).init(torch.Generator().manual_seed(0),
                                     device="cpu")
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params, step=7)
    assert checkpoint_step(path) == 7
    restored = restore_checkpoint(path, params)
    assert list(restored) == list(params)
    for a, b in zip(tree_flatten(params), tree_flatten(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomic_overwrite(tmp_path):
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"a": torch.ones(4)}, step=1)
    save_checkpoint(path, {"a": torch.zeros(4)}, step=2)
    assert checkpoint_step(path) == 2
    assert not os.path.exists(path + ".tmp")
    out = restore_checkpoint(path, {"a": torch.zeros(4)})
    assert torch.equal(out["a"], torch.zeros(4))
    assert checkpoint_step(str(tmp_path / "none")) is None


def test_checkpoint_structure_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"a": torch.ones(4)})
    with pytest.raises(ValueError):
        restore_checkpoint(path, {"a": torch.ones(4), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, {"a": torch.ones(5)})


def test_checkpoint_leaf_order_is_the_references(tmp_path, zlib_reference):
    """Dict keys sorted, lists in order, NamedTuple fields in order; the
    manifest lists the same shapes and dtypes as the reference's."""
    tree = {"z": [np.arange(3, dtype=np.int32), np.ones((2, 2), np.float32)],
            "a": {"y": np.zeros(1, np.int8), "b": np.full(4, 2, np.int64)}}
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_checkpoint(jpath, tree, step=3)
    save_checkpoint(tpath, tree, step=3)
    jm, tm = (json.load(open(os.path.join(p, "manifest.json")))
              for p in (jpath, tpath))
    assert tm["leaves"] == jm["leaves"] and tm["n_leaves"] == jm["n_leaves"]
    for i in range(jm["n_leaves"]):
        leaf = f"leaf_{i:05d}.zst"
        assert zlib.decompress(open(os.path.join(jpath, leaf), "rb").read()) \
            == zlib.decompress(open(os.path.join(tpath, leaf), "rb").read())


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-moe-30b-a3b"])
def test_params_restore_across_packages(tmp_path, zlib_reference, arch,
                                        writer):
    cfg = get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    jp = build_model(cfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jp, device="cpu")
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        jckpt.save_checkpoint(path, jp, step=5)
        out = restore_checkpoint(path, tp)
        got, want = tree_flatten(out), jax.tree.leaves(jp)
    else:
        save_checkpoint(path, tp, step=5)
        out = jckpt.restore_checkpoint(path, jp)
        got, want = jax.tree.leaves(out), tree_flatten(tp)
    assert checkpoint_step(path) == jckpt.checkpoint_step(path) == 5
    assert len(got) == len(want)
    assert any(_bits(w)[0] == "bfloat16" for w in want)
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)


def _batches(cfg, n, B=2, S=8):
    rng = np.random.default_rng(4)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_train_state_resumes_across_packages(tmp_path, zlib_reference,
                                             writer, moments):
    """2 steps in the writer's package and a checkpoint of its TrainState,
    which the other package restores bit for bit (params, moments, int8
    scales, step); then more steps in each package, the other's from the
    checkpoint: the same params within 1e-5, the same step. int8 moments
    take one more step, not two: a moment whose quotient sits on a rounding
    tie may take a code one apart in the two packages (as
    ``tests/test_torch_train.py`` allows), and the step after reads that
    code."""
    cfg = reduced(get_smoke_config("qwen3-8b"), n_layers=2, dtype="float32")
    jfns = build_model(cfg)
    tfns = t_build_model(config_from_dict(dataclasses.asdict(cfg)))
    jp = jfns.init(jax.random.PRNGKey(0))
    kw = dict(lr=1e-3, moment_dtype=moments)
    jstep = j_make_step(lambda p, b: jfns.loss(p, b), JAdamW(**kw))
    tstep = make_train_step(lambda p, b: tfns.loss(p, b), AdamWConfig(**kw))
    batches = _batches(cfg, 4)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    tb = [{k: torch.as_tensor(v) for k, v in b.items()} for b in batches]
    jstate = j_make_state(jp, JAdamW(**kw))
    tstate = make_train_state(params_from_numpy(jp, device="cpu"),
                              AdamWConfig(**kw))
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        for b in jb[:2]:
            jstate, _ = jstep(jstate, b)
        jckpt.save_checkpoint(path, jstate, step=2)
        tstate = restore_checkpoint(path, tstate)
    else:
        for b in tb[:2]:
            tstate, _ = tstep(tstate, b)
        save_checkpoint(path, tstate, step=2)
        jstate = jckpt.restore_checkpoint(path, jstate)
    got, want = tree_flatten(tstate), jax.tree.leaves(jstate)
    assert len(got) == len(want)
    assert all(_bits(g) == _bits(w) for g, w in zip(got, want))
    assert int(tstate.opt.step) == 2
    more = 1 if moments == "int8" else 2
    for jbb, tbb in zip(jb[2:2 + more], tb[2:2 + more]):
        jstate, _ = jstep(jstate, jbb)
        tstate, _ = tstep(tstate, tbb)
    assert int(tstate.opt.step) == int(jstate.opt.step) == 2 + more
    for t, j in zip(tree_flatten(tstate.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)
