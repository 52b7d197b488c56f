"""The port's training across ranks against the reference on one device.

Spawns one 4-process gloo world per mesh shape on the CPU, each rank
running ``tests/_multirank_train_worker.py`` under a train policy
(``make_policy(cfg, ShapeConfig(..., "train"), mesh, "train")``: FSDP over
``data``, TP and EP over ``model``, each expert's FFN dimension over
``data``, the batch over ``data``) on its shard of the params and its rows
of the batch. The reference's single-device results are computed here and
passed to the ranks as tensors; the ranks import neither ``jax`` nor the
reference. Float32 twins of the smoke configs; tolerances as
``tests/test_torch_train.py`` holds them (1e-5, plus one bf16 unit in the
last place for a bf16 leaf).

* each autograd collective of ``distributed/sharding.py`` against the
  one-rank autograd of the same function (1e-6);
* ``loss`` and every grad leaf's block against ``jax.value_and_grad`` of
  the reference's loss: qwen3-moe at (2, 2) in both dispatch modes and at
  (1, 4), llama4 at 2 layers (a shared expert whole over ``model``), at
  4 (its stack cut over ``model``) and at 6 on a (1, 3) mesh (the shared
  expert's parts summed apart from the routed experts'), qwen3-8b with
  a mask whose count differs between the rows of the ranks, hymba at
  (2, 2) and (1, 4), xlstm-125m and seamless-m4t-large-v2 at (2, 2);
* 3 steps of ``make_train_step(policy=)`` on qwen3-moe, each from the
  reference's state before it: fp32 moments against the reference's
  jitted step (loss, params, moments); int8 moments with int8 gradient
  compression against the same step run op by op: the loss; the step's
  own state (params within 1e-5; moment scales within 1e-5 relative and
  codes within one, outside the 128-element blocks where its compressed
  gradient has a code that float noise flipped, at most one code in a
  thousand); and the update from the reference's raw gradient of the
  step (params, scales within 1e-6 relative, codes within one). lr 1e-4: an AdamW step moves an
  element whose gradient sits within float noise of 0 by up to lr times
  a noise-set fraction, and at lr 1e-3 the one-process port's own step
  already lands 9.6e-6 from the reference's on one expert weight; at
  1e-4 the 1e-5 bar is a tenth of a step;
* a ``TrainState`` saved by the (2, 2) world equals the one-process save
  bit for bit, restores with ``shardings=`` onto the (1, 4) mesh and onto
  one rank, and the reference's ``restore_checkpoint`` reads it.
"""
import filecmp
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import reduced as j_reduced
from repro.ft.checkpoint import restore_checkpoint as j_restore
from repro.models import build_model as j_build
from repro.train import AdamWConfig as JAdamW
from repro.train import make_train_state as j_make_state
from repro.train import make_train_step as j_make_step
from repro.train.optimizer import apply_updates as j_apply
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import compress_grads_int8 as j_compress
from repro_torch.bridge import params_from_numpy, tree_flatten
from repro_torch.ft.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train import OptState, TrainState

SRC = Path(__file__).resolve().parents[1] / "src"
WORKER = Path(__file__).resolve().parent / "_multirank_train_worker.py"
B, S = 4, 16
LR = 1e-4

# data -> (arch, ragged, layers, masked)
LOSS_DATA = {
    "qwen3moe": ("qwen3-moe-30b-a3b", True, 2, False),
    "qwen3moe_padded": ("qwen3-moe-30b-a3b", False, 2, False),
    # 2 layers: one super-block, so the shared expert is whole over
    # ``model`` (only model rank 0 adds it; the gradient summed over it);
    # 4 layers: its stack cut over ``model``, each layer's on one rank
    "llama4": ("llama4-maverick-400b-a17b", True, 2, False),
    "llama4_l4": ("llama4-maverick-400b-a17b", True, 4, False),
    # 6 layers on 3 model ranks: each holds one super-block's shared
    # expert while 8 experts do not split over 3
    "llama4_l6": ("llama4-maverick-400b-a17b", True, 6, False),
    "qwen3_8b": ("qwen3-8b", True, 2, True),
    # hymba's period is 3 layers (two local, one global)
    "hymba": ("hymba-1.5b", True, 3, False),
    "xlstm": ("xlstm-125m", True, 2, False),
    "seamless": ("seamless-m4t-large-v2", True, 2, False),
}
# data -> (moment dtype, gradient compression)
TRAIN_DATA = {"train_fp32": ("float32", None),
              "train_int8": ("int8", "int8")}
TRAIN_POLICY = {"fsdp_axes": ["data"], "batch_axes": ["data"],
                "expert_data_shard": True}
# name -> (kind, data, mesh, extra case fields); a world runs its cases in
# this order (the save comes early: the (1, 4) world's restore waits for it)
CASES = {
    "collectives_2x2": ("collectives", None, (2, 2), {}),
    "ckpt_save_2x2": ("ckpt_save", "train_fp32", (2, 2), {}),
    "qwen3moe_2x2_ragged": ("loss", "qwen3moe", (2, 2),
                            dict(expect=TRAIN_POLICY)),
    "qwen3moe_2x2_padded": ("loss", "qwen3moe_padded", (2, 2), {}),
    "llama4_2x2_shared_whole": ("loss", "llama4", (2, 2), {}),
    "llama4_4layers_2x2": ("loss", "llama4_l4", (2, 2), {}),
    "qwen3_8b_2x2_masked": ("loss", "qwen3_8b", (2, 2), {}),
    "hymba_2x2": ("loss", "hymba", (2, 2), {}),
    "xlstm_2x2": ("loss", "xlstm", (2, 2), {}),
    "seamless_2x2": ("loss", "seamless", (2, 2), {}),
    "train_fp32_2x2": ("train", "train_fp32", (2, 2), {}),
    "train_int8_compressed_2x2": ("train", "train_int8", (2, 2), {}),
    "qwen3moe_1x4_ragged": ("loss", "qwen3moe", (1, 4), dict(
        expect={"expert_data_shard": True})),
    "hymba_1x4": ("loss", "hymba", (1, 4), {}),
    "llama4_6layers_1x3_shared_apart": ("loss", "llama4_l6", (1, 3), {}),
    "ckpt_restore_1x4": ("ckpt_restore", "train_fp32", (1, 4), {}),
}
COLLECTIVES = ["all_reduce", "enter", "all_gather", "all_gather_summed",
               "gather_blocks", "keep_own", "split", "fsdp_gather",
               "grad_entry", "all_reduce_max"]


def _jcfg(arch, layers):
    return j_reduced(j_smoke(arch), n_layers=layers, dtype="float32")


def _batch(cfg, seed, masked=False):
    """numpy tokens and next-token labels (and stand-in frame embeddings
    for the encoder-decoder); with ``masked`` a mask whose count differs
    between the batch's halves."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["embeddings"] = rng.normal(size=(B, S, cfg.d_model)) \
            .astype(np.float32)
    if masked:
        batch["mask"] = rng.random((B, S)) < np.array(
            [0.9, 0.9, 0.3, 0.3])[:, None]
    return batch


@functools.lru_cache(maxsize=None)
def _loss_reference(name):
    arch, ragged, layers, masked = LOSS_DATA[name]
    cfg = _jcfg(arch, layers)
    fns = j_build(cfg)
    jp = fns.init(jax.random.PRNGKey(0))
    batch = _batch(cfg, len(name), masked)
    old = jmoe.PERF["ragged_dispatch"]
    jmoe.PERF["ragged_dispatch"] = ragged
    try:
        (jl, jm), jg = jax.value_and_grad(
            lambda p: fns.loss(p, {k: jnp.asarray(v)
                                   for k, v in batch.items()}),
            has_aux=True)(jp)
    finally:
        jmoe.PERF["ragged_dispatch"] = old
    f32 = lambda a: torch.tensor(float(a), dtype=torch.float32)  # noqa
    return {"params": params_from_numpy(jp, device="cpu"),
            "batch": {k: torch.as_tensor(v) for k, v in batch.items()},
            "loss": f32(jl), "ce": f32(jm["ce"]), "aux": f32(jm["aux"]),
            "grads": params_from_numpy(jg, device="cpu")}


def _port_state(js):
    cv = lambda t: params_from_numpy(t, device="cpu")  # noqa: E731
    return TrainState(params=cv(js.params), opt=OptState(
        step=torch.as_tensor(np.array(js.opt.step)), mu=cv(js.opt.mu),
        nu=cv(js.opt.nu), mu_scale=cv(js.opt.mu_scale),
        nu_scale=cv(js.opt.nu_scale)))


@functools.lru_cache(maxsize=None)
def _train_reference(name):
    """3 steps of the reference's train step on qwen3-moe (ragged dispatch)
    from its init: (the blob for the ranks, the final state). fp32
    moments: its jitted step. int8 moments with int8 compression: the same
    step op by op (IEEE divisions in the int8 scales, as
    ``tests/test_torch_train.py`` runs it), keeping each step's raw grads,
    which the ranks also feed to the optimizer alone."""
    moments, compression = TRAIN_DATA[name]
    cfg = _jcfg("qwen3-moe-30b-a3b", 2)
    fns = j_build(cfg)
    jp = fns.init(jax.random.PRNGKey(0))
    batches = [_batch(cfg, 10 + i) for i in range(3)]
    opt = JAdamW(lr=LR, moment_dtype=moments)
    old = jmoe.PERF["ragged_dispatch"]
    jmoe.PERF["ragged_dispatch"] = True
    js, losses, grads = j_make_state(jp, opt), [], []
    states = [_port_state(js)]
    try:
        step = jax.jit(j_make_step(lambda p, b: fns.loss(p, b), opt,
                                   grad_compression=compression))
        for b in batches:
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            if moments == "int8":
                (loss, _), g = jax.value_and_grad(
                    lambda p: fns.loss(p, jb), has_aux=True)(js.params)
                grads.append(params_from_numpy(g, device="cpu"))
                if compression == "int8":
                    g = j_compress(g)
                js = JTrainState(*j_apply(js.params, g, js.opt, opt))
            else:
                js, m = step(js, jb)
                loss = m["loss"]
            losses.append(torch.tensor(float(loss)))
            states.append(_port_state(js))
    finally:
        jmoe.PERF["ragged_dispatch"] = old
    blob = {"params": params_from_numpy(jp, device="cpu"),
            "batches": [{k: torch.as_tensor(v) for k, v in b.items()}
                        for b in batches],
            "losses": losses, "states": states, "state": states[-1],
            "grads": grads}
    return blob, js


def _spawn(tmp, shape, cases):
    world = int(np.prod(shape))
    tag = "x".join(map(str, shape))
    job = {"src": str(SRC), "shape": list(shape), "axes": ["data", "model"],
           "world": world, "store": str(tmp / f"store_{tag}"),
           "data": str(tmp), "out": str(tmp / f"out_{tag}"), "cases": cases}
    path = tmp / f"job_{tag}.json"
    path.write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return job, [subprocess.Popen([sys.executable, str(WORKER), str(path),
                                   str(r)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]


def _join(job, procs):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0] + "\n(killed at the timeout)")
    codes = [p.returncode for p in procs]
    assert codes == [0] * len(procs), f"rank exit codes {codes}:\n" + \
        "\n".join(lg[-3000:] for lg in logs)
    return [json.loads(Path(f"{job['out']}.{r}.json").read_text())
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank_train")
    for name in LOSS_DATA:
        torch.save(_loss_reference(name), tmp / f"{name}.pt")
    for name in TRAIN_DATA:
        torch.save(_train_reference(name)[0], tmp / f"{name}.pt")
    ckpt = tmp / "ckpt_2x2"
    runs = {}
    for shape in ((2, 2), (1, 4), (1, 3)):
        cases = []
        for cname, (kind, data, mesh, extra) in CASES.items():
            if mesh != shape:
                continue
            case = dict(name=cname, kind=kind, data=data, **extra)
            if kind in ("loss", "train", "ckpt_save", "ckpt_restore"):
                arch, ragged, layers = (LOSS_DATA[data][:3] if kind == "loss"
                                        else ("qwen3-moe-30b-a3b", True, 2))
                case.update(arch=arch, ragged=ragged, layers=layers,
                            path=str(ckpt))
            if kind == "train":
                case.update(moments=TRAIN_DATA[data][0],
                            compression=TRAIN_DATA[data][1], lr=LR)
            cases.append(case)
        runs[shape] = _spawn(tmp, shape, cases)
    return {"ckpt": ckpt, "tmp": tmp,
            **{shape: _join(*run) for shape, run in runs.items()}}


def _ok(worlds, case):
    for r, res in enumerate(worlds[CASES[case][2]]):
        assert res[case]["ok"], f"rank {r}: {res[case]['msg']}"
    return [res[case]["max_err"] for res in worlds[CASES[case][2]]]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_autograd_collective_matches_one_rank(worlds, name):
    for err in _ok(worlds, "collectives_2x2"):
        assert err[name] <= 1e-6


@pytest.mark.parametrize("case", [c for c, v in CASES.items()
                                  if v[0] == "loss"])
def test_loss_and_grads_match_reference(worlds, case):
    _ok(worlds, case)


@pytest.mark.parametrize("case", [c for c, v in CASES.items()
                                  if v[0] == "train"])
def test_train_steps_match_reference(worlds, case):
    _ok(worlds, case)


def test_checkpoint_saved_by_ranks_equals_one_rank_save(worlds):
    """The (2, 2) world's save (each rank's blocks gathered, rank 0
    writing) is the directory one process writes from the global state:
    the same manifest and the same bytes in every leaf file."""
    _ok(worlds, "ckpt_save_2x2")
    blob, _ = _train_reference("train_fp32")
    one = worlds["tmp"] / "ckpt_one_rank"
    save_checkpoint(str(one), blob["state"], step=3, extra={"by": "ranks"})
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(worlds["ckpt"]))
    assert len(names) == len(tree_flatten(blob["state"])) + 1
    _, mismatch, errors = filecmp.cmpfiles(one, worlds["ckpt"], names,
                                           shallow=False)
    assert mismatch == [] and errors == []


def test_checkpoint_restores_onto_another_mesh(worlds):
    """Restored with ``shardings=`` onto the (1, 4) mesh, each rank holds
    its block of every leaf (the worker checks them bit for bit)."""
    _ok(worlds, "ckpt_restore_1x4")


def test_checkpoint_restores_onto_one_rank_and_the_reference_reads_it(
        worlds):
    blob, js = _train_reference("train_fp32")
    got = restore_checkpoint(str(worlds["ckpt"]), blob["state"])
    for a, b in zip(tree_flatten(got), tree_flatten(blob["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ref = j_restore(str(worlds["ckpt"]), js)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(js)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_no_rank_imports_jax_or_the_reference(worlds):
    for shape in ((2, 2), (1, 4), (1, 3)):
        for r, res in enumerate(worlds[shape]):
            assert res["imports"] == [], (shape, r, res["imports"])
