"""The port's dense-cache entry points across ranks against the reference on
one device.

The qwen3-moe smoke config, reduced to 2 layers and float32, runs prefill
and 4 decode steps under the policy of a mesh of gloo ranks on the CPU
(``tests/_multirank_worker.py``, spawned, a file rendezvous): its rows'
logits and its cache shard within 1e-5 of the reference's single-device
``prefill``/``decode_step``, the B/A statistics exact. Cases:

* (2, 2), a ``decode_32k``-like cell: the batch over ``data``, the ring
  cut over ``model`` (kv_split 2), heads, vocabulary and experts over
  ``model``; both MoE dispatch modes;
* (1, 4): the smoke config's 2 KV heads of 16 cut into 8-column halves;
* (2, 2) with ``expert_data_shard`` forced: each expert's FFN dimension
  over ``data``, tokens gathered over ``data``; both dispatch modes;
* B = 1, where ``kv_split_axes`` is (data, model): split-K over all 4
  ranks;
* (1, 3): llama4 at 6 layers, each model rank holding one super-block's
  shared expert while the 8 experts do not split over 3 (the shared
  expert's parts summed on their own);
* at (2, 2) only: the qwen3-8b smoke config, gemma2-2b (a window ring and
  softcaps), llama4 (a shared expert; at 4 layers its stack is cut over
  ``model``, with and without ``expert_data_shard``) and an int8 ring (the reference
  rounds int8 decode's weights to bf16, ROADMAP.md Queue C: logits at the
  bf16 bar, codes within one of the 1/127 rule);
* the other families: hymba (attention heads and mamba channels cut over
  ``model``, the mamba state by channels) at (2, 2) and at (1, 4), where
  each rank holds one query head, half a KV head's columns and a quarter
  of the channels; xlstm-125m at (2, 2) (each block's weights gathered,
  the states cut over the batch); seamless-m4t-large-v2 at (2, 2) (the
  self and cross K/V cut by rows and slots, ``enc_lengths`` per block of
  rows).

Weights come from the reference's ``init(PRNGKey(0))``; the reference's
outputs are computed here and passed to the ranks as tensors, and the
ranks import neither ``jax`` nor the reference. Beside them, in this
process: a policy over one rank changes no bit (the (1, 1) mesh, and
split-K forced to 4 against the reference), and a policy's spec tree
flattens in the params' leaf order.
"""
import dataclasses
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

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import reduced as j_reduced
from repro.models import build_model as j_build
from repro.serving.engine_util import pin_dispatch_mode
from repro_torch.bridge import params_from_numpy, tree_map
from repro_torch.configs import get_smoke_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.models import build_model

SRC = Path(__file__).resolve().parents[1] / "src"
WORKER = Path(__file__).resolve().parent / "_multirank_worker.py"
TOL, BF16_TOL = 1e-5, 3e-2
B, L, S, N_DEC = 4, 32, 20, 4
LENGTHS = np.array([20, 17, 20, 18], np.int32)

# name -> (data, mesh, extra case fields)
CASES = {
    "qwen3moe_2x2_ragged": ("qwen3moe", (2, 2), dict(
        expect={"batch_axes": ["data"], "kv_split": 2,
                "kv_split_axes": ["model"]})),
    "qwen3moe_2x2_padded": ("qwen3moe_padded", (2, 2), {}),
    "qwen3moe_2x2_eds_ragged": ("qwen3moe", (2, 2), dict(
        overrides={"expert_data_shard": True})),
    "qwen3moe_2x2_eds_padded": ("qwen3moe_padded", (2, 2), dict(
        overrides={"expert_data_shard": True})),
    "qwen3moe_1x4_half_kv_heads": ("qwen3moe", (1, 4), dict(
        expect={"kv_split": 4, "kv_split_axes": ["model"]})),
    "qwen3moe_2x2_batch1": ("qwen3moe_b1", (2, 2), dict(
        expect={"batch_axes": [], "kv_split": 4,
                "kv_split_axes": ["data", "model"]})),
    "qwen3_8b_2x2": ("qwen3_8b", (2, 2), {}),
    "gemma2_2b_2x2": ("gemma2", (2, 2), {}),
    "llama4_2x2": ("llama4", (2, 2), {}),
    # 4 layers: 2 super-blocks, so the shared expert's stack is cut over
    # model and each layer's shared expert lives on one model rank
    "llama4_4layers_2x2": ("llama4_l4", (2, 2), {}),
    "llama4_4layers_2x2_eds": ("llama4_l4", (2, 2), dict(
        overrides={"expert_data_shard": True})),
    "qwen3moe_2x2_int8": ("qwen3moe_int8", (2, 2), {}),
    # 6 layers on 3 model ranks: each holds one super-block's shared
    # expert while 8 experts do not split over 3, so the shared expert's
    # parts are summed apart from the routed experts'
    "llama4_6layers_1x3_shared_apart": ("llama4_l6", (1, 3), {}),
    "hymba_2x2": ("hymba", (2, 2), dict(
        expect={"batch_axes": ["data"], "kv_split": 2})),
    "hymba_1x4_heads_and_channels": ("hymba", (1, 4), dict(
        expect={"kv_split": 4, "kv_split_axes": ["model"]})),
    "xlstm_2x2": ("xlstm", (2, 2), dict(expect={"batch_axes": ["data"]})),
    "seamless_2x2_cross_kv_cut": ("seamless", (2, 2), dict(
        expect={"batch_axes": ["data"], "kv_split": 2,
                "kv_split_axes": ["model"]})),
}
# data -> (arch, batch, kv_dtype, ragged, layers)
DATA = {
    "qwen3moe": ("qwen3-moe-30b-a3b", B, "bfloat16", True, 2),
    "qwen3moe_padded": ("qwen3-moe-30b-a3b", B, "bfloat16", False, 2),
    "qwen3moe_b1": ("qwen3-moe-30b-a3b", 1, "bfloat16", True, 2),
    "qwen3_8b": ("qwen3-8b", B, "bfloat16", True, 2),
    "gemma2": ("gemma2-2b", B, "bfloat16", True, 2),
    "llama4": ("llama4-maverick-400b-a17b", B, "bfloat16", True, 2),
    "llama4_l4": ("llama4-maverick-400b-a17b", B, "bfloat16", True, 4),
    "llama4_l6": ("llama4-maverick-400b-a17b", B, "bfloat16", True, 6),
    "qwen3moe_int8": ("qwen3-moe-30b-a3b", B, "int8", True, 2),
    # hymba's period is 3 layers (two local, one global): the smoke depth
    "hymba": ("hymba-1.5b", B, "bfloat16", True, 3),
    "xlstm": ("xlstm-125m", B, "bfloat16", True, 2),
    "seamless": ("seamless-m4t-large-v2", B, "bfloat16", True, 2),
}
S_SRC = 24                       # seamless's encoder frames
ENC_LENGTHS = np.array([24, 21, 24, 17], np.int32)


def _jcfg(arch, layers=2):
    return j_reduced(j_smoke(arch), n_layers=layers, dtype="float32")


def _tcfg(arch, layers=2):
    return reduced(get_smoke_config(arch), n_layers=layers, dtype="float32")


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's single-device run of one data set: prefill of B
    rows of S tokens (LENGTHS real), then N_DEC greedy decode steps."""
    arch, b, kv_dtype, ragged, layers = DATA[name]
    cfg = _jcfg(arch, layers)
    fns = j_build(cfg)
    jp = fns.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(len(name))
    tokens = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    lengths = LENGTHS[:b].copy()
    src = (np.arange(b) % 2).astype(np.int32)
    kw = dict(source_ids=jnp.asarray(src), n_sources=2)
    batch = {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths)}
    dkw = {}
    if cfg.family == "encdec":
        emb = rng.normal(size=(b, S_SRC, cfg.d_model)).astype(np.float32)
        batch["embeddings"] = jnp.asarray(emb)
        dkw["enc_lengths"] = jnp.asarray(ENC_LENGTHS[:b])
    prefill = jax.jit(pin_dispatch_mode(
        lambda p, bt, c: fns.prefill(p, bt, c, **kw), lambda: ragged))
    decode = jax.jit(pin_dispatch_mode(
        lambda p, t, c, n: fns.decode(p, t, c, n, **kw, **dkw),
        lambda: ragged))
    logits, cache, stats = prefill(jp, batch,
                                   fns.init_cache(b, L, kv_dtype=kv_dtype))
    out = {"logits": [logits], "stats": [stats], "decode_tokens": []}
    for i in range(N_DEC):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out["decode_tokens"].append(tok)
        logits, cache, stats = decode(jp, tok, cache,
                                      jnp.asarray(lengths + i))
        out["logits"].append(logits)
        out["stats"].append(stats)
    blob = {k: [_to_torch(x) if x is not None else {} for x in v]
            for k, v in out.items()}
    if cfg.family == "encdec":
        blob["embeddings"] = torch.from_numpy(emb)
        blob["enc_lengths"] = torch.from_numpy(ENC_LENGTHS[:b].copy())
    blob["stats"] = [{k: v for k, v in st.items()
                      if k in ("expert_counts", "source_expert")}
                     for st in blob["stats"]]
    blob.update(params=params_from_numpy(jp, device="cpu"),
                cache=_to_torch(cache), tokens=torch.from_numpy(tokens),
                lengths=torch.from_numpy(lengths), src=torch.from_numpy(src))
    return blob


def _spawn(tmp, shape, cases):
    world = int(np.prod(shape))
    tag = "x".join(map(str, shape))
    job = {"src": str(SRC), "shape": list(shape), "axes": ["data", "model"],
           "world": world, "store": str(tmp / f"store_{tag}"),
           "data": str(tmp), "out": str(tmp / f"out_{tag}"), "cases": cases}
    path = tmp / f"job_{tag}.json"
    path.write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(path),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return job, procs


def _join(job, procs):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0] + "\n(killed at the timeout)")
    codes = [p.returncode for p in procs]
    assert codes == [0] * len(procs), f"rank exit codes {codes}:\n" + \
        "\n".join(lg[-3000:] for lg in logs)
    return [json.loads(Path(f"{job['out']}.{r}.json").read_text())
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank")
    for name in DATA:
        torch.save(_reference(name), tmp / f"{name}.pt")
    runs = {}
    for shape in ((2, 2), (1, 4), (1, 3)):
        cases = []
        for cname, (data, mesh_shape, extra) in CASES.items():
            if mesh_shape != shape:
                continue
            arch, b, kv_dtype, ragged, layers = DATA[data]
            cases.append(dict(name=cname, data=data, arch=arch, B=b, L=L,
                              layers=layers, kv_dtype=kv_dtype, ragged=ragged,
                              tol=BF16_TOL if kv_dtype == "int8" else TOL,
                              **extra))
        runs[shape] = _spawn(tmp, shape, cases)
    return {shape: _join(*run) for shape, run in runs.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_multirank_matches_reference(rank_results, case):
    for r, res in enumerate(rank_results[CASES[case][1]]):
        assert res[case]["ok"], f"rank {r}: {res[case]['msg']}"


def test_no_rank_imports_jax_or_the_reference(rank_results):
    for shape, ranks in rank_results.items():
        for r, res in enumerate(ranks):
            assert res["imports"] == [], (shape, r, res["imports"])


# --------------------------------------------------------- in this process
def _local_run(cfg, params, policy):
    fns = build_model(cfg)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    lengths = torch.from_numpy(LENGTHS)
    src = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    kw = dict(source_ids=src, n_sources=2, policy=policy)
    logits, cache, stats = fns.prefill(
        params, {"tokens": tokens, "lengths": lengths},
        fns.init_cache(B, L, device="cpu"), **kw)
    outs = [(logits, tree_map(torch.clone, cache), stats)]
    for i in range(N_DEC):
        tok = logits.argmax(dim=-1).to(torch.int32)
        logits, cache, stats = fns.decode(params, tok, cache, lengths + i,
                                          **kw)
        outs.append((logits, tree_map(torch.clone, cache), stats))
    return outs


def test_one_rank_policy_changes_no_bit():
    cfg = _tcfg("qwen3-moe-30b-a3b")
    params = params_from_numpy(
        j_build(_jcfg("qwen3-moe-30b-a3b")).init(jax.random.PRNGKey(0)),
        device="cpu")
    mesh = Mesh((1, 1), ("data", "model"), rank=0)
    pol = tsh.make_policy(cfg, ShapeConfig("cell", L, B, "decode"), mesh,
                          "serve")
    assert pol.world_size == 1 and pol.kv_split == 1
    plain = _local_run(cfg, params, None)
    under = _local_run(cfg, params, pol)
    for (la, ca, sa), (lb, cb, sb) in zip(plain, under):
        assert torch.equal(la, lb)
        for name in ca:
            for leaf in ca[name]:
                assert torch.equal(ca[name][leaf], cb[name][leaf])
        for k in sa:
            assert torch.equal(sa[k], sb[k])


def test_one_rank_split_k_matches_reference():
    """kv_split forced to 4 on one rank: the shards run one after another
    and the decode still meets the reference's single-device run."""
    blob = _reference("qwen3moe")
    cfg = _tcfg("qwen3-moe-30b-a3b")
    pol = dataclasses.replace(
        tsh.make_policy(cfg, ShapeConfig("cell", L, B, "decode"),
                        Mesh((1, 1), ("data", "model"), rank=0), "serve"),
        kv_split=4)
    fns = build_model(cfg)
    kw = dict(source_ids=blob["src"], n_sources=2, policy=pol)
    logits, cache, _ = fns.prefill(
        blob["params"], {"tokens": blob["tokens"],
                         "lengths": blob["lengths"]},
        fns.init_cache(B, L, device="cpu"), **kw)
    for i, tok in enumerate(blob["decode_tokens"]):
        logits, cache, stats = fns.decode(blob["params"], tok, cache,
                                          blob["lengths"] + i, **kw)
        torch.testing.assert_close(logits, blob["logits"][i + 1], rtol=TOL,
                                   atol=TOL)
        assert torch.equal(stats["expert_counts"],
                           blob["stats"][i + 1]["expert_counts"])


def test_spec_tree_flattens_in_the_params_leaf_order():
    """``flatten_specs`` walks a spec tree as ``tree_flatten`` walks the
    params (dict keys sorted, lists in order), which the optimizer and
    checkpoints pair them by."""
    from repro_torch.bridge import tree_flatten
    from repro_torch.models.api import param_specs_abstract
    for arch in ("xlstm-125m", "llama4-maverick-400b-a17b"):
        cfg = get_smoke_config(arch)
        pol = tsh.make_policy(cfg, ShapeConfig("cell", L, B, "train"),
                              make_debug_mesh(), "train")
        abstract = param_specs_abstract(cfg)
        specs = tsh.make_param_specs(abstract, cfg, pol)
        flat = tsh.flatten_specs(specs)
        leaves = tree_flatten(abstract)
        assert len(flat) == len(leaves)
        # a replicated leaf's spec is P(); a cut one has one entry a dim
        assert all(len(s) in (0, t.dim()) for s, t in zip(flat, leaves))
        assert sum(len(s) > 0 for s in flat) > len(flat) // 2


def test_policy_gives_the_params_spec_tree():
    """The models, the optimizer and the train step read the params' specs
    from one place, the config the policy was made for: ``leaf_specs`` is
    ``make_param_specs`` of the params in their leaf order, and a policy
    refuses another config's params."""
    from repro_torch.models.api import param_specs_abstract
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    pol = tsh.make_policy(cfg, ShapeConfig("cell", L, B, "train"),
                          make_debug_mesh(), "train")
    assert tsh.leaf_specs(pol) == tsh.flatten_specs(tsh.make_param_specs(
        param_specs_abstract(cfg), cfg, pol))
    assert tsh.param_specs(cfg, pol) is tsh.param_specs(None, pol)
    with pytest.raises(ValueError, match="another config"):
        tsh.param_specs(get_smoke_config("qwen3-8b"), pol)
    one = tsh.make_policy(cfg, ShapeConfig("cell", L, B, "train"),
                          Mesh((1, 1), ("data", "model")), "train")
    assert tsh.leaf_specs(one) is None and tsh.leaf_specs(None) is None
