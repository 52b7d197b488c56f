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
* at (2, 2) only: the qwen3-8b smoke config, gemma2-2b (a window ring and
  softcaps), llama4 (a shared expert; at 4 layers its stack is cut over
  ``model``, with and without ``expert_data_shard``) and an int8 ring (the reference
  rounds int8 decode's weights to bf16, ROADMAP.md Queue C: logits at the
  bf16 bar, codes within one of the 1/127 rule).

Weights come from the reference's ``init(PRNGKey(0))``; the reference's
outputs are computed here and passed to the ranks as tensors, and the
ranks import neither ``jax`` nor the reference. Beside them, in this
process: a policy over one rank changes no bit (the (1, 1) mesh, and
split-K forced to 4 against the reference), and a policy over several
ranks on xlstm, encdec, hybrid or ``loss_fn`` raises.
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
    "qwen3moe_int8": ("qwen3-moe-30b-a3b", B, "int8", True, 2),
}


def _jcfg(arch, layers=2):
    return j_reduced(j_smoke(arch), n_layers=layers, dtype="float32")


def _tcfg(arch, layers=2):
    return reduced(get_smoke_config(arch), n_layers=layers, dtype="float32")


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
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
    prefill = jax.jit(pin_dispatch_mode(
        lambda p, bt, c: fns.prefill(p, bt, c, **kw), lambda: ragged))
    decode = jax.jit(pin_dispatch_mode(
        lambda p, t, c, n: fns.decode(p, t, c, n, **kw), lambda: ragged))
    logits, cache, stats = prefill(
        jp, {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths)},
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
    for shape in ((2, 2), (1, 4)):
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


@pytest.mark.parametrize("arch,entry", [
    ("xlstm-125m", "prefill"), ("xlstm-125m", "decode"),
    ("seamless-m4t-large-v2", "prefill"), ("seamless-m4t-large-v2", "decode"),
    ("hymba-1.5b", "prefill"), ("hymba-1.5b", "decode"),
    ("qwen3-moe-30b-a3b", "loss"), ("xlstm-125m", "loss"),
])
def test_policy_over_ranks_raises_where_not_honoured(arch, entry):
    cfg = get_smoke_config(arch)
    pol = tsh.make_policy(cfg, ShapeConfig("cell", L, B, "decode"),
                          make_debug_mesh(), "serve")
    fns = build_model(cfg)
    call = {"prefill": lambda: fns.prefill(None, {}, None, policy=pol),
            "decode": lambda: fns.decode(None, None, None, None, policy=pol),
            "loss": lambda: fns.loss(None, {}, policy=pol)}[entry]
    with pytest.raises(NotImplementedError, match="item 11b"):
        call()
