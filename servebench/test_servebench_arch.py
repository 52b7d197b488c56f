"""An architecture of new files only: a test-only adapter pair and a
configuration, written to a temporary directory, give a cell that runs
through the unchanged harness, reads ``correct`` true, and fails with the
fp8 control in the program's place.

The architecture is the port's ``moe_every=2`` layout at smoke size: a
period of two layers, a dense SwiGLU layer and then a MoE layer whose
routed experts sit beside one shared expert, with no q/k norm, under leaf
names and configuration keys of its own. Four layers, so that the second
super-block's leaves hold layers 2 and 3.
"""
import json
import textwrap

import pytest
import torch

from servebench import check, harness
from servebench import run as bench_run
from servebench import weights as W
from servebench.arch import Slot

PROGRAM = '''
"""Test-only: a dense layer, then a MoE layer with a shared expert."""
from servebench.arch import MoEShape, Slot, period_slots

MODEL_TYPES = ("densemoe",)


def _routing_layers(cfg):
    f = cfg["moe_layer_freq"]
    return tuple(i for i in range(cfg["num_hidden_layers"]) if i % f == f - 1)


def model_config(cfg):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], head_dim=cfg["head_dim"],
        moe=MoEConfig(n_experts=cfg["n_routed_experts"],
                      top_k=cfg["experts_per_token"],
                      d_expert=cfg["expert_width"],
                      n_shared_experts=cfg["n_shared_experts"],
                      d_shared=cfg["shared_width"],
                      moe_every=cfg["moe_layer_freq"]),
        rope_theta=float(cfg["rope_theta"]), qk_norm=False,
        norm_eps=float(cfg["rms_norm_eps"]), tie_embeddings=False,
        dtype=cfg["torch_dtype"])


_LAYER = {"ln_attn": "attn_norm", "attn.wq": "attn.q", "attn.wk": "attn.k",
          "attn.wv": "attn.v", "attn.wo": "attn.o", "ln_ffn": "ffn_norm",
          "mlp.w_gate": "ffn.gate", "mlp.w_up": "ffn.up",
          "mlp.w_down": "ffn.down", "moe.router": "moe.router",
          "moe.w_gate": "moe.experts.gate", "moe.w_up": "moe.experts.up",
          "moe.w_down": "moe.experts.down",
          "moe.shared.w_gate": "moe.shared.gate",
          "moe.shared.w_up": "moe.shared.up",
          "moe.shared.w_down": "moe.shared.down"}
_MODEL = {"embed.embedding": "tok_embeddings", "embed.lm_head": "output",
          "final_norm": "final_norm"}


def _less_one(x):
    return x - 1.0


def _slot(index, name, layer):
    return Slot(index, name, layer,
                _less_one if name.endswith("norm") else None)


def checkpoint_leaves(path, shape, period):
    block = period_slots(path, shape, period)
    if block is None:
        return [_slot(None, _MODEL[path], -1)]
    rel, layers = block
    return [_slot(i, _LAYER[rel], layer) for i, layer in layers]


def moe(cfg):
    return MoEShape(experts=cfg["n_routed_experts"],
                    top_k=cfg["experts_per_token"],
                    layers=_routing_layers(cfg))


def model_flops(cfg, n_tokens, ctx_sum, n_logits):
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    attn = 2 * d * (hq * hd + 2 * hkv * hd) + 2 * hq * hd * d
    routed = set(_routing_layers(cfg))
    total = 0
    for i in range(cfg["num_hidden_layers"]):
        if i in routed:
            ffn = 2 * d * cfg["n_routed_experts"] + 6 * d * (
                cfg["experts_per_token"] * cfg["expert_width"]
                + cfg["n_shared_experts"] * cfg["shared_width"])
        else:
            ffn = 6 * d * cfg["intermediate_size"]
        total += n_tokens * (attn + ffn) + 4 * ctx_sum * hq * hd
    return total + n_logits * 2 * d * cfg["vocab_size"]
'''

REFERENCE = '''
"""Test-only: the float32 forward of ``densemoe``."""
import torch

from servebench import reference as R
from servebench import weights as W


def _routes(cfg, layer):
    return layer % cfg["moe_layer_freq"] == cfg["moe_layer_freq"] - 1


def leaves(cfg, layer):
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    if layer < 0:
        return {"tok_embeddings": ((V, d), "embed", 1.0),
                "final_norm": ((d,), "norm", 0.1),
                "output": ((d, V), "matrix", d ** -0.5)}
    hd = cfg["head_dim"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    out = {"attn_norm": ((d,), "norm", 0.1),
           "attn.q": ((d, q), "matrix", d ** -0.5),
           "attn.k": ((d, kv), "matrix", d ** -0.5),
           "attn.v": ((d, kv), "matrix", d ** -0.5),
           "attn.o": ((q, d), "matrix", q ** -0.5),
           "ffn_norm": ((d,), "norm", 0.1)}
    if _routes(cfg, layer):
        E, de = cfg["n_routed_experts"], cfg["expert_width"]
        ds = cfg["n_shared_experts"] * cfg["shared_width"]
        out.update({"moe.router": ((d, E), "router", d ** -0.5),
                    "moe.experts.gate": ((E, d, de), "matrix", d ** -0.5),
                    "moe.experts.up": ((E, d, de), "matrix", d ** -0.5),
                    "moe.experts.down": ((E, de, d), "matrix", de ** -0.5),
                    "moe.shared.gate": ((d, ds), "matrix", d ** -0.5),
                    "moe.shared.up": ((d, ds), "matrix", d ** -0.5),
                    "moe.shared.down": ((ds, d), "matrix", ds ** -0.5)})
    else:
        ff = cfg["intermediate_size"]
        out.update({"ffn.gate": ((d, ff), "matrix", d ** -0.5),
                    "ffn.up": ((d, ff), "matrix", d ** -0.5),
                    "ffn.down": ((ff, d), "matrix", ff ** -0.5)})
    return out


def embed(cfg, seed, toks, device):
    emb = W.draw(seed, "tok_embeddings", -1,
                 leaves(cfg, -1)["tok_embeddings"], device)
    return [emb[t].float() for t in toks]


def _attention(cfg, lp, x, fp8):
    n, hd = x.shape[0], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    q = R.rope(R.lin(x, lp["attn.q"], fp8).view(n, hq, hd), cfg["rope_theta"])
    k = R.rope(R.lin(x, lp["attn.k"], fp8).view(n, hkv, hd), cfg["rope_theta"])
    v = R.lin(x, lp["attn.v"], fp8).view(n, hkv, hd)
    k = k.repeat_interleave(hq // hkv, dim=1).transpose(0, 1)
    v = v.repeat_interleave(hq // hkv, dim=1).transpose(0, 1)
    out = R.causal_attention(q.transpose(0, 1), k, v, hd ** -0.5)
    return R.lin(out.transpose(0, 1).reshape(n, hq * hd), lp["attn.o"], fp8)


def layer(cfg, lp, xs, fp8):
    eps = cfg["rms_norm_eps"]
    xs = [x + _attention(cfg, lp, R.rms(x, lp["attn_norm"], eps), fp8)
          for x in xs]
    cat = torch.cat(xs)
    xn = R.rms(cat, lp["ffn_norm"], eps)
    idx = None
    if "moe.router" in lp:
        probs = torch.softmax(xn @ lp["moe.router"], dim=-1)
        top, idx = torch.topk(probs, cfg["experts_per_token"], dim=-1)
        top = top / top.sum(-1, keepdim=True)
        y = R.routed_experts(xn, idx, top, lp["moe.experts.gate"],
                             lp["moe.experts.up"], lp["moe.experts.down"],
                             fp8) \\
            + R.swiglu(xn, lp["moe.shared.gate"], lp["moe.shared.up"],
                       lp["moe.shared.down"], fp8)
    else:
        y = R.swiglu(xn, lp["ffn.gate"], lp["ffn.up"], lp["ffn.down"], fp8)
    return list((cat + y).split([x.shape[0] for x in xs])), idx


def head(cfg, seed, device):
    spec = leaves(cfg, -1)
    fn = W.draw(seed, "final_norm", -1, spec["final_norm"], device)
    out = W.draw(seed, "output", -1, spec["output"], device).float()
    eps = cfg["rms_norm_eps"]
    return lambda h: R.rms(h, fn, eps) @ out
'''

CONFIG = {
    "name": "densemoe-smoke",
    "model_type": "densemoe",
    "hidden_size": 64,
    "num_hidden_layers": 4,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "head_dim": 16,
    "intermediate_size": 96,
    "n_routed_experts": 8,
    "experts_per_token": 2,
    "expert_width": 32,
    "n_shared_experts": 1,
    "shared_width": 48,
    "moe_layer_freq": 2,
    "vocab_size": 512,
    "rope_theta": 10000.0,
    "rms_norm_eps": 1e-06,
    "torch_dtype": "bfloat16",
    "engine": {"engines": 2, "page_size": 8, "kv_tokens_per_engine": 4096,
               "max_blocks_per_req": 32, "max_batch": 8, "token_budget": 64,
               "chunk_buckets": [16, 32, 64], "max_prefill_lanes": 4,
               "kv_dtype": "auto"},
    # between the program's largest reading and the control's smallest,
    # over 14 seeds at this size on the CPU: p99_logit_gap 0.0305 and
    # 0.235, routing_mismatch_share 0.00559 and 0.0232
    "check": {"limits": {"p99_logit_gap": 0.08,
                         "routing_mismatch_share": 0.012},
              "sample_tokens": 200, "max_requests": 64,
              "max_ref_tokens": 20000},
    "smoke": {},
}
CELL = "densemoe_burst_prefill"


@pytest.fixture
def cell(tmp_path):
    """The new architecture's files in a directory of their own, and its
    cell loaded from there through the harness."""
    (tmp_path / "densemoe.py").write_text(textwrap.dedent(PROGRAM))
    (tmp_path / "densemoe_ref.py").write_text(textwrap.dedent(REFERENCE))
    (tmp_path / "densemoe-smoke.json").write_text(json.dumps(CONFIG))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "densemoe-smoke", "source": "a test",
                        "file": "densemoe-smoke.json", "reduced": [],
                        "why": "a dense layer, then MoE with a shared expert"}]
    spec["workloads"] = [{"name": CELL, "config": "densemoe-smoke",
                          "traffic": "burst_prefill", "chips": 1,
                          "why": "the smoke cell of a test architecture"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.load_cell(CELL, size="smoke",
                             spec_path=tmp_path / "BENCHMARK.json",
                             arch_dirs=[tmp_path])


def test_a_leaf_of_the_period_holds_its_layer(cell):
    assert cell.arch.name == "densemoe"
    cfg = cell.config
    mcfg = cell.arch.program.model_config(cfg)
    tree = harness.program_params(cell.arch, cfg, mcfg, 5, "cpu")
    dense, routed = tree["blocks"]["pos0"], tree["blocks"]["pos1"]
    assert "mlp" in dense and "shared" in routed["moe"]
    # super-block 1, position j: layer 2 + j
    for leaf, name, layer in ((dense["attn"]["wq"][1], "attn.q", 2),
                              (routed["moe"]["shared"]["w_up"][1],
                               "moe.shared.up", 3),
                              (routed["ln_attn"][0], "attn_norm", 1)):
        want = W.draw(5, name, layer, cell.arch.ref.leaves(cfg, layer)[name],
                      "cpu")
        if name.endswith("norm"):
            want = want - 1.0
        assert torch.equal(leaf, want), name


def test_a_leaf_outside_the_period_holds_the_layer_the_adapter_names(
        cell, monkeypatch):
    """A port layout that keeps a layer ahead of the period, as
    DeepSeek-V2's dense layer 0 would be kept, under ``first.``: the
    adapter names its layer, and the leaf holds what the reference draws
    for that layer."""
    from repro_torch.models import transformer as tfm
    init, mapped = tfm.init_params, cell.arch.program.checkpoint_leaves
    ref_leaf = {"ln_attn": "attn_norm", "mlp.w_up": "ffn.up"}

    def with_first(mcfg, **kw):
        tree = init(mcfg, **kw)
        pos0 = tree["blocks"]["pos0"]
        tree["first"] = {"ln_attn": torch.empty_like(pos0["ln_attn"][0]),
                         "mlp": {"w_up": torch.empty_like(
                             pos0["mlp"]["w_up"][0])}}
        return tree

    def leaves(path, shape, period):
        if path.startswith("first."):
            name = ref_leaf[path[len("first."):]]
            return [Slot(None, name, 0, (lambda x: x - 1.0)
                         if name.endswith("norm") else None)]
        return mapped(path, shape, period)

    monkeypatch.setattr(tfm, "init_params", with_first)
    monkeypatch.setattr(cell.arch.program, "checkpoint_leaves", leaves)
    cfg = cell.config
    mcfg = cell.arch.program.model_config(cfg)
    tree = harness.program_params(cell.arch, cfg, mcfg, 5, "cpu")
    first, pos0 = tree["first"], tree["blocks"]["pos0"]
    for leaf, name, period_leaf in (
            (first["ln_attn"], "attn_norm", pos0["ln_attn"][0]),
            (first["mlp"]["w_up"], "ffn.up", pos0["mlp"]["w_up"][0])):
        want = W.draw(5, name, 0, cell.arch.ref.leaves(cfg, 0)[name], "cpu")
        if name.endswith("norm"):
            want = want - 1.0
        assert torch.equal(leaf, want), name
        # layer 0 of this layout also sits in the period: the same draw
        assert torch.equal(leaf, period_leaf), name


def _refused(cell, monkeypatch, fault):
    """``program_params`` under an adapter that ``fault``s the shared
    expert's leaves of position 1 names them in its refusal."""
    orig = cell.arch.program.checkpoint_leaves

    def faulty(path, shape, period):
        if path.startswith("blocks.pos1.moe.shared."):
            return fault(path, orig(path, shape, period))
        return orig(path, shape, period)

    monkeypatch.setattr(cell.arch.program, "checkpoint_leaves", faulty)
    mcfg = cell.arch.program.model_config(cell.config)
    with pytest.raises(ValueError, match="blocks.pos1.moe.shared"):
        harness.program_params(cell.arch, cell.config, mcfg, 5, "cpu")


def test_a_leaf_the_adapter_does_not_map_is_refused(cell, monkeypatch):
    def unmapped(path, slots):
        raise KeyError(path)

    _refused(cell, monkeypatch, unmapped)


def test_a_leaf_the_adapter_does_not_cover_is_refused(cell, monkeypatch):
    # the second super-block's layer (3) left out
    _refused(cell, monkeypatch, lambda path, slots: slots[:-1])


def test_a_new_architecture_runs_correct_and_fails_the_control(cell):
    run, checks, desc = bench_run.measure(
        cell, 2 ** 31 + 12345, 1e9, False, "cpu",
        rounds=cell.traffic["window_rounds"])
    out = bench_run.result(run, checks, desc, False)
    assert out["correct"] is True and out["attempted"] > 0, out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    # the per-layer readers that need no trace read the new architecture
    # through its own adapter, step_mfu by its FLOP formula
    for name in ("step_mfu", "step_ms", "tokens_per_step"):
        assert name in {m["name"] for m in cell.per_layer}
        v = bench_run.read_metric(name, run)
        assert v is not None and v > 0, name
    # routing is compared in the routing layers, 1 and 3, only
    assert checks["checks"]["routed_tokens"]["value"] > 0
    numbers = check.read_numbers(run, "cpu", control=True)
    ctl = check.judge(run, "cpu", control=True, numbers=numbers)
    assert ctl["ok"] is False, ctl["checks"]
