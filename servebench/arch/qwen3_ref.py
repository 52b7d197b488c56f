"""Qwen3 and Qwen3-MoE, the reference side: the leaf table and the float32
forward of the published Qwen3 decoder.

RMSNorm before attention and before the FFN, q/k RMSNorm per head before
rotary embeddings that rotate split halves, grouped-query causal
attention, a SwiGLU FFN or a sparse MoE block whose router takes a float32
softmax over every expert and renormalises the top k, a final RMSNorm and
an untied LM head. Every layer has the same kind: all route
(``num_experts``) or none does. Leaf names and orientation follow the
published checkpoints; the fp8 control covers q, k, v, o and the FFN's or
experts' three projections.
"""
from __future__ import annotations

from typing import Dict

import torch

from servebench import reference as R
from servebench import weights as W


def routes(cfg: dict) -> bool:
    """Whether the layers route (every one does, or none)."""
    return bool(cfg.get("num_experts"))


def leaves(cfg: dict, layer: int) -> Dict[str, W.LeafSpec]:
    """Leaf name -> (shape, kind, std) of decoder layer ``layer``, or of
    the model's own leaves for ``layer`` -1."""
    d = cfg["hidden_size"]
    if layer < 0:
        V = cfg["vocab_size"]
        return {"embed_tokens": ((V, d), "embed", 1.0),
                "norm": ((d,), "norm", 0.1),
                "lm_head": ((d, V), "matrix", d ** -0.5)}
    hd = cfg["head_dim"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    out = {
        "input_layernorm": ((d,), "norm", 0.1),
        "q_proj": ((d, q), "matrix", d ** -0.5),
        "k_proj": ((d, kv), "matrix", d ** -0.5),
        "v_proj": ((d, kv), "matrix", d ** -0.5),
        "o_proj": ((q, d), "matrix", q ** -0.5),
        "q_norm": ((hd,), "norm", 0.1),
        "k_norm": ((hd,), "norm", 0.1),
        "post_attention_layernorm": ((d,), "norm", 0.1),
    }
    if routes(cfg):
        E, de = cfg["num_experts"], cfg["moe_intermediate_size"]
        out.update({
            "router": ((d, E), "router", d ** -0.5),
            "experts.gate_proj": ((E, d, de), "matrix", d ** -0.5),
            "experts.up_proj": ((E, d, de), "matrix", d ** -0.5),
            "experts.down_proj": ((E, de, d), "matrix", de ** -0.5),
        })
    else:
        ff = cfg["intermediate_size"]
        out.update({
            "mlp.gate_proj": ((d, ff), "matrix", d ** -0.5),
            "mlp.up_proj": ((d, ff), "matrix", d ** -0.5),
            "mlp.down_proj": ((ff, d), "matrix", ff ** -0.5),
        })
    return out


def _attention(cfg, lp, x, fp8: bool):
    n = x.shape[0]
    hd, hq = cfg["head_dim"], cfg["num_attention_heads"]
    hkv = cfg["num_key_value_heads"]
    eps = cfg["rms_norm_eps"]
    q = R.lin(x, lp["q_proj"], fp8).view(n, hq, hd)
    k = R.lin(x, lp["k_proj"], fp8).view(n, hkv, hd)
    v = R.lin(x, lp["v_proj"], fp8).view(n, hkv, hd)
    q = R.rope(R.rms(q, lp["q_norm"], eps), cfg["rope_theta"])
    k = R.rope(R.rms(k, lp["k_norm"], eps), cfg["rope_theta"])
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)        # (hq, n, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = R.causal_attention(q.transpose(0, 1), k, v, hd ** -0.5)
    return R.lin(out.transpose(0, 1).reshape(n, hq * hd), lp["o_proj"], fp8)


def _moe(cfg, lp, x, fp8: bool):
    """The MoE block's output, and the experts each token's router chose."""
    probs = torch.softmax(x @ lp["router"], dim=-1)
    top, idx = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    top = top / top.sum(-1, keepdim=True)
    return R.routed_experts(x, idx, top, lp["experts.gate_proj"],
                            lp["experts.up_proj"], lp["experts.down_proj"],
                            fp8), idx


def embed(cfg: dict, seed: int, toks, device):
    emb = W.draw(seed, "embed_tokens", -1, leaves(cfg, -1)["embed_tokens"],
                 device)
    return [emb[t].float() for t in toks]


def layer(cfg: dict, lp: dict, xs, fp8: bool):
    eps = cfg["rms_norm_eps"]
    xs = [x + _attention(cfg, lp, R.rms(x, lp["input_layernorm"], eps), fp8)
          for x in xs]
    cat = torch.cat(xs)
    xn = R.rms(cat, lp["post_attention_layernorm"], eps)
    idx = None
    if routes(cfg):
        y, idx = _moe(cfg, lp, xn, fp8)
    else:
        y = R.swiglu(xn, lp["mlp.gate_proj"], lp["mlp.up_proj"],
                     lp["mlp.down_proj"], fp8)
    return list((cat + y).split([x.shape[0] for x in xs])), idx


def head(cfg: dict, seed: int, device):
    spec = leaves(cfg, -1)
    fn = W.draw(seed, "norm", -1, spec["norm"], device)
    lm = W.draw(seed, "lm_head", -1, spec["lm_head"], device).float()
    eps = cfg["rms_norm_eps"]
    return lambda h: R.rms(h, fn, eps) @ lm
