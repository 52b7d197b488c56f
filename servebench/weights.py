"""Weights from the seed, made by the benchmark and handed to both sides.

Every leaf of every layer is drawn from a ``torch.Generator`` of its own,
seeded by (seed, leaf name, layer), on the device that serves it, in one
call: the program's copy and the reference's, which draws a layer again
after the window, get the same values. Names and orientation follow the
published Qwen3 checkpoints (``x @ W``). Matrices are rounded to bfloat16,
the type they are served in; the router and the norms, which the port
keeps in float32, hold bfloat16-representable values as a checkpoint
would. Norm weights are ``1 + 0.1 * N(0, 1)``, so that the norms are not
identities; matrices are ``N(0, 1 / fan_in)``.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

# kind: "matrix" (bf16), "router" (f32 of bf16 values), "norm" (f32 of
# bf16 values around 1), "embed" (bf16, N(0, 1))
LeafSpec = Tuple[Tuple[int, ...], str, float]


def layer_leaves(cfg: dict) -> Dict[str, LeafSpec]:
    """Leaf name -> (shape, kind, std) of one decoder layer."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
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
    if cfg.get("num_experts"):
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


def model_leaves(cfg: dict) -> Dict[str, LeafSpec]:
    """The leaves outside the layers."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    return {"embed_tokens": ((V, d), "embed", 1.0),
            "norm": ((d,), "norm", 0.1),
            "lm_head": ((d, V), "matrix", d ** -0.5)}


def _leaf_seed(seed: int, name: str, layer: int) -> int:
    h = hashlib.sha256(f"{int(seed)}:{name}:{layer}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def draw(seed: int, name: str, layer: int, spec: LeafSpec,
         device) -> torch.Tensor:
    """One leaf of one layer (``layer`` -1 for the model's own leaves), in
    the type the port serves it in: bf16 matrices, f32 norms and router."""
    shape, kind, std = spec
    g = torch.Generator(device=device)
    g.manual_seed(_leaf_seed(seed, name, layer))
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    if kind == "norm":
        return (1.0 + std * x).to(torch.bfloat16).float()
    x = x.mul_(std).to(torch.bfloat16)
    return x.float() if kind == "router" else x
